"""Checkpoint / resume.

A ``CheckpointManager`` keeps rolling step checkpoints
``<directory>/step_<n>.pt`` of {model state_dict (the spectral-norm buffers
included), optimiser state_dict, extra} so that a killed run resumes exactly
(with the deterministic data cursor in data/loader.py). A checkpoint is
written under a temporary name and renamed, so the newest ``step_<n>.pt`` is
never torn; leftovers of a killed writer are ignored. ``save`` copies the
state to host memory at once and writes the file on a background thread;
``wait`` joins it.

In a multi-process run (``mesh``, core/mesh.py) the ranks hold the same
state: rank 0 alone writes, and every rank restores. ``wait`` ends with a
barrier and ``restore`` begins with one, so no rank reads a checkpoint that
rank 0 is still writing; every rank calls ``save``, ``wait`` and
``restore`` at the same points.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional, Tuple

import torch

from ..core.mesh import Mesh, barrier

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _to_host(obj: Any) -> Any:
    """A deep copy with every tensor detached on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.rank == 0
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_FILE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _write(self, step: int, payload: dict) -> None:
        try:
            tmp = self._path(step) + f".tmp{os.getpid()}"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
            for old in self.all_steps()[: -self.max_to_keep]:
                os.remove(self._path(old))
        except Exception as exc:  # raised by the next wait()
            self._error = exc

    def save(self, step: int, model_state: dict, opt_state: dict, extra: dict) -> None:
        """Snapshot the state on the host now; write it in the background.
        An earlier write still in flight is joined first. A rank other than
        0 writes nothing."""
        self.wait()
        if not self.is_writer:
            return
        payload = {
            "model": _to_host(model_state),
            "optimizer": _to_host(opt_state),
            "extra": dict(extra),
        }
        self._writer = threading.Thread(target=self._write, args=(step, payload))
        self._writer.start()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Tuple[dict, dict, dict]:
        """(model state_dict, optimiser state_dict, extra) of ``step``
        (default: the latest), tensors on the CPU."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        out = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return out["model"], out["optimizer"], out["extra"]

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self.mesh is not None:
            barrier(self.mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
