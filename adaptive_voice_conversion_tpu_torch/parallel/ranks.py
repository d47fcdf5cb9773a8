"""Ranks on this host: one process per rank, each in one process group.

``run_ranks`` starts ``world`` processes of this module, each running one
function of the port as one rank, and returns what each returned. The ranks
meet through a ``file://`` rendezvous in a temporary directory (no port can
race), and their collectives run on the loopback interface. The backend
follows ``init_multihost``: NCCL on GPUs, one rank per GPU; gloo on the CPU,
or on GPUs when the caller names it, where ranks may share a GPU
(``cuda:rank % device_count``) and stage their collectives through the host.

    python -m adaptive_voice_conversion_tpu_torch.parallel.ranks \
        <module:function> <rank> <world> <device> <backend> <init> <work_dir>

is one rank: it calls ``function(mesh_device, args)`` with the args the
caller saved, and saves the return value for the caller. A rank that fails
fails the run.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, List, Optional

import torch

PACKAGE_PARENT = Path(__file__).resolve().parents[2]


def rank_device(device: str, rank: int, backend: Optional[str]) -> str:
    """The device of one rank: the CPU, ``cuda:rank`` under NCCL, or under
    gloo ``cuda:rank % device_count`` (ranks share the host's GPUs)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    if backend == "gloo":
        return f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    return f"cuda:{rank}"


def run_ranks(
    fn: str, world: int, device: str, backend: Optional[str] = None, args: Any = None,
    timeout: float = 1800,
) -> List[Any]:
    """Run ``fn`` (``"package.module:function"``) on ``world`` ranks and
    return each rank's result, in rank order. Raises with the failing
    rank's output if any rank fails or outlives ``timeout`` seconds; no
    process is left running."""
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        torch.save(args, work / "args.pt")
        init = f"file://{work / 'rendezvous'}"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(PACKAGE_PARENT), env.get("PYTHONPATH")) if p)
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", __name__, fn, str(r), str(world), device, backend or "",
                 init, str(work)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(world)
        ]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"{fn}: rank {r} of {world} exited {p.returncode}:\n{log[-4000:]}")
        return [torch.load(work / f"out_{r}.pt", weights_only=False) for r in range(world)]


def main(argv) -> None:
    from ..core.mesh import init_multihost

    fn, rank, world, device, backend, init, work = argv
    rank, world, backend = int(rank), int(world), backend or None
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = rank_device(device, rank, backend)
    init_multihost(device=dev, backend=backend, init_method=init, world_size=world, rank=rank)
    try:
        module, name = fn.split(":")
        args = torch.load(Path(work) / "args.pt", weights_only=False)
        out = getattr(importlib.import_module(module), name)(torch.device(dev), args)
        torch.save(out, Path(work) / f"out_{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
