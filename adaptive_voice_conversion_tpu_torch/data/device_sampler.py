"""Device-resident dataset: segment sampling on the GPU itself.

When the packed mel array fits the device's data budget it is copied to the
device once, and segment batches are drawn and gathered there inside the
multi-step trainer (train/step.py ``make_device_data_train_step``): per-step
host traffic is zero and no step waits on the host.

Sampling semantics are the reference index pipeline's: a uniform draw over
the precomputed (utt, t) index entries, i.e. over the segment start rows.

In a data-parallel run every rank holds the whole corpus on its own GPU,
draws the global batch's positions and gathers its own rows of it
(``sample_segments(mesh=...)``); data/sharded.py splits the corpus instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.mesh import Mesh, local_batch_size, row_window
from .dataset import SegmentDataset, to_bf16_bits


class DeviceResidentDataset:
    """The packed array and the segment starts on ``device``.

    ``dtype="bfloat16"``: bf16 storage crosses as its uint16 bit pattern and
    is viewed as ``torch.bfloat16`` on the device; f32 storage is first
    rounded to nearest even (``to_bf16_bits``), so this mode trains against a
    bf16-rounded target where the host stream of the same f32 corpus does
    not, as in the JAX package. ``dtype="float32"`` keeps f32.
    """

    def __init__(self, dataset: SegmentDataset, device: torch.device, dtype: str = "bfloat16"):
        packed = dataset.packed
        if dtype == "bfloat16":
            wire = packed if packed.dtype == np.uint16 else to_bf16_bits(packed)
        elif dtype == "float32":
            wire = np.ascontiguousarray(packed, dtype=np.float32)
        else:
            raise ValueError(f"dtype={dtype!r}: expected 'bfloat16' or 'float32'")
        host = torch.from_numpy(wire)
        self.packed = (host.view(torch.bfloat16) if dtype == "bfloat16" else host).to(device)
        self.starts = torch.from_numpy(dataset.starts.astype(np.int64)).to(device)
        self.segment_size = dataset.segment_size
        self.n_mels = dataset.n_mels

    @property
    def nbytes(self) -> int:
        return self.packed.numel() * self.packed.element_size()


def draw_indices(
    n: int,
    batch_size: int,
    generator: torch.Generator,
    n_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(batch_size,) int64 positions drawn uniformly from ``[0, n_valid)``
    (``[0, n)`` without it) on the generator's device.

    ``n_valid`` is a device tensor, so bounding the draw to the valid prefix
    of a padded start list (data/chunked.py) needs no host sync: the draw is
    a 62-bit integer taken modulo the bound (bias below n / 2**62)."""
    r = torch.randint(
        0, 2**62, (batch_size,), generator=generator,
        device=generator.device, dtype=torch.int64,
    )
    return torch.remainder(r, n if n_valid is None else n_valid)


def gather_rows(
    packed: torch.Tensor, starts: torch.Tensor, sel: torch.Tensor, segment_size: int
) -> torch.Tensor:
    """``packed[starts[sel][:, None] + arange(segment_size)]``: the segment
    batch (len(sel), segment_size, n_mels), gathered where ``packed`` lives."""
    s = starts[sel]
    idx = s[:, None] + torch.arange(segment_size, device=s.device)[None, :]
    return packed[idx]


def sample_segments(
    packed: torch.Tensor,
    starts: torch.Tensor,
    segment_size: int,
    batch_size: int,
    generator: torch.Generator,
    n_valid: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """A uniform segment batch (batch_size, segment_size, n_mels).

    With ``mesh`` (every rank holding the whole corpus) all ``batch_size``
    positions are drawn, as one process draws them, and only this rank's
    rows of the batch are gathered: (batch_size / n_data, segment_size,
    n_mels)."""
    sel = draw_indices(starts.shape[0], batch_size, generator, n_valid)
    if mesh is not None:
        lo, hi, _ = row_window(mesh, local_batch_size(batch_size, mesh))
        sel = sel[lo:hi]
    return gather_rows(packed, starts, sel, segment_size)
