"""A corpus sharded over the data axis: each rank holds a disjoint shard of
utterances on its own GPU and draws its share of every batch from it.

This lifts the device-resident ceiling from one GPU's memory to the sum
over the ranks. Sampling stays uniform over segments: the shards are
balanced to equal segment counts (greedy longest-first over the
per-utterance counts, then cut to the smallest shard's count; the dropped
remainder is reported in ``dropped_segments``), and every rank draws an
equal share of the batch uniformly from its own starts, so every segment
that is kept has the same probability.

The plan is a pure function of the dataset, the JAX package's
``plan_shards`` value for value, so every rank computes the same plan and
builds and uploads only its own shard: ``packed`` (R, n_mels) with the
utterances of the shard packed from row 0 and zeros after them, R the
largest shard's row count, and ``starts`` (S,), the shard's segment starts
in its own rows, S the smallest shard's segment count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.mesh import Mesh, local_batch_size, shard_rows_for_process
from .dataset import SegmentDataset, from_bf16_bits, to_bf16_bits
from .device_sampler import draw_indices, gather_rows


@dataclass
class ShardPlan:
    """Host-side partition of a SegmentDataset into n_shards balanced shards."""

    utt_rows: List[np.ndarray]  # per shard: the utterance indices it holds
    n_rows: int  # common padded row count R
    n_starts: int  # common truncated start count S
    dropped_segments: int


def plan_shards(dataset: SegmentDataset, n_shards: int) -> ShardPlan:
    """Greedy longest-first partition of utterances, balancing segment
    counts."""
    offsets = dataset._offsets
    n_utt = len(dataset.utt_ids)
    utt_of_start = np.searchsorted(offsets, dataset.starts, side="right") - 1
    seg_counts = np.bincount(utt_of_start, minlength=n_utt)

    order = np.argsort(seg_counts)[::-1]  # largest first
    shard_load = np.zeros(n_shards, dtype=np.int64)
    shard_rows = np.zeros(n_shards, dtype=np.int64)
    assign = np.empty(n_utt, dtype=np.int64)
    lengths = np.diff(offsets)
    for u in order:
        s = int(np.argmin(shard_load))
        assign[u] = s
        shard_load[s] += seg_counts[u]
        shard_rows[s] += lengths[u]

    n_starts = int(shard_load.min())
    if n_starts == 0:
        raise ValueError(
            f"cannot shard {n_utt} utterances / {len(dataset.starts)} segments "
            f"over {n_shards} ranks: a shard would be empty; use the "
            "replicated device path (input_mode='device') for tiny datasets"
        )
    dropped = int(shard_load.sum() - n_starts * n_shards)
    return ShardPlan(
        utt_rows=[np.flatnonzero(assign == s) for s in range(n_shards)],
        n_rows=int(shard_rows.max()),
        n_starts=n_starts,
        dropped_segments=dropped,
    )


def shard_arrays(dataset: SegmentDataset, plan: ShardPlan, shard: int, dtype: str):
    """Shard ``shard``'s host arrays: ``packed`` (R, n_mels), float32 or the
    bf16 bit pattern in uint16 by ``dtype``, and ``starts`` (S,) int64."""
    offsets = dataset._offsets
    utts = plan.utt_rows[shard]
    packed = np.zeros((plan.n_rows, dataset.n_mels), dtype=dataset.packed.dtype)
    local_base = {}
    row = 0
    for u in utts:
        r0, r1 = int(offsets[u]), int(offsets[u + 1])
        packed[row : row + (r1 - r0)] = dataset.packed[r0:r1]
        local_base[u] = row - r0  # global row -> local row shift
        row += r1 - r0
    utt_of_start = np.searchsorted(offsets, dataset.starts, side="right") - 1
    mask = np.isin(utt_of_start, utts)
    shift = np.array([local_base[u] for u in utt_of_start[mask]], dtype=np.int64)
    starts = (dataset.starts[mask] + shift)[: plan.n_starts]
    bf16_storage = packed.dtype == np.uint16
    if dtype == "bfloat16":
        wire = packed if bf16_storage else to_bf16_bits(packed)
    elif dtype == "float32":
        wire = from_bf16_bits(packed) if bf16_storage else packed.astype(np.float32, copy=False)
    else:
        raise ValueError(f"dtype={dtype!r}: expected 'bfloat16' or 'float32'")
    return wire, starts.astype(np.int64)


class ShardedDeviceDataset:
    """This rank's shard of the corpus on ``device``; ``dtype="bfloat16"``
    crosses as its uint16 bit pattern and is viewed as ``torch.bfloat16``
    there, as in ``DeviceResidentDataset``."""

    def __init__(
        self,
        dataset: SegmentDataset,
        mesh: Mesh,
        device: torch.device,
        dtype: str = "bfloat16",
    ):
        self.n_shards = mesh.n_data
        self.shard = shard_rows_for_process(mesh)
        plan = plan_shards(dataset, self.n_shards)
        wire, starts = shard_arrays(dataset, plan, self.shard, dtype)
        host = torch.from_numpy(wire)
        self.packed = (host.view(torch.bfloat16) if dtype == "bfloat16" else host).to(device)
        self.starts = torch.from_numpy(starts).to(device)
        self.segment_size = dataset.segment_size
        self.n_mels = dataset.n_mels
        self.dropped_segments = plan.dropped_segments

    @property
    def nbytes(self) -> int:
        return self.packed.numel() * self.packed.element_size()


def shard_seed(seed: int, iteration: int, shard: int) -> int:
    """The seed of one shard's position draw at one step: ``step_seed``'s
    sequence (train/step.py) with the shard as its spawn key, the
    counterpart of the JAX package's ``fold_in(key, shard)``, so every shard
    draws its own positions and none shares the step generator's bits."""
    ss = np.random.SeedSequence([seed + 1, iteration], spawn_key=(shard,))
    return int(ss.generate_state(1, np.uint64)[0])


def sample_segments_sharded(
    packed: torch.Tensor,
    starts: torch.Tensor,
    segment_size: int,
    batch_size: int,
    seed: int,
    iteration: int,
    mesh: Mesh,
) -> torch.Tensor:
    """This rank's ``batch_size / n_data`` segments (b_local, seg, n_mels),
    drawn uniformly from its shard's starts with a generator on the shard's
    device seeded ``shard_seed(seed, iteration, shard)``. Concatenated in
    data-index order, the ranks' draws are the global batch; the VAE's
    ``eps`` and the dropout masks are not drawn here but from the step's
    own generator, at the global shape."""
    b_local = local_batch_size(batch_size, mesh)
    shard = shard_rows_for_process(mesh)
    gen = torch.Generator(device=packed.device)
    gen.manual_seed(shard_seed(seed, iteration, shard))
    sel = draw_indices(starts.shape[0], b_local, gen)
    return gather_rows(packed, starts, sel, segment_size)
