"""Double-buffered chunk streaming for corpora larger than the device budget.

- The packed mel array is cut into windows ("chunks") of exactly R rows. A
  chunk is a zero-copy view of the host packed array (the last one is padded
  to R rows once, at construction).
- Every chunk has the same shape, and its padded start list is bounded by a
  device scalar ``n_starts``, so one multi-step function serves every chunk
  (train/step.py ``padded_starts=True``).
- While the GPU trains the resident chunk, the next chunk crosses to the
  device on a side CUDA stream: compute and the host-to-device copy overlap.

Sampling semantics: chunks are visited in a seeded per-epoch permutation;
within a visit, segments are drawn uniformly from the chunk and the visit
length is proportional to the chunk's segment count: epoch-wise uniform over
segments at chunk granularity. Segments whose rows straddle a chunk edge are
excluded and counted (``dropped_segments``). The schedule is a pure function
of (seed, epoch, repeats), so resume from any global step replays the
identical chunk and segment sequence.

The stream keeps up with the steps iff the host-to-device link sustains

    BW_need = corpus_bytes / (repeats * epoch_steps * t_step)

``repeats`` trains that many times as many steps per visit and divides the
need linearly; ``choose_repeats`` picks it from a measured link rate and step
time. The planning is the JAX package's (``data/chunked.py``), value for
value; only the transfer is PyTorch's.

With a mesh (core/mesh.py) every rank follows the same schedule, and the
host-to-device copy is split over the ranks: R is rounded down to a multiple
of ``n_data``, each rank copies its ``R / n_data`` rows of the chunk, and
``DeviceChunk.acquire`` assembles the whole chunk on every rank's device
with one all-gather. Each rank's link carries ``1 / n_data`` of the bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.mesh import Mesh, all_gather_rows, shard_rows_for_process
from .dataset import SegmentDataset


@dataclass
class Visit:
    chunk_id: int
    it0: int  # global step at which this visit starts
    k: int  # number of steps in this visit


class DeviceChunk(NamedTuple):
    """One chunk on the device. ``ready`` is the copy's CUDA event (None on
    the CPU); ``host`` the pinned source, kept alive until the copy is done;
    ``mesh``, when the chunk's rows were copied by the ranks in parts
    (``packed`` then holds this rank's part). Call ``acquire`` on the thread
    and the stream that will use the chunk, before its first step: the
    all-gather of the parts is a collective, which every rank must issue in
    the same order as the training step's, from the main thread."""

    packed: torch.Tensor  # (R, n_mels) in the storage dtype: f32 or bf16
    starts: torch.Tensor  # (s_max,) int64, valid up to n_starts
    n_starts: torch.Tensor  # () int64
    ready: Optional["torch.cuda.Event"]
    host: Optional[torch.Tensor]
    mesh: Optional[Mesh] = None

    def acquire(self) -> "DeviceChunk":
        """Make the current stream wait for the copy, and mark the tensors as
        used by it so their memory is not reused while its work is queued;
        with a mesh, gather the ranks' parts into the whole chunk."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.packed.device)
            stream.wait_event(self.ready)
            for t in (self.packed, self.starts, self.n_starts):
                t.record_stream(stream)
        if self.mesh is None:
            return self
        return self._replace(packed=all_gather_rows(self.mesh, self.packed), mesh=None)


class ChunkedDeviceStreamer:
    def __init__(
        self,
        dataset: SegmentDataset,
        chunk_bytes: int,
        batch_size: int,
        inner_steps: int = 10,
        seed: int = 0,
        repeats: int = 1,
        device: Optional[torch.device] = None,
        mesh: Optional[Mesh] = None,
    ):
        """``device``: where ``put_chunk`` sends chunks (default: the CPU,
        where a chunk is wrapped as it is). ``mesh``: split each chunk's
        copy over the ranks (the module docstring)."""
        self.mesh = mesh
        self.repeats = max(int(repeats), 1)
        packed = dataset.packed
        seg = dataset.segment_size
        itemsize = packed.dtype.itemsize
        n_mels = packed.shape[1]
        total_rows = packed.shape[0]
        R = max(int(chunk_bytes // (n_mels * itemsize)), 4 * seg)
        R = min(R, total_rows)
        if mesh is not None:
            # each rank copies R / n_data rows: keep R a multiple of n_data
            R = max(R - (R % mesh.n_data), mesh.n_data)
        n_chunks = -(-total_rows // R)

        starts = np.sort(dataset.starts)
        chunk_starts: List[np.ndarray] = []
        for c in range(n_chunks):
            r0 = c * R
            lo = np.searchsorted(starts, r0, side="left")
            hi = np.searchsorted(starts, r0 + R - seg, side="right")
            chunk_starts.append((starts[lo:hi] - r0).astype(np.int32))
        dropped = len(starts) - sum(len(s) for s in chunk_starts)

        s_max = max((len(s) for s in chunk_starts), default=0)
        self.starts_padded = np.zeros((n_chunks, s_max), dtype=np.int32)
        self.n_starts = np.zeros(n_chunks, dtype=np.int64)
        for c, s in enumerate(chunk_starts):
            self.starts_padded[c, : len(s)] = s
            self.n_starts[c] = len(s)

        # the last chunk, padded to R rows once so that all chunks share a shape
        self._tail = None
        if total_rows % R:
            tail = np.zeros((R, n_mels), dtype=packed.dtype)
            tail[: total_rows - (n_chunks - 1) * R] = packed[(n_chunks - 1) * R :]
            self._tail = tail

        self.packed = packed
        self.R = R
        self.n_chunks = n_chunks
        self.last_h2d_rows = 0  # rows this rank's last put_chunk shipped
        self.segment_size = seg
        self.batch_size = batch_size
        self.inner_steps = inner_steps
        self.seed = seed
        self.dropped_segments = int(dropped)
        self.total_segments = int(self.n_starts.sum())
        # nominal steps per epoch: one pass over all usable segments
        self.epoch_steps = max(inner_steps, -(-self.total_segments // batch_size))
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._copy_stream = None

    # -- bandwidth adaptation -----------------------------------------------

    def chunk_nbytes(self) -> int:
        return self.R * self.packed.shape[1] * self.packed.dtype.itemsize

    def required_bandwidth(self, t_step_s: float, repeats: Optional[int] = None) -> float:
        """Host-to-device bytes/s the stream needs to keep up with steps of
        ``t_step_s`` (the module docstring's BW_need), with the padded
        per-chunk byte count (slightly conservative for a ragged tail)."""
        r = self.repeats if repeats is None else max(int(repeats), 1)
        corpus_bytes = self.n_chunks * self.chunk_nbytes()
        return corpus_bytes / (r * self.epoch_steps * t_step_s)

    def choose_repeats(
        self,
        t_step_s: float,
        bw_bytes_per_s: float,
        margin: float = 2.0,
        max_repeats: int = 16,
    ) -> int:
        """Smallest power-of-two ``repeats`` whose required bandwidth sits
        below ``bw / margin``: the least coarsening of the shuffle that keeps
        the stream ahead of the steps at the measured link rate."""
        r = 1
        while r < max_repeats and self.required_bandwidth(t_step_s, r) > bw_bytes_per_s / margin:
            r *= 2
        return r

    def set_repeats(self, repeats: int) -> None:
        """Apply a (possibly measured) ``repeats`` before ``schedule``: the
        visit plan depends on it, so a resumed run must set the same value."""
        self.repeats = max(int(repeats), 1)

    # -- host views and the transfer ------------------------------------------

    def chunk_view(self, chunk_id: int) -> np.ndarray:
        """Zero-copy (R, n_mels) window of the packed host array."""
        if self._tail is not None and chunk_id == self.n_chunks - 1:
            return self._tail
        return self.packed[chunk_id * self.R : (chunk_id + 1) * self.R]

    def put_chunk(self, chunk_id: int) -> DeviceChunk:
        """Start the chunk's transfer and return its device tensors at once.

        On a CUDA device the chunk is copied into pinned memory (torch's
        caching host allocator: after the first two chunks the pinned blocks
        are reused, so this is one host memcpy) and crosses with a
        non-blocking copy on a side stream; ``DeviceChunk.acquire`` makes the
        consumer's stream wait for it. The pinning is the call's blocking
        part (a 256 MB chunk is tens of ms of memcpy), so the solver calls
        ``put_chunk`` from a thread; registering the whole packed array with
        the driver instead would page-lock the entire corpus, which is this
        mode's reason to exist because it is too large. On the CPU the
        tensors wrap the host arrays. With a mesh only this rank's
        ``R / n_data`` rows cross here (``last_h2d_rows``), and ``acquire``
        gathers the rest."""
        view = self.chunk_view(chunk_id)
        if self.mesh is not None:
            part = self.R // self.mesh.n_data
            lo = shard_rows_for_process(self.mesh) * part
            view = view[lo : lo + part]
        self.last_h2d_rows = int(view.shape[0])
        packed = torch.from_numpy(view)
        if packed.dtype == torch.uint16:
            packed = packed.view(torch.bfloat16)  # bf16 storage's bit pattern
        starts = torch.from_numpy(self.starts_padded[chunk_id].astype(np.int64))
        n = torch.tensor(int(self.n_starts[chunk_id]), dtype=torch.int64)
        if self.device.type != "cuda":
            return DeviceChunk(packed, starts, n, None, None, self.mesh)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        host = packed.pin_memory()
        small = torch.cat([starts, n[None]]).pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            dev_small = small.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return DeviceChunk(dev, dev_small[:-1], dev_small[-1], ready, (host, small), self.mesh)

    # -- deterministic schedule ----------------------------------------------

    def _epoch_visits(self, epoch: int) -> List[Tuple[int, int]]:
        """[(chunk_id, k_steps)] for one epoch; a pure function of (seed, epoch)."""
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(self.n_chunks)
        inner = self.inner_steps
        ks = []
        for c in order:
            frac = self.n_starts[c] / max(self.total_segments, 1)
            k = int(round(self.epoch_steps * frac / inner)) * inner
            ks.append((int(c), max(k, inner) * self.repeats))
        return ks

    def schedule(self, start_step: int, n_steps: int) -> Iterator[Visit]:
        """Visits covering global steps [start_step, start_step + n_steps)."""
        it, epoch = 0, 0
        end = start_step + n_steps
        while it < end:
            for c, k in self._epoch_visits(epoch):
                if it + k <= start_step:
                    it += k
                    continue
                v0 = max(it, start_step)
                vk = min(it + k, end) - v0
                if vk > 0:
                    yield Visit(chunk_id=c, it0=v0, k=vk)
                it += k
                if it >= end:
                    return
            epoch += 1
