"""Batch iteration with deterministic resume, and the device prefetch.

A seeded, stateless-resumable epoch permutation: batch ``step`` is a pure
function of (seed, step), so a restarted job continues exactly where it
left off. ``host_index`` / ``host_count`` give each process of a
multi-process run a disjoint slice of every global batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .dataset import SegmentDataset, make_frames


def _epoch_perm(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n)


def batch_iterator(
    dataset: SegmentDataset,
    batch_size: int,
    *,
    frame_size: int = 1,
    shuffle: bool = True,
    seed: int = 0,
    start_step: int = 0,
    host_index: int = 0,
    host_count: int = 1,
) -> Iterator[np.ndarray]:
    """Yield (local_batch, T/frame, frame*n_mels) batches forever.

    ``batch_size`` is the global batch; each host yields its
    ``batch_size // host_count`` slice. Resume by passing the step counter.
    """
    if batch_size % host_count:
        raise ValueError("global batch not divisible by host count")
    local = batch_size // host_count
    lo, hi = host_index * local, (host_index + 1) * local
    n = len(dataset)
    per_epoch = n // batch_size
    if per_epoch == 0:
        raise ValueError("dataset smaller than one batch")
    step = start_step
    while True:
        epoch, pos = divmod(step, per_epoch)
        perm = _epoch_perm(n, seed, epoch, shuffle)
        while pos < per_epoch:
            idx = perm[pos * batch_size : (pos + 1) * batch_size][lo:hi]
            yield make_frames(dataset.gather(idx), frame_size)
            pos += 1
            step += 1


def device_prefetch(
    it: Iterator[np.ndarray], device: torch.device, depth: int = 2
) -> Iterator[torch.Tensor]:
    """Run the host gather in a thread and copy batches to ``device`` ahead
    of consumption, so the host data path overlaps the training steps.

    On a CUDA device a batch goes into pinned host memory and crosses on a
    side stream with a non-blocking copy; the consumer's stream waits on
    the copy's event (no ``synchronize()``), and the tensor is marked as
    used by that stream so its memory is not reused early. On the CPU the
    batches are wrapped as they are.
    """
    cuda = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def put(batch: np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if not cuda:
            return host, None
        host = host.pin_memory()
        with torch.cuda.stream(copy_stream):
            dev = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        # the pinned source must outlive the copy: it travels with the item
        return dev, (done, host)

    def offer(item) -> bool:
        # a bounded wait, so that a producer whose consumer has gone ends
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not offer(put(item)):
                    return
        except Exception as exc:  # surfaced in the consumer
            offer(exc)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            dev, pending = item
            if pending is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(pending[0])
                dev.record_stream(current)
            yield dev
    finally:
        stop.set()
