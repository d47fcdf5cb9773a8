"""Tracing hooks: a ``torch.profiler`` trace of a code region
(``profile_trace``) and a blocking wall-clock timer (``step_timer``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a host and (where there is one) device trace of the
    enclosed region into ``logdir`` as a Chrome trace, viewable in
    Perfetto or chrome://tracing:

        with profile_trace("prof/"):
            for _ in range(20):
                metrics = step(x, lam)
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def step_timer(label: str, result_holder: Optional[dict] = None) -> Iterator[None]:
    """Blocking wall-clock timer of the enclosed region: on exit it waits for
    the current CUDA device's queued work (nothing more on a host without
    one), then stores the seconds under ``label`` in ``result_holder`` or
    prints them."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if result_holder is not None:
            result_holder[label] = dt
        else:
            print(f"[{label}] {dt * 1000:.2f} ms")
