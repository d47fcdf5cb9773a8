"""Tracing hook: a ``torch.profiler`` trace of a code region."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

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
