"""Numerical-safety debugging."""

from __future__ import annotations

import torch


def enable_nan_debugging(enable: bool = True) -> None:
    """Make a NaN produced in a backward pass raise at once, with the
    forward op that made it in the trace
    (``torch.autograd.set_detect_anomaly``). Heavy: debug runs only."""
    torch.autograd.set_detect_anomaly(enable)
