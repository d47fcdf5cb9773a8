"""Time-axis padding with the reference's even-kernel asymmetry.

Every conv input is reflect-padded; even kernels pad ``(k//2, k//2 - 1)``,
odd kernels ``(k//2, k//2)``. Activations are (B, C, T), so padding applies
to the last axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def conv_pad_amounts(kernel_size: int) -> Tuple[int, int]:
    """'SAME'-length pad amounts with the reference's even-kernel asymmetry."""
    if kernel_size % 2 == 0:
        return kernel_size // 2, kernel_size // 2 - 1
    return kernel_size // 2, kernel_size // 2


def reflect_pad_time(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the time (last) axis; the edge sample is not repeated."""
    if left == 0 and right == 0:
        return x
    return F.pad(x, (left, right), mode="reflect")
