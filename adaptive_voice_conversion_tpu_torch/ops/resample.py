"""Time-axis resampling on (B, C, T): pixel shuffle, nearest upsample,
ceil-mode average pooling, global average pooling."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_shuffle_time(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, C*r, T) -> (B, C, T*r): channel ``c*r + phase`` feeds time
    ``t*r + phase`` of channel ``c`` (the reference's pixel_shuffle_1d)."""
    if scale == 1:
        return x
    b, cr, t = x.shape
    c = cr // scale
    return x.reshape(b, c, scale, t).permute(0, 1, 3, 2).reshape(b, c, t * scale)


def upsample_nearest_time(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, T*r), each frame repeated r times."""
    if scale == 1:
        return x
    return x.repeat_interleave(scale, dim=-1)


def avg_pool_time_ceil(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """avg_pool1d(kernel, stride=kernel, ceil_mode=True): a trailing partial
    window is averaged over its true element count."""
    if kernel == 1:
        return x
    return F.avg_pool1d(x, kernel_size=kernel, ceil_mode=True)


def global_avg_pool_time(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool1d(1) + squeeze: (B, C, T) -> (B, C)."""
    return x.mean(dim=-1)
