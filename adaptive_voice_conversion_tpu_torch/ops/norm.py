"""Instance normalization and AdaIN for (B, C, T) activations.

``instance_norm_time`` is ``nn.InstanceNorm1d(affine=False)``: per-sample,
per-channel statistics over time, biased variance, eps 1e-5. ``adain`` is
the reference's ``append_cond``: a per-channel affine whose (mean, std) come
from a Linear projection of the speaker embedding, split in half.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def instance_norm_time(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean_T) / sqrt(var_T + eps), statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def adain(x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """x (B, C, T), cond (B, 2C) -> x * std + mean, with cond[:, :C] the
    mean and cond[:, C:] the std."""
    c = x.shape[1]
    mean = cond[:, :c, None]
    std = cond[:, c:, None]
    return x * std.to(x.dtype) + mean.to(x.dtype)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """'relu' or 'lrelu' (slope 0.01)."""
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.01)
    return F.relu
