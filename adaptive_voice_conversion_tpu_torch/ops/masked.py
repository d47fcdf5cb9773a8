"""Length-masked variants of the model ops, for ragged-batch serving.

A conversion grid batches utterances of different lengths into one padded
(B, C, T) tensor. Zero padding is not neutral for this model: reflect-pad
convolutions read the pad region near each sample's true end, instance-norm
statistics average over every frame, and the speaker encoder's global
average pool divides by the padded length.

These ops take a per-sample ``lengths`` (B,) integer tensor on the input's
device and compute, for every sample, what the unmasked op computes on that
sample alone at its true length. Positions at or beyond a sample's length
may hold garbage between ops; every op here either never reads them (the
reflect pad gathers only valid frames) or leaves them out of its
reductions, so garbage never reaches a valid output.

Used by models/masked.py (inference only).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .conv import make_fused_bank_weight
from .padding import conv_pad_amounts


def valid_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths -> (B, t) float32 mask of valid positions."""
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).float()


def ceil_lengths(lengths: torch.Tensor, stride: int) -> torch.Tensor:
    """Valid length after a SAME-padded strided conv: ceil(L / stride)."""
    return -(-lengths // stride)


def reflect_pad_time_masked(
    x: torch.Tensor, lengths: torch.Tensor, left: int, right: int
) -> torch.Tensor:
    """Per-sample reflect pad of (B, C, T) around [0, L_b), torch-style
    (edge sample not repeated). Output (B, C, left + T + right); positions
    past L_b + right are clamped garbage (finite, never read downstream).

    The right reflect is applied after the left |pos| fold, and the clamp
    last, so a sample shorter than the pad width still resolves every index
    into its own [0, L_b): its reads never land in another layer's garbage.
    Such ultra-short samples have no single-sample behaviour to match
    (F.pad(mode="reflect") raises when pad >= length); samples of normal
    length are bit-identical to the per-sample pad.
    """
    b, c, t = x.shape
    pos = torch.arange(-left, t + right, device=x.device)[None, :]  # (1, P)
    l = lengths[:, None]
    idx = pos.abs()  # left reflect: -j -> j, the same for every sample
    idx = torch.where(idx >= l, 2 * l - 2 - idx, idx)  # right reflect at L_b
    idx = idx.clamp(0, t - 1)
    return torch.gather(x, 2, idx[:, None, :].expand(b, c, -1))


def conv1d_masked(
    x: torch.Tensor,
    lengths: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ops.conv.conv1d with per-sample reflect padding.

    Returns (out, out_lengths): out (B, C_out, ceil(T/stride)); sample b's
    first ceil(L_b/stride) frames equal conv1d on that sample alone.
    """
    left, right = conv_pad_amounts(w.shape[-1])
    xp = x if left == 0 and right == 0 else reflect_pad_time_masked(x, lengths, left, right)
    return F.conv1d(xp, w, b, stride=stride), ceil_lengths(lengths, stride)


def conv_bank_masked(
    x: torch.Tensor,
    lengths: torch.Tensor,
    bank_ws: Sequence[torch.Tensor],
    bank_bs: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int],
    act: Callable[[torch.Tensor], torch.Tensor],
    group_size: int = 2,
) -> torch.Tensor:
    """ops.conv.conv_bank with per-sample reflect padding (the same pair
    grouping: the tap-offset embedding is exact for any reflect extension,
    so each sample matches conv_bank on it alone at its true length)."""
    outs = []
    for g in range(0, len(kernel_sizes), group_size):
        g_ks = list(kernel_sizes[g : g + group_size])
        w = make_fused_bank_weight(bank_ws[g : g + group_size], g_ks)
        b = torch.cat(list(bank_bs[g : g + group_size]))
        left, right = conv_pad_amounts(max(g_ks))
        xp = reflect_pad_time_masked(x, lengths, left, right)
        outs.append(act(F.conv1d(xp, w, b)))
    return torch.cat(outs + [x], dim=1)


def instance_norm_time_masked(
    x: torch.Tensor, lengths: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """ops.norm.instance_norm_time with statistics over valid frames only
    (InstanceNorm1d on each sample at its true length)."""
    xf = x.float()
    m = valid_mask(lengths, x.shape[-1])[:, None, :]
    n = lengths.float()[:, None, None]
    mean = (xf * m).sum(dim=-1, keepdim=True) / n
    var = ((xf - mean).square() * m).sum(dim=-1, keepdim=True) / n
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def avg_pool_time_ceil_masked(
    x: torch.Tensor, lengths: torch.Tensor, kernel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ops.resample.avg_pool_time_ceil with per-sample divisors: window o of
    sample b averages over min(kernel, L_b - o*kernel) valid elements
    (ceil_mode at the sample's true length)."""
    if kernel == 1:
        return x, lengths
    b, c, t = x.shape
    t_out = -(-t // kernel)
    xm = F.pad(x * valid_mask(lengths, t)[:, None, :].to(x.dtype), (0, t_out * kernel - t))
    summed = xm.reshape(b, c, t_out, kernel).sum(dim=-1)
    starts = kernel * torch.arange(t_out, device=x.device)[None, :]
    counts = (lengths[:, None] - starts).clamp(1, kernel).to(x.dtype)
    return summed / counts[:, None, :], ceil_lengths(lengths, kernel)


def global_avg_pool_time_masked(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """ops.resample.global_avg_pool_time over valid frames: (B, C, T) -> (B, C)."""
    m = valid_mask(lengths, x.shape[-1])[:, None, :].to(x.dtype)
    return (x * m).sum(dim=-1) / lengths.to(x.dtype)[:, None]
