"""1-D convolutions with reference padding, and the fused conv bank.

The reference's conv bank runs Conv1d(C_in -> c_bank, k) for k = 1..8 and
concatenates. Here kernels are fused in groups: reflect padding of width p
satisfies x[-j] == x[j] whatever p is, so each small-kernel conv (with its
own asymmetric pad) equals a K_max-tap conv over one shared reflect-padded
input with the small kernel embedded at tap offset ``K_max//2 - k//2``.
The embedding is exact, so outputs do not depend on the grouping.

``compute_dtype`` (the training step's ``compute_dtype="bfloat16"``) casts
the padded input and the weight to that dtype for the product and keeps the
output in it; the bias is added in the output's dtype afterwards. These are
the JAX package's cast points, op for op: ``torch.autocast`` has a policy
of its own per op and would be a different function.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from .padding import conv_pad_amounts, reflect_pad_time


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """SAME-length 1-D conv: reflect pad first, then a strided valid conv.

    x: (B, C_in, T); w: (C_out, C_in, K); returns (B, C_out, ceil(T/stride)).
    """
    left, right = conv_pad_amounts(w.shape[-1])
    xp = reflect_pad_time(x, left, right)
    if compute_dtype is None:
        return F.conv1d(xp, w, b, stride=stride)
    out = F.conv1d(xp.to(compute_dtype), w.to(compute_dtype), stride=stride)
    return out if b is None else out + b.to(out.dtype)[:, None]


def dense(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x: (..., C_in), w: (C_out, C_in) -> (..., C_out)."""
    if compute_dtype is None:
        return F.linear(x, w, b)
    out = F.linear(x.to(compute_dtype), w.to(compute_dtype))
    return out if b is None else out + b.to(out.dtype)


def make_fused_bank_weight(
    bank_ws: Sequence[torch.Tensor], kernel_sizes: Sequence[int]
) -> torch.Tensor:
    """Embed per-kernel weights (c_bank, C_in, k_i) into one
    (n_k*c_bank, C_in, K_max) weight, kernel k at tap offset K_max//2 - k//2.
    Output channels are ordered [k_1-block | k_2-block | ...]."""
    k_max = max(kernel_sizes)
    blocks = []
    for w, k in zip(bank_ws, kernel_sizes):
        off = k_max // 2 - k // 2
        blocks.append(F.pad(w, (off, k_max - k - off)))
    return torch.cat(blocks, dim=0)


def conv_bank(
    x: torch.Tensor,
    bank_ws: Sequence[torch.Tensor],
    bank_bs: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int],
    act: Callable[[torch.Tensor], torch.Tensor],
    group_size: int = 2,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """act(conv_k(x)) for each k, concatenated with x on channels:
    (B, C_in, T) -> (B, n_k*c_bank + C_in, T). Kernel sizes are fused into
    one conv per group of ``group_size`` adjacent sizes (pairs, as the JAX
    package measured fastest on its TPU; not yet measured on the GPU)."""
    outs = []
    for g in range(0, len(kernel_sizes), group_size):
        g_ks = list(kernel_sizes[g : g + group_size])
        w = make_fused_bank_weight(bank_ws[g : g + group_size], g_ks)
        b = torch.cat(list(bank_bs[g : g + group_size]))
        left, right = conv_pad_amounts(max(g_ks))
        xp = reflect_pad_time(x, left, right)
        if compute_dtype is None:
            out = F.conv1d(xp, w, b)
        else:
            out = F.conv1d(xp.to(compute_dtype), w.to(compute_dtype))
            out = out + b.to(out.dtype)[:, None]
        outs.append(act(out))
    return torch.cat(outs + [x.to(outs[0].dtype)], dim=1)
