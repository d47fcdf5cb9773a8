"""1-D convolutions with reference padding, and the fused conv bank.

The reference's conv bank runs Conv1d(C_in -> c_bank, k) for k = 1..8 and
concatenates. Here kernels are fused in groups: reflect padding of width p
satisfies x[-j] == x[j] whatever p is, so each small-kernel conv (with its
own asymmetric pad) equals a K_max-tap conv over one shared reflect-padded
input with the small kernel embedded at tap offset ``K_max//2 - k//2``.
The embedding is exact, so outputs do not depend on the grouping.

``conv_bank_in`` and ``dual_conv_bank`` are the JAX package's two
recorded experiments on the bank (ops/conv.py:163-292 there), on no
production path: the encoders run ``conv_bank`` then the 1x1 ``conv1d``.

``compute_dtype`` (the training step's ``compute_dtype="bfloat16"``) casts
the padded input and the weight to that dtype for the product and keeps the
output in it; the bias is added in the output's dtype afterwards. These are
the JAX package's cast points, op for op: ``torch.autocast`` has a policy
of its own per op and would be a different function.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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
    package measured fastest on its TPU; for the H100 see
    tools/perf_probes.py ``probe_bank`` and PERF.md)."""
    outs = [act(o) for o in _bank_groups(x, bank_ws, bank_bs, kernel_sizes, group_size, compute_dtype)]
    return torch.cat(outs + [x.to(outs[0].dtype)], dim=1)


def _bank_groups(x, bank_ws, bank_bs, kernel_sizes, group_size, compute_dtype):
    """Each group's fused conv of x, bias added, before the activation."""
    for g in range(0, len(kernel_sizes), group_size):
        w = make_fused_bank_weight(bank_ws[g : g + group_size], kernel_sizes[g : g + group_size])
        yield conv1d(x, w, torch.cat(list(bank_bs[g : g + group_size])), compute_dtype=compute_dtype)


def conv_bank_in(
    x: torch.Tensor,
    bank_ws: Sequence[torch.Tensor],
    bank_bs: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int],
    act: Callable[[torch.Tensor], torch.Tensor],
    w_in: torch.Tensor,
    b_in: Optional[torch.Tensor],
    group_size: int = 2,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The bank and the encoders' 1x1 in-conv over its concat, without
    the concat: ``conv1d(conv_bank(x, ...), w_in, b_in)`` before the
    activation, (B, C_in, T) -> (B, C_out, T).

    A 1x1 conv over a concatenation is the sum of each block's 1x1 conv
    with its rows of the weight, so the (B, n_k*c_bank + C_in, T) tensor
    never exists; the same function as the concat path, summed in another
    order. ``w_in`` is (C_out, n_k*c_bank + C_in, 1) or without its tap
    axis. The JAX package's recorded experiment (ops/conv.py:163-226
    there): faster in isolation, slower in the whole training step, so no
    production path takes it; the port keeps it with its test and times it
    in tools/perf_probes.py ``probe_bank_split``."""
    w_in = w_in if w_in.dim() == 3 else w_in[..., None]
    dt = torch.float32 if compute_dtype is None else compute_dtype
    acc = None
    c_off = 0
    for out in _bank_groups(x, bank_ws, bank_bs, kernel_sizes, group_size, compute_dtype):
        out = act(out)
        n = out.shape[1]
        term = F.conv1d(out, w_in[:, c_off : c_off + n].to(out.dtype))
        acc = term if acc is None else acc + term
        c_off += n
    acc = acc + F.conv1d(x.to(dt), w_in[:, c_off:].to(dt))
    return acc if b_in is None else acc + b_in.to(acc.dtype)[:, None]


def dual_conv_bank(
    x: torch.Tensor,
    banks,
    kernel_sizes: Sequence[int],
    acts,
    group_size: int = 2,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two conv banks over the same x as one set of fused convs: each
    group's weights of bank a and bank b are concatenated on the output
    channels, so the two banks share the padding and the reads of x.

    ``banks`` is ((ws_a, bs_a), (ws_b, bs_b)), both with ``kernel_sizes``
    and one output width a kernel; ``acts`` the pair of activations,
    applied after the split. Returns (out_a, out_b), each what
    ``conv_bank`` returns for its bank (the training forward feeds both
    encoders the same batch; the encoders take these as ``bank_out``).
    The JAX package's recorded experiment (ops/conv.py:229-292 there):
    faster in isolation, slower in the whole training step, so no
    production path takes it."""
    (ws_a, bs_a), (ws_b, bs_b) = banks
    act_a, act_b = acts
    outs_a, outs_b = [], []
    for g in range(0, len(kernel_sizes), group_size):
        g_ks = kernel_sizes[g : g + group_size]
        w_a = make_fused_bank_weight(ws_a[g : g + group_size], g_ks)
        w_b = make_fused_bank_weight(ws_b[g : g + group_size], g_ks)
        b = torch.cat(list(bs_a[g : g + group_size]) + list(bs_b[g : g + group_size]))
        out = conv1d(x, torch.cat([w_a, w_b]), b, compute_dtype=compute_dtype)
        outs_a.append(act_a(out[:, : w_a.shape[0]]))
        outs_b.append(act_b(out[:, w_a.shape[0] :]))
    xc = x.to(outs_a[0].dtype)
    return torch.cat(outs_a + [xc], dim=1), torch.cat(outs_b + [xc], dim=1)
