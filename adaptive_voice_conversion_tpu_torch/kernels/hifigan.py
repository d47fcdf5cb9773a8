"""The HiFi-GAN generator's junctions: the CUDA kernel's wrapper and its
plain version.

A junction is the elementwise work between two of the generator's
convolutions (models/hifigan.py): the length mask, the LeakyReLU, the
residual sum and the stage's mean over its residual blocks. The kernel
(csrc/hifigan_junction.cu) does a junction in one pass; it replaces no TPU
kernel, since the JAX package has no HiFi-GAN. Every junction takes the
convolution's output ``c`` (B, C, T) f32 without its bias, the bias
``bias`` (C,), the rows' ``lengths`` ((B,) int64 frames, or None: nothing
masked) and the stage's ``scale`` (samples a frame there), so that the mask
is m = (t < lengths[b] * scale) and c stands below for c + bias, which
PyTorch would have added to cuDNN's output in a pass of its own:

- ``J0``, after a transposed convolution: x = m*c in place, and a new
  a = lrelu(x), which the stage's blocks share; returns (x, a).
- ``J1``, after a ``convs1`` (or ``input_conv``): c = lrelu(m*c) in place;
  returns c.
- ``J2``, after a ``convs2`` but a block's last: x' = m*c + x in c's
  buffer, and a new a' = lrelu(x'); returns (x', a'). ``x`` is not written.
- ``J3``, after block ``block``'s last ``convs2``: y = m*c + x folded into
  the stage's sum ``total`` (None for the first block): y, total + y, or at
  the last block lrelu((total + y) / n_blocks) with the next layer's slope;
  returns the sum, or that.

``junction`` is the wrapper: on a CPU tensor it runs ``junction_plain``,
the eager PyTorch sequence the generator ran before the kernel; on a CUDA
tensor it launches the kernel or raises. ``junction.launches`` counts its
kernel launches. ``junction_bytes`` is what one launch moves in device
memory, the kernel's bound over the card's bandwidth.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import load_library

J0, J1, J2, J3 = "J0", "J1", "J2", "J3"
# the kernel's flag bits (hj_flags in csrc/hifigan_junction.cu)
RES, ACC, SCALE, STORE_V, STORE_A = 1, 2, 4, 8, 16


def length_mask(lengths: Optional[torch.Tensor], t: int, scale: int, dtype) -> Optional[torch.Tensor]:
    """(B, 1, t) of 1.0 where the step is inside its row's ``lengths`` x
    ``scale``, 0.0 past it; None without ``lengths``."""
    if lengths is None:
        return None
    steps = torch.arange(t, device=lengths.device)
    return (steps[None, :] < (lengths * scale)[:, None]).to(dtype)[:, None, :]


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x times ``mask`` in place (None: x as it is)."""
    return x if mask is None else x.mul_(mask)


def junction_plain(mode, c, bias, lengths, scale, slope, x=None, total=None, block=0, n_blocks=1):
    """``junction`` in eager PyTorch ops, on the tensors' device: the
    convolution's bias added as ``nn.Conv1d`` adds it to cuDNN's output, then
    the generator's sequence before the kernel, in its order. It divides by
    ``n_blocks`` with ``div_``, as that sequence did: a true division on the
    CPU, a multiply by the f32 reciprocal on the card."""
    c = c.add_(bias.view(1, -1, 1))
    mask = length_mask(lengths, c.shape[-1], scale, c.dtype)
    if mode == J1:
        return F.leaky_relu(apply_mask(c, mask), slope, inplace=True)
    if mode == J0:
        x = apply_mask(c, mask)
        return x, F.leaky_relu(x, slope)
    y = apply_mask(c, mask).add_(x)
    if mode == J2:
        return y, F.leaky_relu(y, slope)
    total = y if block == 0 else total.add_(y)
    if block == n_blocks - 1:
        total = F.leaky_relu(total.div_(n_blocks), slope, inplace=True)
    return total


def junction_flags(mode: str, block: int = 0, n_blocks: int = 1) -> int:
    """The kernel's flag set for a junction: what it reads besides ``c`` and
    the bias (RES: x, ACC: total), whether it takes the mean (SCALE), and
    what it stores (STORE_V: the sum, STORE_A: its LeakyReLU)."""
    if mode == J0:
        return STORE_V | STORE_A
    if mode == J1:
        return STORE_A
    if mode == J2:
        return RES | STORE_V | STORE_A
    if mode != J3 or not 0 <= block < n_blocks:
        raise ValueError(f"no junction {mode!r} at block {block} of {n_blocks}")
    acc = ACC if block > 0 else 0
    return RES | acc | (SCALE | STORE_A if block == n_blocks - 1 else STORE_V)


def junction_bytes(mode: str, shape, block: int = 0, n_blocks: int = 1) -> int:
    """Device-memory bytes one launch reads and writes: ``c``, the bias and
    what the flags read, what they store, each once (f32; the lengths
    aside)."""
    flags = junction_flags(mode, block, n_blocks)
    arrays = 1 + sum(bool(flags & f) for f in (RES, ACC, STORE_V, STORE_A))
    b, ch, t = shape
    return (arrays * b * t + 1) * ch * 4


@lru_cache(maxsize=None)
def _hj_lib() -> ctypes.CDLL:
    lib = load_library("hifigan_junction")
    lib.hj_run.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.hj_run.restype = ctypes.c_int
    lib.hj_flags.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.hj_flags.restype = None
    return lib


def kernel_flags() -> tuple:
    """The flag bits csrc/hifigan_junction.cu itself uses, in this module's
    order (RES, ACC, SCALE, STORE_V, STORE_A)."""
    out = (ctypes.c_int * 5)()
    _hj_lib().hj_flags(out)
    return tuple(out)


def _check(c, x, total, lengths, bias) -> None:
    if c.dim() != 3 or c.dtype != torch.float32:
        raise ValueError(f"junction: c must be (B, C, T) float32, got {tuple(c.shape)} {c.dtype}")
    for name, t in (("c", c), ("x", x), ("total", total)):
        if t is None:
            continue
        if t.shape != c.shape or t.dtype != c.dtype or t.device != c.device:
            raise ValueError(f"junction: {name} must match c's shape, dtype and device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"junction: {name} must be contiguous and 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("junction: the kernel has no backward; call it under torch.no_grad()")
    b, ch, _ = c.shape
    if b > 65535 or ch > 65535:
        raise ValueError(f"junction: at most 65535 rows and channels, got {b} and {ch}")
    if lengths is not None and (
        lengths.shape != (b,) or lengths.dtype != torch.int64 or lengths.device != c.device
        or not lengths.is_contiguous()
    ):
        raise ValueError("junction: lengths must be (B,) int64 on c's device")
    if (
        bias.shape != (ch,) or bias.dtype != c.dtype or bias.device != c.device
        or not bias.is_contiguous() or (bias.requires_grad and torch.is_grad_enabled())
    ):
        raise ValueError("junction: bias must be (C,) float32 on c's device, without grad")


def junction(mode, c, bias, lengths, scale, slope, x=None, total=None, block=0, n_blocks=1):
    """One junction (the module docstring): ``c`` is overwritten as the mode
    says. A CPU tensor runs ``junction_plain``; a CUDA tensor launches the
    kernel or raises."""
    if c.device.type == "cpu":
        return junction_plain(mode, c, bias, lengths, scale, slope, x, total, block, n_blocks)
    if c.device.type != "cuda":
        raise ValueError(f"junction: unsupported device {c.device}")
    flags = junction_flags(mode, block, n_blocks)
    if (x is None) == bool(flags & RES) or (total is None) == bool(flags & ACC):
        raise ValueError(f"junction {mode} at block {block}: x and total as the mode reads them")
    _check(c, x, total, lengths, bias)
    act = torch.empty_like(c) if mode in (J0, J2) else None
    out_v = total if flags & ACC and flags & STORE_V else c
    out_a = act if act is not None else (total if flags & ACC else c)
    ptr = lambda t: None if t is None else t.data_ptr()
    b, ch, t = c.shape
    with torch.cuda.device(c.device):
        rc = _hj_lib().hj_run(
            flags, c.data_ptr(), bias.data_ptr(), ptr(x), ptr(total),
            out_v.data_ptr() if flags & STORE_V else None, out_a.data_ptr() if flags & STORE_A else None,
            ptr(lengths), b, ch, t, scale, slope, n_blocks, torch.cuda.current_stream(c.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hifigan junction kernel launch failed: CUDA error {rc}")
    junction.launches += 1
    if act is not None:
        return c, act
    return out_a if flags & STORE_A else out_v


junction.launches = 0
