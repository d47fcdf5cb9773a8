"""Plain HiFi-GAN V1 generator (Kong, Kim and Bae, NeurIPS 2020,
arXiv:2010.05646), one utterance at a time, in float32 with TF32 off.

Written from the layer equations of ``config_v1.json`` of jik876/hifi-gan,
in the module layout of ParallelWaveGAN's ``HiFiGANGenerator``
(kan-bayashi/ParallelWaveGAN), whose checkpoint keys name the weights here:

    input_conv                 Conv1d(in, C, 7, padding 3)
    for stage i:
      leaky_relu(slope)
      upsamples.{i}.1          ConvTranspose1d(C/2^i, C/2^(i+1), k_i, s_i,
                               padding s_i//2 + s_i%2, output_padding s_i%2):
                               exactly s_i times the length
      the mean of the residual blocks blocks.{i*n+j} (kernel sizes k_j):
        for each dilation d of block j:
          x = x + convs2.{m}.1(lrelu(convs1.{m}.1(lrelu(x))))
          (convs1 at dilation d, convs2 at dilation 1; zero "same"
          padding (k-1)//2 * dilation)
    leaky_relu(0.01), output_conv.1 Conv1d(C/2^n, out, 7, padding 3), tanh

``vocoder`` is the configuration's ``vocoder`` section as a dict
(``upsample_scales``, ``upsample_kernel_sizes``, ``resblock_kernel_sizes``,
``resblock_dilations``, ``in_channels``, ``out_channels``, ``channels``,
``kernel_size``, ``negative_slope``). Departures from the published
generator: the weights are plain ``weight`` tensors, weight norm folded in
(``w = g v / ||v||``, norms over every dimension but the first), which is
what the weight-normed layer computes; the last LeakyReLU's slope is 0.01,
PyTorch's default, as ParallelWaveGAN and jik876's code have it, though the
paper's figure shows one slope throughout. No masking, no batching, no
kernel of the program under test: each layer is one ``torch.nn.functional``
call.

``make_params`` draws a generator from a seed with PyTorch's default
convolution initialisation: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights
and biases, with ``fan_in`` the product of a weight's dimensions after the
first (for a transposed convolution PyTorch's count, out / groups x taps).

This file imports torch alone, and is kept identical in the benchmark's
``vc_bench/reference/hifigan.py``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# the slope of the LeakyReLU before the output convolution
OUTPUT_SLOPE = 0.01


def hop(vocoder: dict) -> int:
    return math.prod(vocoder["upsample_scales"])


def param_shapes(vocoder: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every weight and bias, in the module order."""
    c, k = vocoder["channels"], vocoder["kernel_size"]
    out = [("input_conv.weight", (c, vocoder["in_channels"], k)), ("input_conv.bias", (c,))]
    n_blocks = len(vocoder["resblock_kernel_sizes"])
    for i, (s, ku) in enumerate(zip(vocoder["upsample_scales"], vocoder["upsample_kernel_sizes"])):
        c_in, c_out = c >> i, c >> (i + 1)
        out += [(f"upsamples.{i}.1.weight", (c_in, c_out, ku)), (f"upsamples.{i}.1.bias", (c_out,))]
        for j, (kb, dils) in enumerate(zip(vocoder["resblock_kernel_sizes"], vocoder["resblock_dilations"])):
            for conv in ("convs1", "convs2"):
                for m in range(len(dils)):
                    pre = f"blocks.{i * n_blocks + j}.{conv}.{m}.1"
                    out += [(f"{pre}.weight", (c_out, c_out, kb)), (f"{pre}.bias", (c_out,))]
    c_last = c >> len(vocoder["upsample_scales"])
    out += [("output_conv.1.weight", (vocoder["out_channels"], c_last, k)),
            ("output_conv.1.bias", (vocoder["out_channels"],))]
    return out


def make_params(vocoder: dict, seed: int, device) -> Params:
    """A generator drawn from ``seed`` on ``device`` in one draw (the module
    docstring)."""
    shapes = param_shapes(vocoder)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out: Params = {}
    fan_in = 1
    for (name, shape), part in zip(shapes, flat.split(sizes)):
        if name.endswith("weight"):
            fan_in = math.prod(shape[1:])
        out[name] = part.view(shape).mul(1.0 / math.sqrt(fan_in))
    return out


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def generate(mel: torch.Tensor, params: Params, vocoder: dict,
             dtype: Optional[torch.dtype] = None, tf32: bool = False) -> torch.Tensor:
    """One normalised mel (T, in_channels) -> its wav (hop x T,), float32.
    ``dtype`` casts the weights and the input (a lower-precision control);
    the default computes in float32. TF32 is off throughout, unless ``tf32``
    leaves PyTorch's TF32 switches as the caller set them."""
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    w = lambda name: cast(params[f"{name}.weight"])
    b = lambda name: cast(params[f"{name}.bias"])
    slope = vocoder["negative_slope"]
    k = vocoder["kernel_size"]
    n_blocks = len(vocoder["resblock_kernel_sizes"])
    with contextlib.nullcontext() if tf32 else _no_tf32(), torch.no_grad():
        x = F.conv1d(cast(mel).t()[None], w("input_conv"), b("input_conv"), padding=(k - 1) // 2)
        for i, s in enumerate(vocoder["upsample_scales"]):
            up = f"upsamples.{i}.1"
            x = F.conv_transpose1d(F.leaky_relu(x, slope), w(up), b(up), stride=s,
                                   padding=s // 2 + s % 2, output_padding=s % 2)
            total = 0.0
            for j, (kb, dils) in enumerate(zip(vocoder["resblock_kernel_sizes"], vocoder["resblock_dilations"])):
                y = x
                for m, d in enumerate(dils):
                    pre = f"blocks.{i * n_blocks + j}"
                    t = F.conv1d(F.leaky_relu(y, slope), w(f"{pre}.convs1.{m}.1"), b(f"{pre}.convs1.{m}.1"),
                                 padding=(kb - 1) // 2 * d, dilation=d)
                    t = F.conv1d(F.leaky_relu(t, slope), w(f"{pre}.convs2.{m}.1"), b(f"{pre}.convs2.{m}.1"),
                                 padding=(kb - 1) // 2)
                    y = t + y
                total = total + y
            x = total / n_blocks
        x = F.conv1d(F.leaky_relu(x, OUTPUT_SLOPE), w("output_conv.1"), b("output_conv.1"),
                     padding=(k - 1) // 2)
        return torch.tanh(x)[0, 0].float()
