"""The HiFi-GAN generator's cost: operations and least bytes of each layer
at a pair's true decoder length, and the least time of the whole.

Counted as ``flops.py`` counts the model: 2 x MACs of each convolution,
taps x input channels x output channels for each input sample (a dilated
convolution costs what an undilated one of the same taps costs; a
transposed convolution of stride s and k taps is k / s taps for each
output sample). LeakyReLUs, the residual sums, the mean over
the blocks and tanh are not counted. A layer's least bytes are its input,
weights, bias and output in float32, each once. The whole generator's least
bytes are its input mel, its weights and its wav once. ``vocoder`` is the
configuration's ``vocoder`` section.
"""

from __future__ import annotations

import math
from typing import List

from .flops import PEAK_HBM_BYTES, PEAK_TF32

F32 = 4


def layers(vocoder: dict) -> List[dict]:
    """Every convolution: name, input and output channels, the weight's
    taps, and input and output samples per mel frame."""
    c, k = vocoder["channels"], vocoder["kernel_size"]
    out = [dict(name="input_conv", c_in=vocoder["in_channels"], c_out=c, k=k, rate_in=1, rate_out=1)]
    n_blocks = len(vocoder["resblock_kernel_sizes"])
    rate = 1
    for i, (s, ku) in enumerate(zip(vocoder["upsample_scales"], vocoder["upsample_kernel_sizes"])):
        c_in, c_out = c >> i, c >> (i + 1)
        out.append(dict(name=f"upsamples.{i}.1", c_in=c_in, c_out=c_out, k=ku, rate_in=rate,
                        rate_out=rate * s))
        rate *= s
        for j, (kb, dils) in enumerate(zip(vocoder["resblock_kernel_sizes"], vocoder["resblock_dilations"])):
            for conv in ("convs1", "convs2"):
                for m in range(len(dils)):
                    out.append(dict(name=f"blocks.{i * n_blocks + j}.{conv}.{m}.1", c_in=c_out, c_out=c_out,
                                    k=kb, rate_in=rate, rate_out=rate))
    out.append(dict(name="output_conv.1", c_in=c >> len(vocoder["upsample_scales"]),
                    c_out=vocoder["out_channels"], k=k, rate_in=rate, rate_out=rate))
    return out


def _weights(layer: dict) -> int:
    """Weight and bias elements."""
    return layer["c_in"] * layer["c_out"] * layer["k"] + layer["c_out"]


def layer_costs(vocoder: dict, frames: int) -> List[dict]:
    """Each layer's operations and least bytes over ``frames`` mel frames."""
    out = []
    for lay in layers(vocoder):
        n_in, n_out = frames * lay["rate_in"], frames * lay["rate_out"]
        flops = 2 * n_in * lay["k"] * lay["c_in"] * lay["c_out"]
        nbytes = F32 * (n_in * lay["c_in"] + _weights(lay) + n_out * lay["c_out"])
        out.append({"name": lay["name"], "flops": flops, "bytes": nbytes})
    return out


def generator_flops(vocoder: dict, frames: int) -> int:
    return sum(c["flops"] for c in layer_costs(vocoder, frames))


def weight_count(vocoder: dict) -> int:
    return sum(_weights(lay) for lay in layers(vocoder))


def generator_bytes(vocoder: dict, frames: int, calls: int = 1) -> int:
    """The input mel, the weights (once a call) and the wav, each once."""
    hop = math.prod(vocoder["upsample_scales"])
    return F32 * (frames * vocoder["in_channels"] + calls * weight_count(vocoder)
                  + frames * hop * vocoder["out_channels"])


def gen_least_seconds(vocoder: dict, frames: int, calls: int = 1) -> float:
    """The least time of the generator's valid work over ``frames`` frames
    in ``calls`` calls: its operations at the TF32 peak (the configuration
    leaves cuDNN's TF32 convolutions on) or its bytes over HBM, whichever is
    longer."""
    return max(generator_flops(vocoder, frames) / PEAK_TF32,
               generator_bytes(vocoder, frames, calls) / PEAK_HBM_BYTES)
