"""The benchmark's yardstick: operations and bytes of the work a cell asks
for, and the H100's peaks by precision.

The model's arithmetic is counted from the configuration the way
``utils/roofline.py`` of the program under test counts it (2 x MACs of each
conv and dense layer at its output length; backward twice the forward);
it is written out again here so that a change to the program cannot move
the yardstick. Spectral norm adds, per decoder layer (O outputs, I inputs
times taps) and step, 12 O I: the forward's power iteration and sigma
(6 O I), the backward through sigma (2 O I) and the update's power
iteration (4 O I).

Griffin-Lim is counted over the frames it vocodes: each of the kernel's
iterations is two products of 2 x frames x (2 x n_freq) x support, the
window's nonzero samples (1199 of 1200 at the published signal), and the
bytes are the kernel's inputs read once (magnitude, starting phases, the
bf16 basis, its two gain vectors) and its complex output written once.
"""

from __future__ import annotations

import math
from typing import List

# NVIDIA H100 SXM data sheet, dense, 700 W
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_HBM_BYTES = 3.35e12

# iterations of the fused Griffin-Lim that run in the kernel (of 100: 4
# exact warm-start and 2 exact polish iterations run outside it)
KERNEL_ITERS = 94


def _conv(b: int, t: int, k: int, c_in: int, c_out: int) -> int:
    return 2 * b * t * k * c_in * c_out


def _bank(e: dict) -> List[int]:
    return list(range(e["bank_scale"], e["bank_size"] + 1, e["bank_scale"]))


def _encoder_blocks(e: dict, b: int, t: int):
    flops = 0
    for sub in e["subsample"][: e["n_conv_blocks"]]:
        flops += _conv(b, t, e["kernel_size"], e["c_h"], e["c_h"])
        t = -(-t // sub)
        flops += _conv(b, t, e["kernel_size"], e["c_h"], e["c_h"])
    return flops, t


def speaker_encoder_flops(model: dict, b: int, t: int) -> int:
    e = model["SpeakerEncoder"]
    ks = _bank(e)
    f = sum(_conv(b, t, k, e["c_in"], e["c_bank"]) for k in ks)
    f += _conv(b, t, 1, e["c_bank"] * len(ks) + e["c_in"], e["c_h"])
    f += _encoder_blocks(e, b, t)[0]
    f += 2 * e["n_dense_blocks"] * 2 * b * e["c_h"] * e["c_h"] + 2 * b * e["c_h"] * e["c_out"]
    return f


def content_encoder_flops(model: dict, b: int, t: int) -> int:
    e = model["ContentEncoder"]
    ks = _bank(e)
    f = sum(_conv(b, t, k, e["c_in"], e["c_bank"]) for k in ks)
    f += _conv(b, t, 1, e["c_bank"] * len(ks) + e["c_in"], e["c_h"])
    blocks, t_out = _encoder_blocks(e, b, t)
    return f + blocks + 2 * _conv(b, t_out, 1, e["c_h"], e["c_out"])


def content_frames(model: dict, t: int) -> int:
    for sub in model["ContentEncoder"]["subsample"][: model["ContentEncoder"]["n_conv_blocks"]]:
        t = -(-t // sub)
    return t


def decoder_flops(model: dict, b: int, t: int) -> int:
    d = model["Decoder"]
    f = _conv(b, t, 1, d["c_in"], d["c_h"])
    for up in d["upsample"][: d["n_conv_blocks"]]:
        f += _conv(b, t, d["kernel_size"], d["c_h"], d["c_h"])
        f += _conv(b, t, d["kernel_size"], d["c_h"], d["c_h"] * up)
        f += 2 * 2 * b * d["c_cond"] * d["c_h"] * 2
        t *= up
    return f + _conv(b, t, 1, d["c_h"], d["c_out"])


def decoder_frames(model: dict, t_src: int) -> int:
    t = content_frames(model, t_src)
    for up in model["Decoder"]["upsample"][: model["Decoder"]["n_conv_blocks"]]:
        t *= up
    return t


def sn_step_flops(model: dict) -> int:
    d = model["Decoder"]
    if not d.get("sn"):
        return 0
    oi = d["c_in"] * d["c_h"] + d["c_h"] * d["c_out"]
    for up in d["upsample"][: d["n_conv_blocks"]]:
        oi += d["c_h"] * d["c_h"] * d["kernel_size"] * (1 + up)
    oi += 2 * d["n_conv_blocks"] * d["c_cond"] * d["c_h"] * 2
    return 12 * oi


def train_step_flops(model: dict, batch: int, segment: int) -> int:
    """One training step: forward, backward (2x forward) and spectral norm."""
    fwd = (speaker_encoder_flops(model, batch, segment)
           + content_encoder_flops(model, batch, segment)
           + decoder_flops(model, batch, content_frames(model, segment)))
    return 3 * fwd + sn_step_flops(model)


def inference_flops(model: dict, src_frames: int, tar_frames: int) -> int:
    """One conversion's forward: the speaker encoder on the target, the
    content encoder on the source, the decoder on the content code."""
    return (speaker_encoder_flops(model, 1, tar_frames)
            + content_encoder_flops(model, 1, src_frames)
            + decoder_flops(model, 1, content_frames(model, src_frames)))


def _support(sig: dict) -> int:
    """Nonzero samples of a periodic Hann window of win_length."""
    w = sig["win_length"]
    return sum(1 for n in range(w) if math.cos(2 * math.pi * n / w) != 1.0)


def gl_flops(sig: dict, frames: int, n_iter: int = KERNEL_ITERS) -> int:
    n_freq = 1 + sig["n_fft"] // 2
    return n_iter * 2 * (2 * frames * 2 * n_freq * _support(sig))


def gl_bytes(sig: dict, frames: int) -> int:
    n_freq = 1 + sig["n_fft"] // 2
    s = _support(sig)
    return (frames * n_freq * 4          # magnitude
            + frames * n_freq * 8        # starting phases (complex)
            + s * 2 * n_freq * 2         # bf16 basis
            + n_freq * 4 + s * 4         # the two gains
            + frames * n_freq * 8)       # complex output


def gl_least_seconds(sig: dict, frames: int) -> float:
    return max(gl_flops(sig, frames) / PEAK_BF16, gl_bytes(sig, frames) / PEAK_HBM_BYTES)
