"""The cost of one HiFi-GAN V1 training step (``reference/hifigan_train.py``):
its operations and least bytes, whatever implements it.

Counted as ``flops.py`` and ``hifigan_flops.py`` count: 2 x MACs of each
convolution, at its output length. A ``Conv2d`` of the period discriminator
with kernel (k, 1) over (T / p, p) is p columns of a one-dimensional
convolution; a grouped convolution has c_in / groups inputs an output. A
backward pass costs the forward's operations once for the weights'
gradient and once for the inputs', layer by layer. A step of ``batch_size``
segments of T samples (F frames) needs:

- the generator's forward (``hifigan_flops.generator_flops`` over F
  frames) and its backward: the weights' gradients, and the inputs' of
  every layer but ``input_conv``, whose input (the mel) needs none;
- four passes of the two discriminators over a segment (y and y_hat in the
  discriminators' update, again in the generator's);
- the discriminators' update's backward over its two passes: the weights'
  gradients, and the inputs' of every layer but each sub-discriminator's
  first, whose input (y, or y_hat detached) needs none;
- the generator's update's backward through the discriminators' pass over
  y_hat to y_hat: the inputs' gradients of every layer, no weight's.

Spectral norm's power iterations, weight norm, the LeakyReLUs, the pools,
the losses and both STFTs are not counted. The least bytes are each
network's AdamW traffic (parameters read and written, the gradient read,
both moments read and written: 7 x 4 bytes a parameter) and the segments'
windows read once. ``vt`` is the configuration's ``vocoder_train``
section, ``voc`` its ``vocoder``.
"""

from __future__ import annotations

from typing import List

from .hifigan_flops import generator_flops, layers, weight_count

F32 = 4


def disc_layer_flops(vt: dict, t: int) -> List[List[int]]:
    """For each sub-discriminator (the period ones first), the operations of
    each of its convolutions on one wav of ``t`` samples."""
    out = []
    k, pk = vt["mpd_kernel_size"], vt["post_kernel_size"]
    chans = [1] + list(vt["mpd_channels"])
    for p in vt["mpd_periods"]:
        h = -(-t // p)
        sub = []
        for ci, co, s in zip(chans[:-1], chans[1:], vt["mpd_strides"]):
            h = (h + 2 * ((k - 1) // 2) - k) // s + 1
            sub.append(2 * h * p * k * ci * co)
        h_post = h + 2 * ((pk - 1) // 2) - pk + 1
        sub.append(2 * h_post * p * pk * chans[-1])
        out.append(sub)
    chans = [1] + list(vt["msd_channels"])
    n = t
    for i in range(vt["msd_scales"]):
        if i:
            n = (n + 2 * 2 - 4) // 2 + 1
        length, sub = n, []
        for ci, co, kk, s, g in zip(chans[:-1], chans[1:], vt["msd_kernel_sizes"], vt["msd_strides"],
                                    vt["msd_groups"]):
            length = (length + 2 * ((kk - 1) // 2) - kk) // s + 1
            sub.append(2 * length * kk * (ci // g) * co)
        sub.append(2 * (length + 2 * ((pk - 1) // 2) - pk + 1) * pk * chans[-1])
        out.append(sub)
    return out


def disc_pass_flops(vt: dict, t: int) -> int:
    """Both discriminators' forward on one wav of ``t`` samples."""
    return sum(map(sum, disc_layer_flops(vt, t)))


def disc_first_flops(vt: dict, t: int) -> int:
    """The first convolution of each sub-discriminator, on one wav."""
    return sum(sub[0] for sub in disc_layer_flops(vt, t))


def gen_first_flops(voc: dict, frames: int) -> int:
    lay = layers(voc)[0]
    return 2 * frames * lay["k"] * lay["c_in"] * lay["c_out"]


def segment_flops(voc: dict, vt: dict, hop: int) -> dict:
    """The parts of a step's operations for one segment."""
    t = vt["segment_samples"]
    frames = t // hop
    g, p = generator_flops(voc, frames), disc_pass_flops(vt, t)
    return {
        "gen_forward": g,
        "gen_backward": 2 * g - gen_first_flops(voc, frames),
        "disc_passes": 4 * p,
        "disc_backward": 2 * (2 * p - disc_first_flops(vt, t)),
        "disc_to_y_hat": p,
    }


def step_flops(cfg: dict) -> int:
    """The operations of one step of ``batch_size`` segments."""
    vt = cfg["vocoder_train"]
    return vt["batch_size"] * sum(segment_flops(cfg["vocoder"], vt, cfg["signal"]["hop_length"]).values())


def disc_param_count(vt: dict) -> int:
    """The discriminators' weights and biases (weight norm's g counted as
    one number an output channel)."""
    n = 0
    for k, sub in (("mpd", [1] + list(vt["mpd_channels"])), ("msd", [1] + list(vt["msd_channels"]))):
        if k == "mpd":
            taps = [(vt["mpd_kernel_size"], 1)] * (len(sub) - 1)
            per = sum(ci * co * kk + 2 * co for (ci, co), (kk, _) in zip(zip(sub[:-1], sub[1:]), taps))
            per += sub[-1] * vt["post_kernel_size"] + 2
            n += per * len(vt["mpd_periods"])
        else:
            per = sum(ci // g * co * kk + 2 * co for ci, co, kk, g in
                      zip(sub[:-1], sub[1:], vt["msd_kernel_sizes"], vt["msd_groups"]))
            per += sub[-1] * vt["post_kernel_size"] + 2
            n += per * vt["msd_scales"]
    return n


def step_bytes(cfg: dict) -> int:
    """The least bytes of one step: both AdamWs' traffic and the windows."""
    vt, sig = cfg["vocoder_train"], cfg["signal"]
    frames = vt["segment_samples"] // sig["hop_length"]
    gen_params = weight_count(cfg["vocoder"]) + sum(lay["c_out"] for lay in layers(cfg["vocoder"]))
    window = (frames - 1) * sig["hop_length"] + sig["n_fft"]
    return 7 * F32 * (gen_params + disc_param_count(vt)) + F32 * vt["batch_size"] * window

