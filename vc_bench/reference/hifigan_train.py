"""Plain HiFi-GAN V1 training (Kong, Kim and Bae, NeurIPS 2020,
arXiv:2010.05646), one step as jik876/hifi-gan's ``train.py`` orders it,
in float32 with TF32 off.

Written from the layer equations of jik876's ``models.py`` (``config_v1``),
with every weight-normed convolution's weight ``g v / ||v||`` (the norm over
every dimension but the first, ``torch.nn.utils.weight_norm``'s ``dim=0``)
and every spectral-norm one's ``W / sigma`` as ``torch.nn.utils.spectral_norm``'s
pre-hook computes it in training mode: ``v = normalize(W^T u)``,
``u = normalize(W v)`` without autograd, both stored, ``sigma = u^T W v``.
The generator is ``reference/hifigan.py``'s, batched and differentiable
here; the names of every parameter are ParallelWaveGAN's generator keys and
the discriminators' ``mpd.discriminators.{i}.convs.{j}`` /
``conv_post`` and ``msd.discriminators.{i}...`` (``_v`` / ``_g``, or
``weight_orig`` / ``weight_u`` / ``weight_v``).

- The multi-period discriminator: per period p, reflect-pad the wav to a
  multiple of p, view it as (B, 1, T / p, p), ``Conv2d`` layers of kernel
  (k, 1), stride (s, 1), padding ((k - 1) // 2, 0), a LeakyReLU(0.1) after
  each, ``conv_post``. The multi-scale one: sub-discriminator i on the wav
  average-pooled i times (``avg_pool1d(4, 2, padding=2)``), grouped
  ``Conv1d`` layers, a LeakyReLU after each, ``conv_post``. Feature maps:
  every LeakyReLU's output and ``conv_post``'s.
- One step: y_hat = G(mel); the discriminators' update on (y, y_hat
  detached), least squares, ``torch.optim.AdamW``; then the generator's
  update with every sub-discriminator on y, then y_hat, again:
  ``lambda_adv`` x sum mean((1 - D(y_hat))^2) + ``lambda_fm`` x sum
  mean|f(y) - f(y_hat)| + ``lambda_mel`` x L1 of the log mels, and its own
  AdamW. AdamW is PyTorch's (``foreach=False``): lr, betas, eps and
  decoupled weight decay from the configuration, no clipping. The loss mel
  is jik876's ``mel_spectrogram``: reflect padding of (n_fft - hop) / 2,
  ``torch.stft`` without centring (periodic Hann of ``win_length``),
  sqrt(re^2 + im^2 + 1e-9), the mel basis, log(max(., 1e-5)).

Departures from the published job: the signal is 24 kHz with hop 300 and a
segment of ``segment_samples`` samples (8400, 28 frames), ParallelWaveGAN's
VCTK recipe; the loss mel takes this system's STFT (n_fft 2048, win 1200)
and its 512-bin Slaney mel basis up to sr / 2 (``featurize.mel_basis``) in
place of jik876's 80 bins; the generator's input is this system's
normalised dB mel of the segment's pre-emphasised window (``input_mels``),
not jik876's log mel; the first steps take no lr decay (it comes once an
epoch).

A batch is drawn as the program under test documents its sampler
(train/vocoder.py ``sample_batch``): a device generator seeded with
``step_seed(seed, i)``, ``batch_size`` 62-bit integers modulo the number of
window starts, each window ``(frames - 1) x hop + n_fft`` samples of the
packed corpus from its start, the segment n_fft / 2 into it. That rule is
written out here again; nothing of the program is imported.

This file imports torch and the reference's own files alone.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import hifigan as ref_gen
from .featurize import hann, mel_basis
from .train import leaf_norms, step_seed

Params = Dict[str, torch.Tensor]
SLOPE = 0.1


def disc_layers(vt: dict) -> List[dict]:
    """Every discriminator convolution in module order: name, shape of its
    weight, stride, padding, groups, 2-D or not, and its norm."""
    out = []
    k, pk = vt["mpd_kernel_size"], vt["post_kernel_size"]
    chans = [1] + list(vt["mpd_channels"])
    for i, _ in enumerate(vt["mpd_periods"]):
        pre = f"mpd.discriminators.{i}"
        for j, (ci, co, s) in enumerate(zip(chans[:-1], chans[1:], vt["mpd_strides"])):
            out.append(dict(name=f"{pre}.convs.{j}", shape=(co, ci, k, 1), stride=(s, 1),
                            pad=((k - 1) // 2, 0), groups=1, norm="weight"))
        out.append(dict(name=f"{pre}.conv_post", shape=(1, chans[-1], pk, 1), stride=(1, 1),
                        pad=((pk - 1) // 2, 0), groups=1, norm="weight"))
    chans = [1] + list(vt["msd_channels"])
    for i in range(vt["msd_scales"]):
        pre = f"msd.discriminators.{i}"
        norm = "spectral" if vt["msd_spectral_norm_first"] and i == 0 else "weight"
        for j, (ci, co, kk, s, g) in enumerate(zip(chans[:-1], chans[1:], vt["msd_kernel_sizes"],
                                                    vt["msd_strides"], vt["msd_groups"])):
            out.append(dict(name=f"{pre}.convs.{j}", shape=(co, ci // g, kk), stride=s, pad=(kk - 1) // 2,
                            groups=g, norm=norm))
        out.append(dict(name=f"{pre}.conv_post", shape=(1, chans[-1], pk), stride=1, pad=(pk - 1) // 2,
                        groups=1, norm=norm))
    return out


def _norms(w: torch.Tensor) -> torch.Tensor:
    """||w|| over every dimension but the first, shaped to broadcast."""
    return w.pow(2).sum(dim=tuple(range(1, w.dim())), keepdim=True).sqrt()


def weight_normed(plain: Params) -> Params:
    """Plain ``<layer>.weight`` -> ``<layer>.weight_g`` (its norms) and
    ``<layer>.weight_v`` (itself), as ``weight_norm`` initialises them."""
    out = {}
    for k, v in plain.items():
        if k.endswith(".weight"):
            out[k + "_g"] = _norms(v).clone()
            out[k + "_v"] = v.clone()
        else:
            out[k] = v.clone()
    return out


def make_gen_params(vocoder: dict, seed: int, device) -> Params:
    """The generator of ``reference/hifigan.py``'s ``make_params``, weight-normed."""
    return weight_normed(ref_gen.make_params(vocoder, seed, device))


def make_disc_params(vt: dict, seed: int, device) -> Params:
    """The discriminators drawn from ``seed`` in one draw: PyTorch's default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and bias (fan_in the
    weight's input channels per group times its taps), weight-normed; the
    spectral-norm layers' ``u`` and ``v`` unit normal draws after them."""
    lays = disc_layers(vt)
    sizes = [math.prod(lay["shape"]) + lay["shape"][0] for lay in lays]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    plain: Params = {}
    for lay, part in zip(lays, flat.split(sizes)):
        bound = 1.0 / math.sqrt(math.prod(lay["shape"][1:]))
        n = math.prod(lay["shape"])
        plain[lay["name"] + ".bias"] = part[n:].mul(bound)
        plain[lay["name"] + ".weight"] = part[:n].view(lay["shape"]).mul(bound)
    out: Params = {}
    for lay in lays:
        name = lay["name"]
        w, b = plain[name + ".weight"], plain[name + ".bias"]
        out[name + ".bias"] = b
        if lay["norm"] == "weight":
            out[name + ".weight_g"] = _norms(w).clone()
            out[name + ".weight_v"] = w
        else:
            out[name + ".weight_orig"] = w
            o, rest = w.shape[0], math.prod(w.shape[1:])
            out[name + ".weight_u"] = F.normalize(torch.randn(o, generator=gen, device=device), dim=0)
            out[name + ".weight_v"] = F.normalize(torch.randn(rest, generator=gen, device=device), dim=0)
    return out


def _wn(params: Params, name: str) -> torch.Tensor:
    v = params[name + ".weight_v"]
    return params[name + ".weight_g"] * v / _norms(v)


def _sn(params: Params, name: str) -> torch.Tensor:
    """torch's spectral_norm in training mode: the stored u and v advance."""
    w = params[name + ".weight_orig"]
    wm = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = F.normalize(torch.mv(wm.t(), params[name + ".weight_u"]), dim=0, eps=1e-12)
        u = F.normalize(torch.mv(wm, v), dim=0, eps=1e-12)
        params[name + ".weight_u"], params[name + ".weight_v"] = u, v
    return w / torch.dot(u, torch.mv(wm, v))


def generate(mel: torch.Tensor, params: Params, vocoder: dict) -> torch.Tensor:
    """Normalised mels (B, n_mels, T) -> wavs (B, 1, hop x T):
    ``reference/hifigan.py``'s generator, batched, with autograd."""
    w = lambda name: _wn(params, name)
    b = lambda name: params[f"{name}.bias"]
    slope, k = vocoder["negative_slope"], vocoder["kernel_size"]
    n_blocks = len(vocoder["resblock_kernel_sizes"])
    x = F.conv1d(mel, w("input_conv"), b("input_conv"), padding=(k - 1) // 2)
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
    x = F.conv1d(F.leaky_relu(x, ref_gen.OUTPUT_SLOPE), w("output_conv.1"), b("output_conv.1"),
                 padding=(k - 1) // 2)
    return torch.tanh(x)


def sub_discriminator(x: torch.Tensor, params: Params, lays: List[dict], period: int = 0):
    """One sub-discriminator on a wav (B, 1, T): (flattened score, feature maps)."""
    if period:
        b, c, t = x.shape
        if t % period:
            x = F.pad(x, (0, period - t % period), "reflect")
        x = x.view(b, c, -1, period)
    fmap = []
    for n, lay in enumerate(lays):
        name = lay["name"]
        wt = _wn(params, name) if lay["norm"] == "weight" else _sn(params, name)
        conv = F.conv2d if period else F.conv1d
        x = conv(x, wt, params[name + ".bias"], stride=lay["stride"], padding=lay["pad"], groups=lay["groups"])
        if n < len(lays) - 1:
            x = F.leaky_relu(x, SLOPE)
        fmap.append(x)
    return torch.flatten(x, 1, -1), fmap


def discriminators(y: torch.Tensor, y_hat: torch.Tensor, params: Params, vt: dict):
    """jik876's ``mpd(y, y_hat)`` then ``msd(y, y_hat)``: each
    sub-discriminator on y, then y_hat. (real scores, fake scores, real
    feature maps, fake feature maps)."""
    lays = disc_layers(vt)
    n_p = len(vt["mpd_channels"]) + 1
    n_s = len(vt["msd_channels"]) + 1
    real, fake, fr, fg = [], [], [], []
    for i, p in enumerate(vt["mpd_periods"]):
        sub = lays[i * n_p : (i + 1) * n_p]
        for out, x in ((0, y), (1, y_hat)):
            s, f = sub_discriminator(x, params, sub, p)
            (real if out == 0 else fake).append(s)
            (fr if out == 0 else fg).append(f)
    base = len(vt["mpd_periods"]) * n_p
    for i in range(vt["msd_scales"]):
        if i:
            y, y_hat = F.avg_pool1d(y, 4, 2, padding=2), F.avg_pool1d(y_hat, 4, 2, padding=2)
        sub = lays[base + i * n_s : base + (i + 1) * n_s]
        for out, x in ((0, y), (1, y_hat)):
            s, f = sub_discriminator(x, params, sub)
            (real if out == 0 else fake).append(s)
            (fr if out == 0 else fg).append(f)
    return real, fake, fr, fg


def log_mel(y: torch.Tensor, sig: dict) -> torch.Tensor:
    """jik876's ``mel_spectrogram`` of (B, T) with this system's STFT and mel basis."""
    n_fft, hop, win = sig["n_fft"], sig["hop_length"], sig["win_length"]
    pad = (n_fft - hop) // 2
    yp = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.hann_window(win, device=y.device)
    spec = torch.stft(yp, n_fft, hop_length=hop, win_length=win, window=window, center=False,
                      normalized=False, onesided=True, return_complex=True)
    mag = torch.sqrt(torch.view_as_real(spec).pow(2).sum(-1) + 1e-9)
    basis = torch.from_numpy(mel_basis(sig["sr"], n_fft, sig["n_mels"])).to(y.device)
    return torch.log(torch.clamp(torch.matmul(basis, mag), min=1e-5))


def input_mels(win: torch.Tensor, sig: dict) -> torch.Tensor:
    """The generator's input from windows (B, (frames - 1) x hop + n_fft):
    pre-emphasis, |STFT| without centring, the mel basis, 20 log10(max(1e-5,
    .)), the clip of (x - ref_db + max_db) / max_db to [1e-8, 1]:
    (B, n_mels, frames), before the attribute normalisation."""
    n_fft, hop = sig["n_fft"], sig["hop_length"]
    pre = torch.cat([win[:, :1], win[:, 1:] - sig["preemphasis"] * win[:, :-1]], dim=1)
    frames = pre.unfold(-1, n_fft, hop) * torch.from_numpy(hann(sig["win_length"], n_fft)).float().to(win.device)
    mag = torch.fft.rfft(frames, dim=-1).abs().transpose(1, 2)
    basis = torch.from_numpy(mel_basis(sig["sr"], n_fft, sig["n_mels"])).to(win.device)
    mel = 20.0 * torch.log10(torch.clamp(torch.matmul(basis, mag), min=1e-5))
    return torch.clamp((mel - sig["ref_db"] + sig["max_db"]) / sig["max_db"], 1e-8, 1.0)


def draw(packed: torch.Tensor, starts: torch.Tensor, vt: dict, sig: dict, gen: torch.Generator):
    """(windows, segments) of one step's batch."""
    frames = vt["segment_samples"] // sig["hop_length"]
    width = (frames - 1) * sig["hop_length"] + sig["n_fft"]
    r = torch.randint(0, 2**62, (vt["batch_size"],), generator=gen, device=packed.device, dtype=torch.int64)
    s = starts[torch.remainder(r, starts.shape[0])]
    win = packed[s[:, None] + torch.arange(width, device=packed.device)[None, :]]
    pad = sig["n_fft"] // 2
    return win, win[:, pad : pad + vt["segment_samples"]]


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _adamw(leaves: List[torch.Tensor], vt: dict) -> torch.optim.AdamW:
    return torch.optim.AdamW(leaves, lr=vt["lr"], betas=tuple(vt["betas"]), eps=vt["eps"],
                             weight_decay=vt["weight_decay"], foreach=False)


def reference_steps(cfg: dict, gen0: Params, disc0: Params, packed: torch.Tensor, starts: torch.Tensor,
                    attr: Dict[str, np.ndarray], seed: int, n_steps: int = 3) -> dict:
    """``n_steps`` steps from ``gen0`` / ``disc0`` (not modified), in f32
    with TF32 off. Returns each step's terms ``losses`` (the discriminators'
    loss, the adversarial loss, feature matching, the mel L1, before their
    lambdas), ``grad1``: each leaf's norm of its first gradient as AdamW
    holds it after one step (the first moment over 1 - beta1), and
    ``moments`` those tensors themselves; ``change``: each leaf's norm of
    its change after the steps, the spectral-norm ``u`` among them. Leaves
    are named ``gen.<key>`` and ``disc.<key>``."""
    vt, sig, voc = cfg["vocoder_train"], cfg["signal"], cfg["vocoder"]
    g = {k: v.detach().clone().requires_grad_(True) for k, v in gen0.items()}
    d = {k: v.detach().clone() for k, v in disc0.items()}
    d_leaves = [k for k in d if not k.endswith((".weight_u",)) and not (
        k.endswith(".weight_v") and k[: -len(".weight_v")] + ".weight_orig" in d)]
    for k in d_leaves:
        d[k].requires_grad_(True)
    opt_g = _adamw(list(g.values()), vt)
    opt_d = _adamw([d[k] for k in d_leaves], vt)
    mean = torch.as_tensor(np.asarray(attr["mean"]), dtype=torch.float32, device=packed.device)[:, None]
    std = torch.as_tensor(np.asarray(attr["std"]), dtype=torch.float32, device=packed.device)[:, None]
    gen = torch.Generator(device=packed.device)
    losses: List[List[float]] = []
    grad1: Dict[str, float] = {}
    b1 = vt["betas"][0]
    with no_tf32():
        for i in range(n_steps):
            gen.manual_seed(step_seed(seed, i))
            win, y = draw(packed, starts, vt, sig, gen)
            mel = (input_mels(win, sig) - mean) / std
            y = y[:, None]
            y_hat = generate(mel, g, voc)
            y_mel, y_hat_mel = log_mel(y[:, 0], sig), log_mel(y_hat[:, 0], sig)
            opt_d.zero_grad()
            real, fake, _, _ = discriminators(y, y_hat.detach(), d, vt)
            loss_d = sum(torch.mean((1 - r) ** 2) + torch.mean(f ** 2) for r, f in zip(real, fake))
            loss_d.backward()
            opt_d.step()
            opt_g.zero_grad()
            loss_mel = F.l1_loss(y_mel, y_hat_mel)
            _, fake, fr, fg = discriminators(y, y_hat, d, vt)
            loss_fm = sum(torch.mean(torch.abs(a - b)) for ra, ga in zip(fr, fg) for a, b in zip(ra, ga))
            loss_adv = sum(torch.mean((1 - f) ** 2) for f in fake)
            loss = vt["lambda_adv"] * loss_adv + vt["lambda_fm"] * loss_fm + vt["lambda_mel"] * loss_mel
            loss.backward()
            opt_g.step()
            losses.append([float(t.detach()) for t in (loss_d, loss_adv, loss_fm, loss_mel)])
            if i == 0:
                moments = {f"gen.{k}": opt_g.state[p]["exp_avg"] / (1 - b1) for k, p in g.items()}
                moments.update({f"disc.{k}": opt_d.state[d[k]]["exp_avg"] / (1 - b1) for k in d_leaves})
                grad1 = leaf_norms(moments)
    change = {f"gen.{k}": v.detach() - gen0[k] for k, v in g.items()}
    change.update({f"disc.{k}": v.detach() - disc0[k] for k, v in d.items()
                   if k in d_leaves or k.endswith(".weight_u")})
    return {"losses": losses, "grad1": grad1, "moments": moments, "change": leaf_norms(change)}


def compare_steps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the program's steps are judged by against the
    reference's:

    - ``loss_gap``: the largest |p - r| / |r| over the steps and their four
      loss terms;
    - ``grad_gap``: over the leaves of both networks, the gap between the
      program's and the reference's norm of the first gradient, over the
      larger of the reference's norm of that leaf and of the median leaf;
    - ``grad_dist``: the larger over the two networks of ||m - m_ref|| /
      ||m_ref||, m every leaf's first gradient together: the whole
      gradient, where a leaf's own reading is swamped by the rounding of
      the sums that cancel in it (a bias's, a weight norm's g);
    - ``change_gap``: as ``grad_gap`` for the change after the steps, over
      the leaves whose reference gradient is at least a thousandth of the
      median leaf's, and every spectral-norm ``u``.
    """
    def worst(key: str, keep) -> float:
        r, p = ref[key], prog[key]
        med = float(np.median([r[k] for k in keep]))
        return max(abs(p[k] - r[k]) / max(r[k], med) for k in keep)

    def dist(net: str) -> float:
        keys = [k for k in ref["moments"] if k.startswith(net + ".")]
        num = sum(float((prog["moments"][k].float() - ref["moments"][k].float()).square().sum()) for k in keys)
        den = sum(float(ref["moments"][k].float().square().sum()) for k in keys)
        return (num / den) ** 0.5

    g = ref["grad1"]
    g_med = float(np.median(list(g.values())))
    moving = [k for k in ref["change"] if (k in g and g[k] >= 1e-3 * g_med) or k.endswith(".weight_u")]
    return {"loss_gap": max(loss_gaps(prog["losses"], ref["losses"])), "grad_gap": worst("grad1", list(g)),
            "grad_dist": max(dist("gen"), dist("disc")), "change_gap": worst("change", moving)}


def loss_gaps(prog_losses, ref_losses) -> List[float]:
    """|p - r| / |r| of every step's every loss term, step by step."""
    return [abs(p - r) / abs(r) for ps, rs in zip(prog_losses, ref_losses) for p, r in zip(ps, rs)]


def program_reads(losses: torch.Tensor, grad1: Dict[str, torch.Tensor], change: Dict[str, torch.Tensor]) -> dict:
    """The program's numbers in ``reference_steps``'s form, from its first
    steps' loss rows and its leaves' tensors (``grad1`` kept as
    ``moments``)."""
    return {"losses": losses.tolist(), "grad1": leaf_norms(grad1), "moments": grad1,
            "change": leaf_norms(change)}

