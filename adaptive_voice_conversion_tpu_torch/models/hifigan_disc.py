"""HiFi-GAN V1's discriminators (Kong, Kim and Bae, arXiv:2010.05646), as
jik876/hifi-gan's ``models.py`` writes them, for training the generator
(train/vocoder.py).

- The multi-period discriminator (``mpd``): one ``PeriodDiscriminator`` per
  period p. It reflect-pads the wav (B, 1, T) to a multiple of p, views it as
  (B, 1, T / p, p), and runs ``Conv2d`` layers of kernel (k, 1), stride
  (s, 1) and padding ((k - 1) // 2, 0), each followed by a LeakyReLU, then
  ``conv_post`` to one channel.
- The multi-scale discriminator (``msd``): ``ScaleDiscriminator`` i sees the
  wav average-pooled i times (``AvgPool1d(4, 2, padding=2)``), through
  grouped ``Conv1d`` layers, each followed by a LeakyReLU, then
  ``conv_post``.

A sub-discriminator returns its flattened score and its feature maps: every
LeakyReLU's output and ``conv_post``'s. Every convolution is weight-normed
(models/hifigan.py ``weight_norm``), except those of the first scale
discriminator where the configuration asks for spectral norm: those hold
``weight_orig`` and the buffers ``weight_u`` / ``weight_v``, as
``torch.nn.utils.spectral_norm`` does, with its schedule: every forward takes
one power iteration from the stored ``u`` and stores the result, so ``u``
advances at each call (four times a training step: real then generated, in
the discriminator's update and again in the generator's). The arithmetic is
models/modules.py ``spectral_normalize``'s, the decoder's, which advances
its ``u`` once a step instead.

The configuration is core/config.py ``VocoderTrainConfig``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import VocoderTrainConfig
from .hifigan import weight_norm
from .modules import _normalize, spectral_normalize

Features = List[torch.Tensor]


class _SpectralNorm:
    """The forward pre-hook of a spectral-norm convolution: ``weight`` =
    ``weight_orig / sigma``, ``u`` and ``v`` advanced by one power
    iteration."""

    def __call__(self, module: nn.Module, inputs) -> None:
        module.weight = spectral_normalize(module.weight_orig, module.weight_u,
                                           store=(module.weight_u, module.weight_v))


def spectral_norm(module: nn.Module) -> nn.Module:
    """``torch.nn.utils.spectral_norm(module)``: ``weight`` becomes the
    parameter ``weight_orig`` and the unit buffers ``weight_u`` (O,) and
    ``weight_v`` (I x taps,), drawn from PyTorch's generator."""
    w = module.weight
    del module._parameters["weight"]
    o, rest = w.shape[0], w[0].numel()
    module.register_parameter("weight_orig", nn.Parameter(w.data))
    module.register_buffer("weight_u", _normalize(w.new_empty(o).normal_(0, 1)))
    module.register_buffer("weight_v", _normalize(w.new_empty(rest).normal_(0, 1)))
    module.weight = w.data
    module.register_forward_pre_hook(_SpectralNorm())
    return module


def _lrelu_stack(convs: nn.ModuleList, post: nn.Module, x: torch.Tensor,
                 slope: float) -> Tuple[torch.Tensor, Features]:
    fmap = []
    for conv in convs:
        x = F.leaky_relu(conv(x), slope)
        fmap.append(x)
    x = post(x)
    fmap.append(x)
    return torch.flatten(x, 1, -1), fmap


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, vt: VocoderTrainConfig):
        super().__init__()
        self.period, self.slope = period, vt.negative_slope
        k, pk = vt.mpd_kernel_size, vt.post_kernel_size
        chans = (1,) + tuple(vt.mpd_channels)
        self.convs = nn.ModuleList(
            weight_norm(nn.Conv2d(ci, co, (k, 1), (s, 1), padding=((k - 1) // 2, 0)))
            for ci, co, s in zip(chans[:-1], chans[1:], vt.mpd_strides))
        self.conv_post = weight_norm(nn.Conv2d(chans[-1], 1, (pk, 1), 1, padding=((pk - 1) // 2, 0)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Features]:
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), "reflect")
        return _lrelu_stack(self.convs, self.conv_post, x.view(b, c, -1, self.period), self.slope)


class ScaleDiscriminator(nn.Module):
    def __init__(self, vt: VocoderTrainConfig, spectral: bool = False):
        super().__init__()
        self.slope = vt.negative_slope
        norm = spectral_norm if spectral else weight_norm
        chans = (1,) + tuple(vt.msd_channels)
        self.convs = nn.ModuleList(
            norm(nn.Conv1d(ci, co, k, s, groups=g, padding=(k - 1) // 2))
            for ci, co, k, s, g in zip(chans[:-1], chans[1:], vt.msd_kernel_sizes, vt.msd_strides,
                                       vt.msd_groups))
        pk = vt.post_kernel_size
        self.conv_post = norm(nn.Conv1d(chans[-1], 1, pk, 1, padding=(pk - 1) // 2))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Features]:
        return _lrelu_stack(self.convs, self.conv_post, x, self.slope)


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, vt: VocoderTrainConfig):
        super().__init__()
        self.discriminators = nn.ModuleList(PeriodDiscriminator(p, vt) for p in vt.mpd_periods)

    def inputs(self, y: torch.Tensor) -> List[torch.Tensor]:
        return [y] * len(self.discriminators)


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, vt: VocoderTrainConfig):
        super().__init__()
        self.discriminators = nn.ModuleList(
            ScaleDiscriminator(vt, spectral=vt.msd_spectral_norm_first and i == 0)
            for i in range(vt.msd_scales))
        self.pool = nn.AvgPool1d(4, 2, padding=2)

    def inputs(self, y: torch.Tensor) -> List[torch.Tensor]:
        out = [y]
        for _ in range(len(self.discriminators) - 1):
            out.append(self.pool(out[-1]))
        return out


class Discriminator(nn.Module):
    """The two discriminators as one module (the ``discriminator`` of a
    training checkpoint): ``mpd.discriminators.{i}`` and
    ``msd.discriminators.{i}``."""

    def __init__(self, vt: VocoderTrainConfig):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(vt)
        self.msd = MultiScaleDiscriminator(vt)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, real_graph: bool = True):
        """(scores of y, scores of y_hat, feature maps of y, of y_hat), one
        entry per sub-discriminator, the period ones first. Each
        sub-discriminator takes y, then y_hat (the order of jik876's
        ``mpd(y, y_hat)`` and ``msd(y, y_hat)``, which the spectral norm's
        ``u`` follows). ``real_graph=False`` runs y's passes without
        autograd: the generator's update needs their values alone."""
        real, fake, fmap_r, fmap_g = [], [], [], []
        for group in (self.mpd, self.msd):
            for d, yr, yg in zip(group.discriminators, group.inputs(y), group.inputs(y_hat)):
                with torch.set_grad_enabled(real_graph and torch.is_grad_enabled()):
                    r, fr = d(yr)
                g, fg = d(yg)
                real.append(r)
                fake.append(g)
                fmap_r.append(fr)
                fmap_g.append(fg)
        return real, fake, fmap_r, fmap_g

    def samples(self, t: int) -> int:
        """The samples its sub-discriminators take from one wav of ``t``
        samples: each period one's padded to a multiple of its period, each
        scale one's at its own pooled length."""
        n = sum(-(-t // d.period) * d.period for d in self.mpd.discriminators)
        for _ in self.msd.discriminators:
            n += t
            t = (t + 2 * 2 - 4) // 2 + 1
        return n


def discriminator_loss(real: List[torch.Tensor], fake: List[torch.Tensor]) -> torch.Tensor:
    """Least squares: the sum over sub-discriminators of mean((1 - D(y))^2)
    + mean(D(y_hat)^2)."""
    return sum(torch.mean((1 - r) ** 2) + torch.mean(g ** 2) for r, g in zip(real, fake))


def generator_adv_loss(fake: List[torch.Tensor]) -> torch.Tensor:
    """The sum over sub-discriminators of mean((1 - D(y_hat))^2)."""
    return sum(torch.mean((1 - g) ** 2) for g in fake)


def feature_loss(fmap_r: List[Features], fmap_g: List[Features]) -> torch.Tensor:
    """The sum over sub-discriminators and their feature maps of
    mean|f(y) - f(y_hat)| (jik876's ``feature_loss`` before its factor 2,
    which is the configuration's ``lambda_fm``)."""
    return sum(torch.mean(torch.abs(r - g)) for dr, dg in zip(fmap_r, fmap_g) for r, g in zip(dr, dg))
