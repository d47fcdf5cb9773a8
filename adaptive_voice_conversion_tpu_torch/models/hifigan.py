"""The HiFi-GAN V1 generator (Kong, Kim and Bae, arXiv:2010.05646) as a
second vocoder: a normalised mel in, a wav out.

The module tree is ParallelWaveGAN's ``HiFiGANGenerator``
(kan-bayashi/ParallelWaveGAN), so a checkpoint of that project's generator
loads with ``load_state_dict(strict=True)`` once its weight norm is folded
(models/weights.py ``load_generator``): ``input_conv``, ``upsamples.{i}``
(LeakyReLU, ConvTranspose1d), ``blocks.{i*n+j}.convs1.{m}`` /
``convs2.{m}`` (LeakyReLU, Conv1d), ``output_conv`` (LeakyReLU(0.01),
Conv1d, Tanh). The configuration is core/config.py ``VocoderConfig``.

``generate`` is the forward pass on a padded batch. With ``lengths`` it is
length-masked: every row is zeroed past its own length at the input, after
every convolution and after each transposed convolution (past s times the
length at that stage). The convolutions pad with zeros, so each row then
computes what it computes alone at its true length, and its wav is zero
past hop x its length. This is the guarantee models/masked.py gives the
AdaIN model, for the ragged batches of ``Inferencer.convert_grid``.

Its plain reference, which the tests hold it against, is the benchmark's
``vc_bench/reference/hifigan.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import VocoderConfig
from ..utils.profiling import count

# the slope of the LeakyReLU before the output convolution (PyTorch's
# default, as ParallelWaveGAN and jik876/hifi-gan have it)
OUTPUT_SLOPE = 0.01


def _same(k: int, d: int = 1) -> int:
    return (k - 1) // 2 * d


class ResidualBlock(nn.Module):
    """For each dilation d: ``x = x + convs2(lrelu(convs1_d(lrelu(x))))``."""

    def __init__(self, channels: int, kernel_size: int, dilations, slope: float):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(slope), nn.Conv1d(channels, channels, kernel_size, dilation=d,
                                                         padding=_same(kernel_size, d)))
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(slope), nn.Conv1d(channels, channels, kernel_size,
                                                         padding=_same(kernel_size)))
            for _ in dilations)
        self.slope = slope

    def masked(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The block on x, which is zero past each row's length under
        ``mask`` (None: no padding), keeping it so."""
        for c1, c2 in zip(self.convs1, self.convs2):
            t = _mask(c1[1](F.leaky_relu(x, self.slope)), mask)
            t = _mask(c2[1](F.leaky_relu(t, self.slope, inplace=True)), mask)
            x = t.add_(x)
        return x


def _mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if mask is None else x.mul_(mask)


class Generator(nn.Module):
    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        c, k, slope = cfg.channels, cfg.kernel_size, cfg.negative_slope
        self.cfg = cfg
        self.hop = math.prod(cfg.upsample_scales)
        self.n_blocks = len(cfg.resblock_kernel_sizes)
        self.input_conv = nn.Conv1d(cfg.in_channels, c, k, padding=_same(k))
        self.upsamples = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for i, (s, ku) in enumerate(zip(cfg.upsample_scales, cfg.upsample_kernel_sizes)):
            self.upsamples.append(nn.Sequential(
                nn.LeakyReLU(slope),
                nn.ConvTranspose1d(c >> i, c >> (i + 1), ku, s, padding=s // 2 + s % 2,
                                   output_padding=s % 2)))
            for kb, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
                self.blocks.append(ResidualBlock(c >> (i + 1), kb, dils, slope))
        c_last = c >> len(cfg.upsample_scales)
        self.output_conv = nn.Sequential(
            nn.LeakyReLU(OUTPUT_SLOPE), nn.Conv1d(c_last, cfg.out_channels, k, padding=_same(k)), nn.Tanh())

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """ParallelWaveGAN's forward: (B, in_channels, T) -> (B, out, hop x T)."""
        return self._run(c, None)

    def generate(self, mel: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Normalised mels (B, T, in_channels) -> wavs (B, hop x T). With
        ``lengths`` ((B,) frames, on the mels' device) the forward is
        length-masked (the module docstring): row b equals the generator on
        its first ``lengths[b]`` frames alone, and is zero after them.
        Counts ``voc.samples`` and ``voc.computed_samples``
        (utils/profiling.py) while a profiler records."""
        b, t, _ = mel.shape
        computed = b * t * self.hop
        count("voc.computed_samples", computed)
        count("voc.samples", computed if lengths is None else (lambda: lengths.sum() * self.hop))
        return self._run(mel.transpose(1, 2), lengths)[:, 0]

    def _run(self, x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        t = x.shape[-1]

        def mask_at(scale: int) -> Optional[torch.Tensor]:
            if lengths is None:
                return None
            steps = torch.arange(t * scale, device=x.device)
            return (steps[None, :] < (lengths * scale)[:, None]).to(x.dtype)[:, None, :]

        mask = mask_at(1)
        if mask is not None:
            x = x * mask
        x = _mask(self.input_conv(x), mask)
        scale = 1
        for i, s in enumerate(cfg.upsample_scales):
            scale *= s
            mask = mask_at(scale)
            up = self.upsamples[i][1]
            x = _mask(up(F.leaky_relu(x, cfg.negative_slope)), mask)
            total = None
            for block in self.blocks[i * self.n_blocks : (i + 1) * self.n_blocks]:
                y = block.masked(x, mask)
                total = y if total is None else total.add_(y)
            x = total.div_(self.n_blocks)
        x = self.output_conv[1](F.leaky_relu(x, OUTPUT_SLOPE))
        return _mask(torch.tanh_(x), mask)
