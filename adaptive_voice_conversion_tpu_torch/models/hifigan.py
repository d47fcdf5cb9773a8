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

On the CPU the masks, LeakyReLUs and sums between the convolutions are
PyTorch's elementwise ops. On a CUDA tensor each junction between two
convolutions is one launch of the kernel in kernels/hifigan.py, which also
adds the convolution's bias (``_run_fused``), with the same arithmetic, so
the wavs are the same bit for bit. The kernel has no backward: where autograd
records (the input or a weight needs a gradient), the generator runs the
eager ops on the card too, its differentiable path.

Training (train/vocoder.py) keeps every convolution weight-normed, as
ParallelWaveGAN and jik876/hifi-gan train it: ``apply_weight_norm`` holds
each weight as ``weight_g`` / ``weight_v`` (``torch.nn.utils.weight_norm``,
``dim=0``), so a training checkpoint's generator loads
through models/weights.py ``load_generator``, which folds the pairs.

Its plain reference, which the tests hold it against, is the benchmark's
``vc_bench/reference/hifigan.py``.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import VocoderConfig
from ..kernels.hifigan import J0, J1, J2, J3, apply_mask, junction, length_mask
from ..utils.profiling import count

# the slope of the LeakyReLU before the output convolution (PyTorch's
# default, as ParallelWaveGAN and jik876/hifi-gan have it)
OUTPUT_SLOPE = 0.01


def weight_norm(module: nn.Module) -> nn.Module:
    """``torch.nn.utils.weight_norm(module)`` (``dim=0``). Its successor,
    ``torch.nn.utils.parametrizations.weight_norm``, stores the pair under
    other keys, which ParallelWaveGAN's checkpoints and ``load_generator``
    do not read, so the deprecation warning is silenced here."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return nn.utils.weight_norm(module)


def apply_weight_norm(root: nn.Module) -> nn.Module:
    """``weight_norm`` on every convolution under ``root`` (ParallelWaveGAN's
    ``apply_weight_norm``)."""
    for m in list(root.modules()):
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Conv2d)) and "weight" in m._parameters:
            weight_norm(m)
    return root


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
            t = apply_mask(c1[1](F.leaky_relu(x, self.slope)), mask)
            t = apply_mask(c2[1](F.leaky_relu(t, self.slope, inplace=True)), mask)
            x = t.add_(x)
        return x

    def fused(self, x, a, lengths, scale, total, block, n_blocks, next_slope):
        """``masked`` through the junction kernel, on the stage's input x and
        its LeakyReLU a, the block's output folded into the stage's ``total``
        (kernels/hifigan.py ``J3``)."""
        last = len(self.convs1) - 1
        for k, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            c = _unbiased(c1[1], a)
            del a  # dead once read: the stage keeps its own reference
            c = _unbiased(c2[1], junction(J1, c, c1[1].bias, lengths, scale, self.slope))
            if k < last:
                x, a = junction(J2, c, c2[1].bias, lengths, scale, self.slope, x=x)
        return junction(J3, c, c2[1].bias, lengths, scale, next_slope, x=x, total=total, block=block,
                        n_blocks=n_blocks)


def _unbiased(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` without the bias, which the junction after it adds:
    cuDNN sees the call it sees with the bias, which PyTorch adds to its
    output in a pass of its own. The module's forward pre-hooks run first, as
    in a call: ``torch.nn.utils.weight_norm``'s computes the weight there."""
    for hook in conv._forward_pre_hooks.values():
        hook(conv, (x,))
    if isinstance(conv, nn.ConvTranspose1d):
        return F.conv_transpose1d(x, conv.weight, None, conv.stride, conv.padding, conv.output_padding,
                                  conv.groups, conv.dilation)
    return F.conv1d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation, conv.groups)


class Generator(nn.Module):
    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        c, k, slope = cfg.channels, cfg.kernel_size, cfg.negative_slope
        self.cfg = cfg
        self.hop = math.prod(cfg.upsample_scales)
        self.n_blocks = len(cfg.resblock_kernel_sizes)
        # the launches between two convolutions on the fused path: after
        # input_conv, and in each stage after the upsample and each convolution
        # of its blocks
        self.junctions = 1 + len(cfg.upsample_scales) * (1 + 2 * sum(map(len, cfg.resblock_dilations)))
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
        Counts ``voc.samples``, ``voc.computed_samples``, ``voc.junctions``
        and ``voc.fused_junctions`` (the junction kernel's launches in the
        call: 0 on the CPU) (utils/profiling.py) while a profiler records."""
        b, t, _ = mel.shape
        computed = b * t * self.hop
        count("voc.computed_samples", computed)
        count("voc.samples", computed if lengths is None else (lambda: lengths.sum() * self.hop))
        launches = junction.launches
        wav = self._run(mel.transpose(1, 2), lengths)[:, 0]
        count("voc.junctions", self.junctions)
        count("voc.fused_junctions", junction.launches - launches)
        return wav

    def _run(self, x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        fused = x.is_cuda and not self._records_grad(x)
        return (self._run_fused if fused else self._run_eager)(x, lengths)

    def _records_grad(self, x: torch.Tensor) -> bool:
        """Whether autograd records this call: grad mode on, and the input or
        a parameter needs a gradient."""
        return torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))

    def _run_eager(self, x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """The forward in PyTorch ops: the CPU's path, and the differentiable
        one on the card."""
        cfg = self.cfg
        t = x.shape[-1]
        mask_at = lambda scale: length_mask(lengths, t * scale, scale, x.dtype)
        mask = mask_at(1)
        if mask is not None:
            x = x * mask
        x = apply_mask(self.input_conv(x), mask)
        scale = 1
        for i, s in enumerate(cfg.upsample_scales):
            scale *= s
            mask = mask_at(scale)
            up = self.upsamples[i][1]
            x = apply_mask(up(F.leaky_relu(x, cfg.negative_slope)), mask)
            total = None
            for block in self.blocks[i * self.n_blocks : (i + 1) * self.n_blocks]:
                y = block.masked(x, mask)
                total = y if total is None else total.add_(y)
            x = total.div_(self.n_blocks)
        x = self.output_conv[1](F.leaky_relu(x, OUTPUT_SLOPE))
        return apply_mask(torch.tanh_(x), mask)

    def _run_fused(self, x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """``_run_eager`` with each junction between two convolutions one
        ``junction`` (kernels/hifigan.py), which adds the convolution's bias:
        the input's mask, and the output convolution, tanh and mask, stay
        PyTorch's."""
        cfg, slope, t = self.cfg, self.cfg.negative_slope, x.shape[-1]
        mask = length_mask(lengths, t, 1, x.dtype)
        if mask is not None:
            x = x * mask
        a = junction(J1, _unbiased(self.input_conv, x), self.input_conv.bias, lengths, 1, slope)
        scale, n = 1, len(cfg.upsample_scales)
        for i, s in enumerate(cfg.upsample_scales):
            scale *= s
            up = self.upsamples[i][1]
            x, a = junction(J0, _unbiased(up, a), up.bias, lengths, scale, slope)
            next_slope = OUTPUT_SLOPE if i == n - 1 else slope
            total = None
            for j, block in enumerate(self.blocks[i * self.n_blocks : (i + 1) * self.n_blocks]):
                total = block.fused(x, a, lengths, scale, total, j, self.n_blocks, next_slope)
            a = total
        x = self.output_conv[1](a)
        return apply_mask(torch.tanh_(x), length_mask(lengths, t * scale, scale, x.dtype))
