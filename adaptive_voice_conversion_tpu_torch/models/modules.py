"""AdaIN-VC modules: SpeakerEncoder, ContentEncoder, Decoder.

``nn.Module``s on (B, C, T) activations. Their attribute names are the
reference's module tree, so their state_dict keys are the reference
checkpoint's keys (``speaker_encoder.conv_bank.{i}``,
``decoder.conv_affine_layers.{2l}``, ...) and ``load_state_dict(strict=True)``
loads a reference ``.ckpt`` as it is. Layers hold the weights; the forward
passes run the ops in ``ops/`` (reflect-pad convs with the reference's
even-kernel asymmetry, the pair-fused conv bank).

Dropout is left out: its rate is 0 at inference. Spectral norm
(``sn=True``) belongs to the training slice and raises here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import ContentEncoderConfig, DecoderConfig, SpeakerEncoderConfig
from ..ops.conv import conv1d, conv_bank, dense
from ..ops.norm import act_fn, adain, instance_norm_time
from ..ops.resample import (
    avg_pool_time_ceil,
    global_avg_pool_time,
    pixel_shuffle_time,
    upsample_nearest_time,
)


def bank_kernel_sizes(cfg) -> list:
    """Conv bank kernels: range(bank_scale, bank_size + 1, bank_scale)."""
    return list(range(cfg.bank_scale, cfg.bank_size + 1, cfg.bank_scale))


def _conv(layer: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    return conv1d(x, layer.weight, layer.bias, stride=layer.stride[0])


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return dense(x, layer.weight, layer.bias)


def _bank(layers: nn.ModuleList, x, kernel_sizes, act) -> torch.Tensor:
    return conv_bank(
        x, [c.weight for c in layers], [c.bias for c in layers], kernel_sizes, act
    )


def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every Conv1d/Linear weight and bias from U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), PyTorch's default for these layers and the JAX
    package's init, from ``generator`` so a seed fixes the weights."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)


class SpeakerEncoder(nn.Module):
    """(B, c_in, T) -> speaker embedding (B, c_out)."""

    def __init__(self, cfg: SpeakerEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.kernel_sizes = bank_kernel_sizes(cfg)
        self.act = act_fn(cfg.act)
        c_h = cfg.c_h
        self.conv_bank = nn.ModuleList(
            [nn.Conv1d(cfg.c_in, cfg.c_bank, k) for k in self.kernel_sizes]
        )
        in_channels = cfg.c_bank * len(self.kernel_sizes) + cfg.c_in
        self.in_conv_layer = nn.Conv1d(in_channels, c_h, 1)
        self.first_conv_layers = nn.ModuleList(
            [nn.Conv1d(c_h, c_h, cfg.kernel_size) for _ in range(cfg.n_conv_blocks)]
        )
        self.second_conv_layers = nn.ModuleList(
            [nn.Conv1d(c_h, c_h, cfg.kernel_size, stride=sub)
             for sub in cfg.subsample[: cfg.n_conv_blocks]]
        )
        self.first_dense_layers = nn.ModuleList(
            [nn.Linear(c_h, c_h) for _ in range(cfg.n_dense_blocks)]
        )
        self.second_dense_layers = nn.ModuleList(
            [nn.Linear(c_h, c_h) for _ in range(cfg.n_dense_blocks)]
        )
        self.output_layer = nn.Linear(c_h, cfg.c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.act
        out = _bank(self.conv_bank, x, self.kernel_sizes, act)
        out = act(_conv(self.in_conv_layer, out))
        for first, second in zip(self.first_conv_layers, self.second_conv_layers):
            y = act(_conv(first, out))
            y = act(_conv(second, y))
            sub = second.stride[0]
            if sub > 1:
                out = avg_pool_time_ceil(out, sub)
            out = y + out
        out = global_avg_pool_time(out)
        for first, second in zip(self.first_dense_layers, self.second_dense_layers):
            out = act(_dense(second, act(_dense(first, out)))) + out
        return _dense(self.output_layer, out)


class ContentEncoder(nn.Module):
    """(B, c_in, T) -> (mu, log_sigma), each (B, c_out, T/prod(subsample))."""

    def __init__(self, cfg: ContentEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.kernel_sizes = bank_kernel_sizes(cfg)
        self.act = act_fn(cfg.act)
        c_h = cfg.c_h
        self.conv_bank = nn.ModuleList(
            [nn.Conv1d(cfg.c_in, cfg.c_bank, k) for k in self.kernel_sizes]
        )
        in_channels = cfg.c_bank * len(self.kernel_sizes) + cfg.c_in
        self.in_conv_layer = nn.Conv1d(in_channels, c_h, 1)
        self.first_conv_layers = nn.ModuleList(
            [nn.Conv1d(c_h, c_h, cfg.kernel_size) for _ in range(cfg.n_conv_blocks)]
        )
        self.second_conv_layers = nn.ModuleList(
            [nn.Conv1d(c_h, c_h, cfg.kernel_size, stride=sub)
             for sub in cfg.subsample[: cfg.n_conv_blocks]]
        )
        self.mean_layer = nn.Conv1d(c_h, cfg.c_out, 1)
        self.std_layer = nn.Conv1d(c_h, cfg.c_out, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        act = self.act
        out = _bank(self.conv_bank, x, self.kernel_sizes, act)
        # instance norm before every activation
        out = act(instance_norm_time(_conv(self.in_conv_layer, out)))
        for first, second in zip(self.first_conv_layers, self.second_conv_layers):
            y = act(instance_norm_time(_conv(first, out)))
            y = act(instance_norm_time(_conv(second, y)))
            sub = second.stride[0]
            if sub > 1:
                out = avg_pool_time_ceil(out, sub)
            out = y + out
        return _conv(self.mean_layer, out), _conv(self.std_layer, out)


class Decoder(nn.Module):
    """z (B, c_in, T), cond (B, c_cond) -> (B, c_out, T*prod(upsample))."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        if cfg.sn:
            raise NotImplementedError(
                "Decoder(sn=True): spectral norm is not ported yet"
            )
        self.cfg = cfg
        self.act = act_fn(cfg.act)
        c_h = cfg.c_h
        self.in_conv_layer = nn.Conv1d(cfg.c_in, c_h, 1)
        self.first_conv_layers = nn.ModuleList(
            [nn.Conv1d(c_h, c_h, cfg.kernel_size) for _ in range(cfg.n_conv_blocks)]
        )
        self.second_conv_layers = nn.ModuleList(
            [nn.Conv1d(c_h, c_h * up, cfg.kernel_size)
             for up in cfg.upsample[: cfg.n_conv_blocks]]
        )
        self.conv_affine_layers = nn.ModuleList(
            [nn.Linear(cfg.c_cond, c_h * 2) for _ in range(2 * cfg.n_conv_blocks)]
        )
        self.out_conv_layer = nn.Conv1d(c_h, cfg.c_out, 1)

    def forward(self, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        act = self.act
        out = act(instance_norm_time(_conv(self.in_conv_layer, z)))
        for l, up in enumerate(self.cfg.upsample[: self.cfg.n_conv_blocks]):
            y = instance_norm_time(_conv(self.first_conv_layers[l], out))
            y = act(adain(y, _dense(self.conv_affine_layers[2 * l], cond)))
            y = _conv(self.second_conv_layers[l], y)
            if up > 1:
                y = pixel_shuffle_time(y, up)
            y = instance_norm_time(y)
            y = act(adain(y, _dense(self.conv_affine_layers[2 * l + 1], cond)))
            out = y + (upsample_nearest_time(out, up) if up > 1 else out)
        return _conv(self.out_conv_layer, out)
