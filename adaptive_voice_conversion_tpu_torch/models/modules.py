"""AdaIN-VC modules: SpeakerEncoder, ContentEncoder, Decoder.

``nn.Module``s on (B, C, T) activations. Their attribute names are the
reference's module tree, so their state_dict keys are the reference
checkpoint's keys (``speaker_encoder.conv_bank.{i}``,
``decoder.conv_affine_layers.{2l}``, ...) and ``load_state_dict(strict=True)``
loads a reference ``.ckpt`` as it is. Layers hold the weights; the forward
passes run the ops in ``ops/`` (reflect-pad convs with the reference's
even-kernel asymmetry, the pair-fused conv bank).

Training adds three things. *Dropout* is active only when the module is in
training mode, its rate is above 0 and a ``torch.Generator`` is passed in;
the global generator is never used. *compute_dtype* is handed to every conv
and dense op (ops/conv.py). *Spectral norm* (``DecoderConfig.sn``): every
decoder layer is a ``SpectralNormConv1d`` / ``SpectralNormLinear`` holding
the parameter ``weight_orig`` and the buffers ``weight_u`` and ``weight_v``
(the keys of a reference ``sn=True`` checkpoint). Its ``weight`` property is
``weight_orig / sigma``, with one power iteration from the stored ``u``
under ``no_grad`` and ``sigma = u'^T W v`` differentiable through ``W``.
The forward never moves the stored ``u``: ``spectral_norm_update`` advances
it, and the training step calls that once per step, on the weights the step
started from.
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

SN_EPS = 1e-12


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + SN_EPS)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``w / sigma`` for a weight (O, ...) and its stored vector ``u`` (O,):
    one power iteration on the detached (O, -1) matrix, then
    ``sigma = u'^T W v`` with the gradient through ``W``, so d(w/sigma)/dw
    keeps the ``-W u' v^T / sigma^2`` term."""
    wm = w.reshape(w.shape[0], -1).float()
    with torch.no_grad():
        v = _normalize(wm.t() @ u)
        u2 = _normalize(wm @ v)
    sigma = torch.dot(u2, wm @ v)
    return w / sigma.to(w.dtype)


class _SpectralNormLayer(nn.Module):
    """A layer whose ``weight`` is ``weight_orig`` spectrally normalised."""

    def __init__(self, weight_shape: tuple):
        super().__init__()
        c_out = weight_shape[0]
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.register_buffer("weight_u", torch.zeros(c_out))
        self.register_buffer("weight_v", torch.zeros(math.prod(weight_shape[1:])))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.weight_orig[0].numel())
        with torch.no_grad():
            self.weight_orig.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)
            self.weight_u.copy_(_normalize(self.weight_u.normal_(generator=generator)))
            self.weight_v.copy_(_normalize(self._matrix().t() @ self.weight_u))

    def _matrix(self) -> torch.Tensor:
        return self.weight_orig.detach().reshape(self.weight_orig.shape[0], -1).float()

    @property
    def weight(self) -> torch.Tensor:
        return spectral_normalize(self.weight_orig, self.weight_u)

    @torch.no_grad()
    def power_iteration(self) -> None:
        """Advance the stored ``u`` (and ``v``) by one power iteration on
        the current ``weight_orig``."""
        wm = self._matrix()
        v = _normalize(wm.t() @ self.weight_u)
        self.weight_v.copy_(v)
        self.weight_u.copy_(_normalize(wm @ v))


class SpectralNormConv1d(_SpectralNormLayer):
    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1):
        super().__init__((c_out, c_in, kernel_size))
        self.stride = (stride,)


class SpectralNormLinear(_SpectralNormLayer):
    def __init__(self, c_in: int, c_out: int):
        super().__init__((c_out, c_in))


def spectral_norm_update(module: nn.Module) -> None:
    """One power iteration on every spectral-norm layer under ``module``.
    The training step calls it once per step, before the optimiser changes
    the weights; nothing else moves ``weight_u``."""
    for m in module.modules():
        if isinstance(m, _SpectralNormLayer):
            m.power_iteration()


def bank_kernel_sizes(cfg) -> list:
    """Conv bank kernels: range(bank_scale, bank_size + 1, bank_scale)."""
    return list(range(cfg.bank_scale, cfg.bank_size + 1, cfg.bank_scale))


def _conv(layer, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``layer.weight`` is the parameter of an ``nn.Conv1d`` and the
    normalised weight of a ``SpectralNormConv1d``."""
    return conv1d(
        x, layer.weight, layer.bias, stride=layer.stride[0], compute_dtype=compute_dtype
    )


def _dense(layer, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    return dense(x, layer.weight, layer.bias, compute_dtype=compute_dtype)


def _bank(layers: nn.ModuleList, x, kernel_sizes, act, compute_dtype=None) -> torch.Tensor:
    return conv_bank(
        x, [c.weight for c in layers], [c.bias for c in layers], kernel_sizes, act,
        compute_dtype=compute_dtype,
    )


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator], training: bool
) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (on x's
    device). The identity in eval mode, at rate 0, or without a generator."""
    if not training or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every Conv1d/Linear weight and bias from U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), PyTorch's default for these layers and the JAX
    package's init, from ``generator`` so a seed fixes the weights. A
    spectral-norm layer also draws its ``weight_u`` (a unit normal vector)
    from the same generator."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _SpectralNormLayer):
                m.reset_parameters(generator)
            elif isinstance(m, (nn.Conv1d, nn.Linear)):
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

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        act, cd = self.act, compute_dtype
        drop = lambda y: dropout(y, self.cfg.dropout_rate, generator, self.training)
        out = _bank(self.conv_bank, x, self.kernel_sizes, act, cd)
        out = act(_conv(self.in_conv_layer, out, cd))
        for first, second in zip(self.first_conv_layers, self.second_conv_layers):
            y = drop(act(_conv(first, out, cd)))
            y = drop(act(_conv(second, y, cd)))
            sub = second.stride[0]
            if sub > 1:
                out = avg_pool_time_ceil(out, sub)
            out = y + out
        out = global_avg_pool_time(out)
        for first, second in zip(self.first_dense_layers, self.second_dense_layers):
            y = drop(act(_dense(first, out, cd)))
            out = drop(act(_dense(second, y, cd))) + out
        return _dense(self.output_layer, out, cd)


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

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        act, cd = self.act, compute_dtype
        drop = lambda y: dropout(y, self.cfg.dropout_rate, generator, self.training)
        out = _bank(self.conv_bank, x, self.kernel_sizes, act, cd)
        # instance norm before every activation
        out = drop(act(instance_norm_time(_conv(self.in_conv_layer, out, cd))))
        for first, second in zip(self.first_conv_layers, self.second_conv_layers):
            y = drop(act(instance_norm_time(_conv(first, out, cd))))
            y = drop(act(instance_norm_time(_conv(second, y, cd))))
            sub = second.stride[0]
            if sub > 1:
                out = avg_pool_time_ceil(out, sub)
            out = y + out
        return _conv(self.mean_layer, out, cd), _conv(self.std_layer, out, cd)


class Decoder(nn.Module):
    """z (B, c_in, T), cond (B, c_cond) -> (B, c_out, T*prod(upsample))."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.act = act_fn(cfg.act)
        c_h = cfg.c_h
        # with sn, every layer of the decoder carries the power-iteration state
        conv = SpectralNormConv1d if cfg.sn else nn.Conv1d
        linear = SpectralNormLinear if cfg.sn else nn.Linear
        self.in_conv_layer = conv(cfg.c_in, c_h, 1)
        self.first_conv_layers = nn.ModuleList(
            [conv(c_h, c_h, cfg.kernel_size) for _ in range(cfg.n_conv_blocks)]
        )
        self.second_conv_layers = nn.ModuleList(
            [conv(c_h, c_h * up, cfg.kernel_size)
             for up in cfg.upsample[: cfg.n_conv_blocks]]
        )
        self.conv_affine_layers = nn.ModuleList(
            [linear(cfg.c_cond, c_h * 2) for _ in range(2 * cfg.n_conv_blocks)]
        )
        self.out_conv_layer = conv(c_h, cfg.c_out, 1)

    def forward(
        self, z: torch.Tensor, cond: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        act, cd = self.act, compute_dtype
        drop = lambda y: dropout(y, self.cfg.dropout_rate, generator, self.training)
        out = drop(act(instance_norm_time(_conv(self.in_conv_layer, z, cd))))
        for l, up in enumerate(self.cfg.upsample[: self.cfg.n_conv_blocks]):
            y = instance_norm_time(_conv(self.first_conv_layers[l], out, cd))
            y = drop(act(adain(y, _dense(self.conv_affine_layers[2 * l], cond, cd))))
            y = _conv(self.second_conv_layers[l], y, cd)
            if up > 1:
                y = pixel_shuffle_time(y, up)
            y = instance_norm_time(y)
            y = drop(act(adain(y, _dense(self.conv_affine_layers[2 * l + 1], cond, cd))))
            out = y + (upsample_nearest_time(out, up) if up > 1 else out)
        return _conv(self.out_conv_layer, out, cd)
