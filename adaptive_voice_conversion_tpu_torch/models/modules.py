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

*Tensor parallelism* (parallel/tp.py): ``shard_params_tp`` gives each layer
it splits over the model axis a ``tp`` attribute, and the same forward then
runs on this rank's channels. A column-parallel layer (output channels
split) takes its full input through Megatron's ``copy`` and its output is
gathered back into the one-process channel order, except inside a Megatron
pair: there the first layer's channels stay on their rank through the
instance norm, the AdaIN affine, the activation and dropout (masks drawn
at the full shape and sliced), and the second, row-parallel layer (input
channels split) sums its partial products over the model axis (``reduce``)
before it adds its replicated bias. Spectral norm takes its power iteration
and ``sigma`` over the whole matrix. A layer without ``tp`` runs as in one
process, bit for bit.
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


def _normalize(x: torch.Tensor, tp=None, phase: str = "forward") -> torch.Tensor:
    """``x / |x|``; with ``tp``, x is this rank's block of a vector split over
    the model axis and the squares are summed over it."""
    if tp is None:
        return x / (torch.linalg.vector_norm(x) + SN_EPS)
    return x / (tp.axis.sum(x.square().sum(), phase).sqrt() + SN_EPS)


def _sn_matrix(w: torch.Tensor) -> torch.Tensor:
    """The (O, -1) matrix of a weight, in f32 or wider."""
    return w.reshape(w.shape[0], -1).to(torch.promote_types(w.dtype, torch.float32))


def _power_iteration(wm: torch.Tensor, u: torch.Tensor, tp=None, phase: str = "forward"):
    """``(v, u2)``: ``v = W^T u / |.|``, ``u2 = W v / |.|``. With a column
    split ``wm`` and ``u`` are this rank's rows and ``v`` comes out whole;
    with a row split ``wm`` and ``v`` are this rank's block of the flattened
    ``(in, k)`` columns and ``u`` is whole."""
    col = tp is not None and tp.kind == "column"
    row = tp is not None and tp.kind == "row"
    wtu = wm.t() @ u
    v = _normalize(tp.axis.sum(wtu, phase) if col else wtu, tp if row else None, phase)
    wv = wm @ v
    u2 = _normalize(tp.axis.sum(wv, phase) if row else wv, tp if col else None, phase)
    return v, u2


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, tp=None, store=None) -> torch.Tensor:
    """``w / sigma`` for a weight (O, ...) and its stored vector ``u`` (O,):
    one power iteration on the detached (O, -1) matrix, then
    ``sigma = u'^T W v`` with the gradient through ``W``, so d(w/sigma)/dw
    keeps the ``-W u' v^T / sigma^2`` term. With ``tp`` (a layer split over
    the model axis) ``w`` is this rank's shard and ``sigma`` is the whole
    matrix's: the ranks' partial dot products go through ``reduce``, and
    since every rank divides its own shard by it, ``sigma`` then goes
    through ``copy``, whose backward sums its gradient over the ranks.

    ``store``, a pair of buffers (u, v), takes the iteration's ``u'`` and
    ``v``: the schedule of ``torch.nn.utils.spectral_norm`` in training mode,
    which advances ``u`` in every forward (models/hifigan_disc.py). The
    decoder passes none, and advances ``u`` once a step instead
    (``spectral_norm_update``)."""
    wm = _sn_matrix(w)
    with torch.no_grad():
        v, u2 = _power_iteration(wm, u, tp)
        if store is not None:
            store[0].copy_(u2)
            store[1].copy_(v)
    sigma = torch.dot(u2, wm @ v)
    if tp is not None:
        sigma = tp.axis.copy(tp.axis.reduce(sigma))
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
        return _sn_matrix(self.weight_orig.detach())

    @property
    def weight(self) -> torch.Tensor:
        return spectral_normalize(self.weight_orig, self.weight_u, _split(self))

    @torch.no_grad()
    def power_iteration(self) -> None:
        """Advance the stored ``u`` (and ``v``) by one power iteration on
        the current ``weight_orig`` (this rank's shards of them under
        tensor parallelism)."""
        v, u = _power_iteration(self._matrix(), self.weight_u, _split(self), "update")
        self.weight_v.copy_(v)
        self.weight_u.copy_(u)


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


def _split(layer):
    """The layer's place on the model axis (parallel/tp.py ``Split``), or
    None when it is whole on this rank."""
    return getattr(layer, "tp", None)


def _channels(layer, y: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """Where ``y``, the output ``layer`` left on this rank (``full=False``),
    sits in the full channel axis: ``(lo, hi, C)``, or None when whole."""
    tp = _split(layer)
    return None if tp is None else tp.axis.window(y.shape[1])


def _layer(op, layer, x, compute_dtype, full: bool, bias_shape) -> torch.Tensor:
    """``op(x, weight, bias)`` with the layer's model-axis split (module
    docstring); ``full=False`` leaves a column-parallel layer's output on
    this rank's channels."""
    tp = _split(layer)
    if tp is None:
        return op(x, layer.weight, layer.bias, compute_dtype)
    if tp.kind == "row":
        out = tp.axis.reduce(op(x, layer.weight, None, compute_dtype))
        return out + layer.bias.to(out.dtype).view(bias_shape)
    out = op(tp.axis.copy(x), layer.weight, layer.bias, compute_dtype)
    return tp.axis.gather(out, tp.groups) if full else out


def _conv(layer, x: torch.Tensor, compute_dtype=None, full: bool = True) -> torch.Tensor:
    """``layer.weight`` is the parameter of an ``nn.Conv1d`` and the
    normalised weight of a ``SpectralNormConv1d``."""
    op = lambda x, w, b, cd: conv1d(x, w, b, stride=layer.stride[0], compute_dtype=cd)
    return _layer(op, layer, x, compute_dtype, full, (-1, 1))


def _dense(layer, x: torch.Tensor, compute_dtype=None, full: bool = True) -> torch.Tensor:
    op = lambda x, w, b, cd: dense(x, w, b, compute_dtype=cd)
    return _layer(op, layer, x, compute_dtype, full, (-1,))


def _bank(layers: nn.ModuleList, x, kernel_sizes, act, compute_dtype=None, bank_out=None) -> torch.Tensor:
    """The encoder's conv bank of x, or ``bank_out`` when it is given (a
    bank computed outside, e.g. by ops/conv.py ``dual_conv_bank``; the JAX
    package's ``bank_out``)."""
    tp = _split(layers[0])
    if bank_out is not None:
        if tp is not None:
            raise ValueError(
                "bank_out with the bank split over a model axis: the split bank's "
                "channels are this rank's groups, not a whole bank_out"
            )
        return bank_out
    ws, bs = [c.weight for c in layers], [c.bias for c in layers]
    if tp is None:
        return conv_bank(x, ws, bs, kernel_sizes, act, compute_dtype=compute_dtype)
    # every bank conv is column-parallel: this rank's [k_1 | k_2 | ...]
    # channels, gathered rank-major and put back in the one-process order
    # [k_1 | k_2 | ...]; x itself is appended whole, outside the copy
    out = conv_bank(tp.axis.copy(x), ws, bs, kernel_sizes, act, compute_dtype=compute_dtype)
    out = tp.axis.gather(out[:, : -x.shape[1]], len(layers))
    return torch.cat([out, x.to(out.dtype)], dim=1)


def global_draw(
    draw, shape, rows: Optional[Tuple[int, int, int]], device: torch.device,
    generator: Optional[torch.Generator],
    channels: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """``draw(shape)`` from ``generator``; with a row window ``(lo, hi,
    B_global)`` (a rank's rows of the global batch, core/mesh.py
    ``row_window``) the draw is made at the global shape ``(B_global,
    *shape[1:])`` and rows ``lo:hi`` are kept, so N ranks draw what one
    process draws for the whole batch. A channel window ``(lo, hi, C)`` (a
    rank's channels of an activation split over the model axis) does the
    same along axis 1."""
    if rows is None and channels is None:
        return draw(shape, generator=generator, device=device)
    full = list(shape)
    if rows is not None:
        full[0] = rows[2]
    if channels is not None:
        full[1] = channels[2]
    out = draw(tuple(full), generator=generator, device=device)
    if rows is not None:
        out = out[rows[0] : rows[1]]
    if channels is not None:
        out = out[:, channels[0] : channels[1]]
    return out


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator], training: bool,
    rows: Optional[Tuple[int, int, int]] = None,
    channels: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (on x's
    device), at the global batch shape when ``rows`` is given and at the
    full channel count when ``channels`` is. The identity in eval mode, at
    rate 0, or without a generator."""
    if not training or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = global_draw(torch.rand, x.shape, rows, x.device, generator, channels) < keep
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
        compute_dtype: Optional[torch.dtype] = None, rows=None,
        bank_out: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``bank_out``: the conv bank's output (B, n_k*c_bank + c_in, T),
        computed outside; the bank here is then skipped."""
        act, cd = self.act, compute_dtype
        drop = lambda y, ch=None: dropout(y, self.cfg.dropout_rate, generator, self.training, rows, ch)
        out = _bank(self.conv_bank, x, self.kernel_sizes, act, cd, bank_out)
        out = act(_conv(self.in_conv_layer, out, cd))
        for first, second in zip(self.first_conv_layers, self.second_conv_layers):
            y = act(_conv(first, out, cd, full=False))
            y = drop(act(_conv(second, drop(y, _channels(first, y)), cd)))
            sub = second.stride[0]
            if sub > 1:
                out = avg_pool_time_ceil(out, sub)
            out = y + out
        out = global_avg_pool_time(out)
        for first, second in zip(self.first_dense_layers, self.second_dense_layers):
            y = act(_dense(first, out, cd, full=False))
            out = drop(act(_dense(second, drop(y, _channels(first, y)), cd))) + out
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
        compute_dtype: Optional[torch.dtype] = None, rows=None,
        bank_out: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``bank_out``: as ``SpeakerEncoder.forward``'s."""
        act, cd = self.act, compute_dtype
        drop = lambda y, ch=None: dropout(y, self.cfg.dropout_rate, generator, self.training, rows, ch)
        out = _bank(self.conv_bank, x, self.kernel_sizes, act, cd, bank_out)
        # instance norm before every activation
        out = drop(act(instance_norm_time(_conv(self.in_conv_layer, out, cd))))
        for first, second in zip(self.first_conv_layers, self.second_conv_layers):
            y = act(instance_norm_time(_conv(first, out, cd, full=False)))
            y = drop(act(instance_norm_time(_conv(second, drop(y, _channels(first, y)), cd))))
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
        compute_dtype: Optional[torch.dtype] = None, rows=None,
    ) -> torch.Tensor:
        act, cd = self.act, compute_dtype
        drop = lambda y, ch=None: dropout(y, self.cfg.dropout_rate, generator, self.training, rows, ch)
        out = drop(act(instance_norm_time(_conv(self.in_conv_layer, z, cd))))
        for l, up in enumerate(self.cfg.upsample[: self.cfg.n_conv_blocks]):
            first = self.first_conv_layers[l]
            y = instance_norm_time(_conv(first, out, cd, full=False))
            # a split pair's affine gives this rank's (mean, std) rows
            cond1 = _dense(self.conv_affine_layers[2 * l], cond, cd, full=_split(first) is None)
            y = drop(act(adain(y, cond1)), _channels(first, y))
            y = _conv(self.second_conv_layers[l], y, cd)
            if up > 1:
                y = pixel_shuffle_time(y, up)
            y = instance_norm_time(y)
            y = drop(act(adain(y, _dense(self.conv_affine_layers[2 * l + 1], cond, cd))))
            out = y + (upsample_nearest_time(out, up) if up > 1 else out)
        return _conv(self.out_conv_layer, out, cd)
