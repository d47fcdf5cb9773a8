"""Tensor parallelism: channel-split parameters over the mesh's model axis.

The JAX package assigns Megatron-style partition specs to its parameter
tree and lets GSPMD insert the collectives. Here every collective and every
autograd rule is written out. Each rank of a model group (core/mesh.py)
holds one shard of every split layer; the forward in models/modules.py runs
on those shards through Megatron's four operators on the channel axis
(dim 1 of (B, C, T) and of (B, C)), over the model group:

    operator   forward              backward
    copy       identity             all-reduce
    reduce     all-reduce           identity
    gather     all-gather           this rank's slice
    scatter    this rank's slice    all-gather

The split rule is the JAX package's ``_leaf_spec``, on torch layouts (conv
weight (out, in, k), dense weight (out, in)):

- the residual blocks' *second* layers (``second_conv_layers``,
  ``second_dense_layers``) are row-parallel: the weight is split on dim 1
  (input channels), the bias is replicated and added after the reduce;
- every other conv and linear is column-parallel: weight and bias split on
  dim 0 (output channels);
- an axis that the model axis's size does not divide stays replicated.

Spectral-norm buffers follow their weight: ``weight_u`` (out,) is split
with a column layer's rows, ``weight_v`` (in * k,) with a row layer's input
channels (a contiguous block: ``in`` leads the flattened ``(in, k)``).

Where the one-process channel order is not rank-major, a split is taken
group by group: the AdaIN affine ``decoder.conv_affine_layers[2l]``, whose
output is ``[mean | std]`` of the channels of ``first_conv_layers[l]``, gives
each rank the mean rows of its channels, then their std rows; a gather puts
the rows back in order. The spec still says dim 0.

The step is train/step.py's ``make_train_step``: the data-axis all-reduce
runs on the data group, the optimiser sums the split parameters' squared
gradient norms over the model group (train/optim.py ``global_norm``), and
the spectral-norm update runs on the shards. Replicated parameters come out
of backward equal on every rank of a model group, so nothing averages them.

The collectives go through ``Mesh.comm_device``, as the data-axis helpers
do: gloo ranks that share one GPU stage their tensors through the host. A
16-bit tensor is summed in f32 on the wire and gathered as its bytes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..core.mesh import Mesh, _as_wire

_ROW_LAYERS = ("second_conv_layers", "second_dense_layers")
_WEIGHTS = ("weight", "weight_orig")
# the dim each leaf of a split layer is split on; the others are replicated
_DIMS = {
    "row": {"weight": 1, "weight_orig": 1, "weight_v": 0},
    "column": {"weight": 0, "weight_orig": 0, "bias": 0, "weight_u": 0},
}


class ModelAxis:
    """One rank's model group and the collectives along it.

    ``calls`` counts the collectives that move data, by phase: ``forward``
    (the forward pass, spectral norm's power iteration in it included),
    ``backward`` (autograd) and ``update`` (the optimiser's norm, the
    spectral-norm update, and ``gather_tp``); ``seconds`` is their
    host-clock time, the staging copies included."""

    def __init__(self, mesh: Mesh):
        if mesh.n_model > 1 and mesh.model_group is None:
            raise ValueError("the mesh has no model group: build it with make_mesh(n_model=...)")
        self.group = mesh.model_group
        self.size = mesh.n_model
        self.index = mesh.model_index
        self.comm_device = mesh.comm_device
        self.reset_counts()

    def reset_counts(self) -> None:
        self.calls = {"forward": 0, "backward": 0, "update": 0}
        self.seconds = 0.0

    def _start(self, t: torch.Tensor) -> float:
        if t.is_cuda and self.comm_device.type != "cuda":
            torch.cuda.synchronize(t.device)  # the staging copy waits for it anyway
        return time.perf_counter()

    def _done(self, phase: str, t0: float) -> None:
        self.calls[phase] += 1
        self.seconds += time.perf_counter() - t0

    def sum(self, t: torch.Tensor, phase: str = "forward") -> torch.Tensor:
        """The sum over the model group, a new tensor on ``t``'s device and
        dtype (16-bit floats are summed in f32)."""
        t0 = self._start(t)
        wire = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
        buf = torch.empty(t.shape, dtype=wire, device=self.comm_device)
        buf.copy_(t.detach())
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        out = buf.to(t.device, t.dtype)
        self._done(phase, t0)
        return out

    def all_gather(self, t: torch.Tensor, dim: int, phase: str = "forward") -> torch.Tensor:
        """Every rank's equal-shaped ``t``, concatenated along ``dim`` in
        model-index order, on ``t``'s device."""
        t0 = self._start(t)
        buf = _as_wire(t.detach().contiguous()).to(self.comm_device)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        out = torch.cat([p.view(t.dtype) for p in parts], dim).to(t.device)
        self._done(phase, t0)
        return out

    def window(self, c_local: int) -> tuple:
        """``(lo, hi, C)``: where this rank's ``c_local`` contiguous channels
        sit in the full ``C``."""
        lo = self.index * c_local
        return lo, lo + c_local, c_local * self.size

    # Megatron's operators, on dim 1
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """All-gather along dim 1, then the rows of each of ``groups``
        equal groups put together (``unsplit``)."""
        return unsplit(_Gather.apply(x, self), 1, self.size, groups)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        return _Scatter.apply(x, self)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.sum(g, "backward"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.sum(x, "forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.c = axis, x.shape[1]
        return axis.all_gather(x, 1, "forward")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.axis.index * ctx.c, ctx.c), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        if x.shape[1] % axis.size:
            raise ValueError(f"scatter: {x.shape[1]} channels over {axis.size} ranks")
        ctx.axis = axis
        c = x.shape[1] // axis.size
        return x.narrow(1, axis.index * c, c).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g, 1, "backward"), None


def split_part(t: torch.Tensor, dim: int, n: int, index: int, groups: int = 1) -> torch.Tensor:
    """Rank ``index``'s part of ``t`` split ``n`` ways along ``dim``: from
    each of ``groups`` equal groups of the axis, its ``index``-th slice."""
    part = t.unflatten(dim, (groups, n, -1)).select(dim + 1, index)
    return part.flatten(dim, dim + 1).contiguous()


def unsplit(t: torch.Tensor, dim: int, n: int, groups: int = 1) -> torch.Tensor:
    """The inverse of ``split_part`` over the ``n`` parts concatenated in
    rank order along ``dim``."""
    if groups == 1:
        return t
    return t.unflatten(dim, (n, groups, -1)).transpose(dim, dim + 1).flatten(dim, dim + 2)


@dataclass(frozen=True)
class Split:
    """A layer's place on the model axis: ``column`` or ``row`` parallel,
    and the groups its output rows are split by."""

    kind: str
    axis: ModelAxis
    groups: int = 1


def _layer_tensors(model_or_state_dict) -> Dict[str, dict]:
    """layer name -> {leaf name: tensor}, in state_dict order."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    layers: Dict[str, dict] = {}
    for key, t in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        layers.setdefault(prefix, {})[leaf] = t
    return layers


def _kind(layer: str) -> str:
    return "row" if any(part in _ROW_LAYERS for part in layer.split(".")) else "column"


def _out_groups(layer: str, weight: torch.Tensor, n_model: int) -> int:
    """The groups a layer's output rows are split by: 2 for an AdaIN affine
    that meets a split first conv (rows [mean | std] of its channels), else
    1."""
    parts = layer.split(".")
    paired = (parts[-2:-1] == ["conv_affine_layers"] and int(parts[-1]) % 2 == 0
              and (weight.shape[0] // 2) % n_model == 0)
    return 2 if paired else 1


def _weight(leaves: dict) -> torch.Tensor:
    return next(leaves[k] for k in _WEIGHTS if k in leaves)


def _layer_spec(layer: str, leaves: dict, n_model: int) -> dict:
    kind = _kind(layer)
    split = _weight(leaves).shape[1 if kind == "row" else 0] % n_model == 0
    return {leaf: _DIMS[kind].get(leaf) if split else None for leaf in leaves}


def tp_param_specs(model_or_state_dict, n_model: int) -> Dict[str, Optional[int]]:
    """For every state_dict key of a whole (unsplit) model, the dim it is
    split on over ``n_model`` ranks, or None where it is replicated."""
    specs = {}
    for layer, leaves in _layer_tensors(model_or_state_dict).items():
        for leaf, dim in _layer_spec(layer, leaves, n_model).items():
            specs[f"{layer}.{leaf}"] = dim
    return specs


def shard_params_tp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut a whole model (the same on every rank, e.g. after
    ``replicate_pytree``) down to this rank's shard, in place, and give each
    split layer its ``tp`` (a ``Split``) and each split parameter too. The
    state_dict keys stay; only the shapes shrink. Parameters keep their
    identity, so an optimiser that has not stepped yet still holds them.
    With ``n_model`` 1 the model is left as it is. Returns ``model``."""
    if mesh.n_model == 1:
        return model
    if getattr(model, "tp_axis", None) is not None:
        raise ValueError("the model is already split over a model axis")
    axis = ModelAxis(mesh)
    n, index = mesh.n_model, mesh.model_index
    with torch.no_grad():
        for layer, leaves in _layer_tensors(model).items():
            spec = _layer_spec(layer, leaves, n)
            if all(d is None for d in spec.values()):
                continue
            mod = model.get_submodule(layer)
            split = Split(_kind(layer), axis, _out_groups(layer, _weight(leaves), n))
            for leaf, dim in spec.items():
                if dim is None:
                    continue
                part = split_part(leaves[leaf], dim, n, index, split.groups)
                if leaf in mod._parameters:
                    p = mod._parameters[leaf]
                    p.data = part
                    p.tp = split
                else:
                    mod._buffers[leaf] = part
            mod.tp = split
    model.tp_axis = axis
    return model


@torch.no_grad()
def gather_tp(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole tensors from this rank's shards: ``tensors`` maps state_dict
    keys of a model that ``shard_params_tp`` split to tensors of their
    local shapes (the state itself, or the parameters' gradients); each
    comes back as the one-process tensor, on every rank (a collective:
    every rank of the model group calls it with the same keys)."""
    axis = getattr(model, "tp_axis", None)
    out = {}
    for key, t in tensors.items():
        layer, leaf = key.rsplit(".", 1)
        tp = None if axis is None else getattr(model.get_submodule(layer), "tp", None)
        dim = None if tp is None else _DIMS[tp.kind].get(leaf)
        out[key] = (
            t.detach().clone() if dim is None else
            unsplit(axis.all_gather(t, dim, "update"), dim, axis.size, tp.groups)
        )
    return out


def gather_params_tp(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole model's state_dict on every rank, equal bit for bit to
    what ``shard_params_tp`` cut the shards from (tensors on the model's
    device). At ``n_model`` 1 it returns a copy of the model's own."""
    if mesh.n_model > 1 and getattr(model, "tp_axis", None) is None:
        raise ValueError("the model is not split over the mesh's model axis: shard_params_tp")
    return gather_tp(model, model.state_dict())


def make_tp_train_step(cfg, model: nn.Module, optimizer, mesh: Mesh):
    """``step(x, lambda_kl, eps=None, generator=None) -> metrics``:
    train/step.py's ``make_train_step`` over ``mesh`` on a model that
    ``shard_params_tp`` split over it (the optimiser made on its
    parameters). ``x`` and ``eps`` are this rank's rows of the global batch
    (its data index's: every rank of a model group feeds the same rows), and
    every rank returns the one-process metrics."""
    from ..train.step import make_train_step

    if mesh.n_model > 1 and getattr(model, "tp_axis", None) is None:
        raise ValueError("split the model first: shard_params_tp(model, mesh)")
    return make_train_step(cfg, model, optimizer, mesh)
