"""The optimiser: torch Adam's semantics with an optional bf16 state.

The reference clips gradients by their global norm first
(``clip_grad_norm_`` before ``opt.step``), then ``torch.optim.Adam`` adds
weight decay into the gradient (``g += wd * p``: L2, not decoupled AdamW;
it feeds the moments) and runs the Adam moments. With ``amsgrad`` the
running maximum is taken over the **raw** second moment and the bias
corrections are those of the current step:

    update = -lr * (m / bc1) / (sqrt(v_max / bc2) + 1e-8)

``TorchAdam`` is that function as one ``torch.optim.Optimizer`` for all four
combinations of ``amsgrad`` and ``state_dtype``. ``state_dtype=bfloat16``
stores the moments in bf16 while every step's arithmetic runs in f32 on the
upcast values: only the carried state is rounded, so the f32 parameters see
f32 update math either way (with one exception kept from the JAX package's
chain: without ``amsgrad`` the decay ``b1 * m`` of the bf16 first moment is
taken in bf16).

Only parameters are given to the optimiser. The spectral-norm vectors
``weight_u`` / ``weight_v`` are buffers, so weight decay and the moments
never see them; no mask is needed.

``opt_fused`` (the JAX package's ``make_optimizer(fused=...)``) runs the
same arithmetic on flat vectors instead of one tensor per parameter:
``True`` on one vector (``optax.flatten``), ``"bucketed<K>"`` on K
size-balanced buckets (``bucketed_flatten``, K defaults to 4).
``FlatAdam`` packs the gradients (and, with weight decay, the parameters)
into the buckets every step and unpacks the update into the parameters:
the elementwise math is ``TorchAdam``'s, only the global norm's reduction
order changes. The JAX package keeps the modes as a recorded negative
result (adaptive_voice_conversion_tpu/train/optim.py:137-147, the per-leaf
chain faster); the default is the per-leaf chain here too.

The KL anneal (``kl_lambda``) is a pure function of the iteration.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..core.config import OptimizerConfig, TrainConfig

ADAM_EPS = 1e-8


class TorchAdam(torch.optim.Optimizer):
    """Adam / AMSGrad with L2 weight decay, moments stored in ``state_dtype``.

    ``step`` clips the gradients' global norm to ``clip_norm`` (before the
    weight decay) and returns the norm before clipping, as a tensor on the
    parameters' device.
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: float = 5e-4,
        betas=(0.9, 0.999),
        eps: float = ADAM_EPS,
        weight_decay: float = 0.0,
        amsgrad: bool = True,
        clip_norm: float = 5.0,
        state_dtype: torch.dtype = torch.float32,
    ):
        if state_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"state_dtype={state_dtype}: expected float32 or bfloat16")
        defaults = dict(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, amsgrad=amsgrad,
            clip_norm=clip_norm,
        )
        super().__init__(params, defaults)
        self.state_dtype = state_dtype

    def _init_state(self, key, like: torch.Tensor, amsgrad: bool) -> dict:
        """The state under ``key`` (a parameter, or a bucket's name), its
        moments zeros shaped like ``like`` on first use."""
        st = self.state[key]
        if not st:
            st["step"] = 0
            st["exp_avg"] = torch.zeros_like(like, dtype=self.state_dtype)
            st["exp_avg_sq"] = torch.zeros_like(like, dtype=self.state_dtype)
            if amsgrad:
                st["max_exp_avg_sq"] = torch.zeros_like(like, dtype=self.state_dtype)
        return st

    def load_state_dict(self, state_dict: dict) -> None:
        """As the base class, but the moments keep ``state_dtype``: the base
        class casts every state tensor to its parameter's dtype, which
        would turn a bf16 state into f32. A state saved by a ``FlatAdam``
        raises: its moments are flat buckets, not one tensor a parameter."""
        if state_dict.get("opt_fused"):
            raise ValueError(
                f"the optimiser state was saved with opt_fused={state_dict['opt_fused']!r} "
                "and this run has opt_fused=False: resume with the opt_fused it was saved with"
            )
        self._load(state_dict)

    def _load(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        device = self.param_groups[0]["params"][0].device
        for st in self.state.values():
            for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
                if key in st:
                    st[key] = st[key].to(device, self.state_dtype)
            st["step"] = int(st["step"])

    def _state_keys(self) -> list:
        """The keys of ``state`` that every step updates: the parameters."""
        return [p for g in self.param_groups for p in g["params"]]

    def step_count(self) -> Optional[int]:
        """The steps taken, when every key of ``_state_keys`` has a state
        and all have taken the same number; None otherwise (before the
        first step, or a parameter that took no step)."""
        counts = {self.state[k]["step"] if self.state.get(k) else None for k in self._state_keys()}
        return counts.pop() if len(counts) == 1 else None

    def advance(self, n: int) -> None:
        """Count ``n`` more steps on every state: the steps a CUDA graph
        replayed without running this object's host code
        (train/step.py)."""
        for k in self._state_keys():
            self.state[k]["step"] += n

    @torch.no_grad()
    def step(self, closure=None, bias_corrections=None) -> torch.Tensor:
        """``bias_corrections``: see ``_update``."""
        if closure is not None:
            raise ValueError("TorchAdam.step takes no closure")
        with_grad = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        # the global norm over every group, before clipping
        norms = torch._foreach_norm([p.grad for p in with_grad])
        total = global_norm(with_grad, norms)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self._init_state(p, p, group["amsgrad"]) for p in params]
            upd = self._update(
                group, [p.grad for p in params], lambda: params, states, total, bias_corrections
            )
            torch._foreach_add_(params, upd, alpha=-group["lr"])
        return total

    def _update(self, group: dict, grads, params, states, total, bias_corrections=None) -> list:
        """Adam's update direction ``(m / bc1) / (sqrt(v_hat / bc2) + eps)``
        for each tensor of ``grads``, its moments in ``states`` advanced in
        place. ``params`` is called for the tensors that weight decay adds
        in, only when there is weight decay. ``bias_corrections`` is
        ``bias_correction_operands`` of the step being taken as two 0-dim
        f32 tensors on the device, which a CUDA graph reads anew at every
        replay (train/step.py); None takes ``(bc1, bc2)`` as floats from
        the step count."""
        b1, b2 = group["betas"]
        amsgrad = group["amsgrad"]
        # g * clip / max(norm, clip): 1 exactly below the threshold; the
        # products are new tensors, the gradients stay what backward left
        scale = group["clip_norm"] / torch.clamp(total, min=group["clip_norm"])
        grads = torch._foreach_mul([g.float() for g in grads], scale)
        if group["weight_decay"] != 0:
            torch._foreach_add_(grads, [p.detach() for p in params()], alpha=group["weight_decay"])
        # every tensor of a group has taken the same number of steps
        for st in states:
            st["step"] += 1
        if bias_corrections is None:
            t = states[0]["step"]
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            div = torch._foreach_div
        else:
            bc1, bc2 = bias_corrections
            div = _by_bias_correction

        f32 = lambda key: [st[key].float() for st in states]
        if amsgrad or self.state_dtype == torch.float32:
            m = f32("exp_avg")
            torch._foreach_mul_(m, b1)
        else:
            # the JAX package's chain for this one combination
            # (optax.scale_by_adam with a bf16 first moment) decays the
            # stored moment in bf16: b1 itself is rounded to bf16 and so is
            # b1 * m, before the gradient is added in f32; kept, so the
            # two trajectories agree
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            m = [(st["exp_avg"] * b1_bf16).float() for st in states]
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        v = f32("exp_avg_sq")
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        if amsgrad:
            v_hat = f32("max_exp_avg_sq")
            torch._foreach_maximum_(v_hat, v)
        else:
            v_hat = v
        denom = div(v_hat, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        upd = div(m, bc1)
        torch._foreach_div_(upd, denom)

        if self.state_dtype != torch.float32:
            # f32 moments were updated in place; bf16 ones are rounded
            # (to nearest even) as they are stored
            for st, m_i, v_i, vh_i in zip(states, m, v, v_hat):
                st["exp_avg"].copy_(m_i)
                st["exp_avg_sq"].copy_(v_i)
                if amsgrad:
                    st["max_exp_avg_sq"].copy_(vh_i)
        return upd


def bias_correction_operands(betas, t: int, device: torch.device) -> tuple:
    """Adam's bias corrections ``1 - b1**t``, ``1 - b2**t`` as the float
    path of ``TorchAdam._update`` applies them on ``device``:
    ``torch._foreach_div`` by a float multiplies by its reciprocal, taken in
    double and rounded to f32, on CUDA, and divides by it on the CPU. As
    0-dim f32 tensors (``step(bias_corrections=...)``) they give that
    path's numbers bit for bit."""
    bc = tuple(1.0 - b ** t for b in betas)
    return tuple(1.0 / c for c in bc) if device.type == "cuda" else bc


def _by_bias_correction(tensors, operand: torch.Tensor) -> list:
    """``tensors`` divided by a bias correction given as its
    ``bias_correction_operands`` value in a 0-dim f32 tensor on their
    device, which is not read on the host: a CUDA graph reads it anew at
    every replay."""
    if operand.device.type == "cuda":
        return torch._foreach_mul(tensors, operand)
    return torch._foreach_div(tensors, operand)


def bucket_plan(sizes, n_buckets: int):
    """(bucket of each leaf, elements of each bucket): the JAX package's
    greedy plan (``bucketed_flatten._plan``), the largest leaf first into
    the least-filled bucket (the lowest index among equals), with
    ``n_buckets`` capped at the number of leaves and at least 1."""
    k = max(1, min(n_buckets, len(sizes)))
    fill = [0] * k
    assign = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        b = min(range(k), key=lambda j: fill[j])
        assign[i] = b
        fill[b] += sizes[i]
    return assign, fill


class FlatAdam(TorchAdam):
    """``TorchAdam`` on flat buckets (the module docstring): one parameter
    group; the moments live under ``state["bucket<b>"]``, each a flat
    vector of its bucket's leaves in parameter order.

    The gradients' global norm is taken over the buckets. Under a model
    axis (``p.tp``, parallel/tp.py) a bucket mixes split and replicated
    leaves, so the norm is then taken per leaf by ``global_norm``, as the
    per-leaf chain takes it. A parameter without a gradient counts as a
    zero gradient, as in the JAX package's flat vector."""

    def __init__(self, params, mode, n_buckets: int, **kw):
        super().__init__(params, **kw)
        if len(self.param_groups) != 1:
            raise ValueError(f"opt_fused={mode!r} takes one parameter group")
        self.mode = mode
        self.sizes = [p.numel() for p in self.param_groups[0]["params"]]
        assign, self.fill = bucket_plan(self.sizes, n_buckets)
        self.members = [[i for i, b in enumerate(assign) if b == k] for k in range(len(self.fill))]

    def _pack(self, tensors) -> list:
        """K flat f32 vectors, bucket k the concatenation of its leaves."""
        return [torch.cat([tensors[i].reshape(-1).float() for i in idx]) for idx in self.members]

    def _unpack(self, buckets) -> list:
        """Per-leaf views of K flat vectors, in parameter order."""
        params = self.param_groups[0]["params"]
        out = [None] * len(params)
        for idx, flat in zip(self.members, buckets):
            for i, part in zip(idx, flat.split([params[i].numel() for i in idx])):
                out[i] = part.view(params[i].shape)
        return out

    def _state_keys(self) -> list:
        return [f"bucket{k}" for k in range(len(self.members))]

    @torch.no_grad()
    def step(self, closure=None, bias_corrections=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("FlatAdam.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        g_flat = self._pack(grads)
        if any(getattr(p, "tp", None) is not None for p in params):
            total = global_norm(params, torch._foreach_norm(grads))
        else:
            total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g_flat)))
        states = [self._init_state(f"bucket{k}", g, group["amsgrad"]) for k, g in enumerate(g_flat)]
        upd = self._update(group, g_flat, lambda: self._pack(params), states, total, bias_corrections)
        torch._foreach_add_(params, self._unpack(upd), alpha=-group["lr"])
        return total

    def state_dict(self) -> dict:
        return {**super().state_dict(), "opt_fused": self.mode}

    def load_state_dict(self, state_dict: dict) -> None:
        """Only a state saved by a ``FlatAdam`` with the same buckets loads
        (``"bucketed"`` and ``"bucketed4"`` have the same): any other has
        moments of other shapes."""
        saved = state_dict.get("opt_fused", False)
        if not saved or bucket_plan(self.sizes, fused_buckets(saved))[1] != self.fill:
            raise ValueError(
                f"the optimiser state was saved with opt_fused={saved!r} and this run has "
                f"opt_fused={self.mode!r}: resume with the opt_fused it was saved with"
            )
        self._load(state_dict)


def global_norm(params, norms) -> torch.Tensor:
    """The norm of all the gradients from each one's norm. A parameter split
    over the model axis (``p.tp``, set by parallel/tp.py
    ``shard_params_tp``) holds this rank's shard of its gradient: the
    squares of those are summed over the model axis, and a replicated
    parameter, whole on every rank, is counted once."""
    norms = torch.stack([n.float() for n in norms])
    split = [getattr(p, "tp", None) for p in params]
    axis = next((tp.axis for tp in split if tp is not None), None)
    if axis is None:
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor([tp is not None for tp in split], device=norms.device)
    sq = norms.square()
    return (axis.sum(sq[mask].sum(), "update") + sq[~mask].sum()).sqrt()


def fused_buckets(fused) -> int:
    """The number of flat buckets of an ``opt_fused`` mode, 0 for the
    per-leaf chain: ``False`` (or any falsy value) 0, ``True`` 1, ``"bucketed<K>"`` K (K
    defaults to 4; ``FlatAdam`` caps it at the number of leaves). Any other
    value raises ``ValueError``, as in the JAX package."""
    if not fused:
        return 0
    if fused is True:
        return 1
    if isinstance(fused, str) and fused.startswith("bucketed"):
        return int(fused[len("bucketed"):] or 4)
    raise ValueError(f"unknown fused mode {fused!r}")


def make_optimizer(
    cfg: OptimizerConfig,
    params: Iterable[torch.nn.Parameter],
    state_dtype: str = "float32",
    fused=False,
    sn: bool = False,
) -> TorchAdam:
    """The training chain over ``params`` (a model's ``parameters()``: its
    buffers, the spectral-norm ``weight_u`` / ``weight_v`` among them, are
    never given to the optimiser). ``fused`` is the config's ``opt_fused``
    (the module docstring); with ``sn`` (the decoder's spectral norm) it
    raises, as the JAX package's does."""
    if fused and sn:
        raise ValueError(
            f"make_optimizer(fused={fused!r}, sn=True) is unsupported, as in the JAX "
            "package (its flat chain cannot carry the spectral-norm masked tree): "
            "drop opt_fused or sn"
        )
    if state_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"opt_state_dtype={state_dtype!r}: expected 'float32' or 'bfloat16'")
    n_buckets = fused_buckets(fused)
    kw = dict(
        lr=cfg.lr,
        betas=(cfg.beta1, cfg.beta2),
        eps=ADAM_EPS,
        weight_decay=cfg.weight_decay,
        amsgrad=cfg.amsgrad,
        clip_norm=cfg.grad_norm,
        state_dtype=torch.bfloat16 if state_dtype == "bfloat16" else torch.float32,
    )
    if n_buckets:
        return FlatAdam(params, fused, n_buckets, **kw)
    return TorchAdam(params, **kw)


def make_train_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter]) -> TorchAdam:
    """``make_optimizer`` with every knob a training config sets: the
    optimiser section, ``opt_state_dtype``, ``opt_fused`` and the decoder's
    ``sn``."""
    return make_optimizer(
        cfg.optimizer, params, state_dtype=cfg.opt_state_dtype, fused=cfg.opt_fused,
        sn=cfg.model.decoder.sn,
    )


def kl_lambda(iteration: int, lambda_kl: float, annealing_iters: int) -> float:
    """lambda_kl * min(1, (it + 1) / annealing_iters)."""
    return lambda_kl * min(1.0, (iteration + 1) / annealing_iters)
