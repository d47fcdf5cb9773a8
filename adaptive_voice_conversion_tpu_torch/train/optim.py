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

The KL anneal (``kl_lambda``) is a pure function of the iteration.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..core.config import OptimizerConfig

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

    def _init_state(self, p: torch.Tensor, amsgrad: bool) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = 0
            st["exp_avg"] = torch.zeros_like(p, dtype=self.state_dtype)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.state_dtype)
            if amsgrad:
                st["max_exp_avg_sq"] = torch.zeros_like(p, dtype=self.state_dtype)
        return st

    def load_state_dict(self, state_dict: dict) -> None:
        """As the base class, but the moments keep ``state_dtype``: the base
        class casts every state tensor to its parameter's dtype, which
        would turn a bf16 state into f32."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
                if key in st:
                    st[key] = st[key].to(self.state_dtype)
            st["step"] = int(st["step"])

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
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
            b1, b2 = group["betas"]
            amsgrad = group["amsgrad"]
            states = [self._init_state(p, amsgrad) for p in params]
            # g * clip / max(norm, clip): 1 exactly below the threshold; the
            # products are new tensors, p.grad stays what backward left
            scale = group["clip_norm"] / torch.clamp(total, min=group["clip_norm"])
            grads = torch._foreach_mul([p.grad.float() for p in params], scale)
            if group["weight_decay"] != 0:
                torch._foreach_add_(grads, [p.detach() for p in params], alpha=group["weight_decay"])
            # every parameter of a group has taken the same number of steps
            for st in states:
                st["step"] += 1
            t = states[0]["step"]
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t

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
            denom = torch._foreach_div(v_hat, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(m, bc1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(params, upd, alpha=-group["lr"])

            if self.state_dtype != torch.float32:
                # f32 moments were updated in place; bf16 ones are rounded
                # (to nearest even) as they are stored
                for st, m_i, v_i, vh_i in zip(states, m, v, v_hat):
                    st["exp_avg"].copy_(m_i)
                    st["exp_avg_sq"].copy_(v_i)
                    if amsgrad:
                        st["max_exp_avg_sq"].copy_(vh_i)
        return total


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


def make_optimizer(
    cfg: OptimizerConfig,
    params: Iterable[torch.nn.Parameter],
    state_dtype: str = "float32",
    fused=False,
) -> TorchAdam:
    """The training chain over ``params`` (a model's ``parameters()``: its
    buffers, the spectral-norm ``weight_u`` / ``weight_v`` among them, are
    never given to the optimiser)."""
    if fused:
        raise NotImplementedError(
            f"opt_fused={fused!r}: the flattened / bucketed optimiser "
            "(bucketed_flatten) is ROADMAP item 12 and is not ported yet"
        )
    if state_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"opt_state_dtype={state_dtype!r}: expected 'float32' or 'bfloat16'")
    return TorchAdam(
        params,
        lr=cfg.lr,
        betas=(cfg.beta1, cfg.beta2),
        eps=ADAM_EPS,
        weight_decay=cfg.weight_decay,
        amsgrad=cfg.amsgrad,
        clip_norm=cfg.grad_norm,
        state_dtype=torch.bfloat16 if state_dtype == "bfloat16" else torch.float32,
    )


def kl_lambda(iteration: int, lambda_kl: float, annealing_iters: int) -> float:
    """lambda_kl * min(1, (it + 1) / annealing_iters)."""
    return lambda_kl * min(1.0, (iteration + 1) / annealing_iters)
