"""The training and evaluation steps.

One training step is: forward with the VAE sampling, ``loss = lambda_rec *
L1(dec, x) + lambda_kl * KL``, backward, the gradients' global norm before
clipping (the ``grad_norm`` metric), the optimiser (clip, L2 weight decay,
Adam / AMSGrad; train/optim.py). With spectral norm the stored ``u`` of
every decoder layer advances once per step from the weights the step
started with, before the optimiser changes them. The metrics come back as
tensors on the model's device: nothing in the step waits for the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.config import TrainConfig
from ..models.ae import AE
from ..models.modules import spectral_norm_update
from .optim import TorchAdam


def from_wire_format(x: torch.Tensor) -> torch.Tensor:
    """A uint16 batch is the bf16 wire format (data/loader.py
    ``as_wire_format``): reinterpreted, not converted."""
    return x.view(torch.bfloat16) if x.dtype == torch.uint16 else x


def loss_terms(
    model: AE,
    cfg: TrainConfig,
    x: torch.Tensor,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """(loss_rec, loss_kl, (mu, log_sigma, emb, dec)) for a batch x
    (B, T, n_mels). The reconstruction loss is taken in f32; the KL term
    is computed in the encoder outputs' dtype (bf16 under
    ``compute_dtype="bfloat16"``, as in the JAX package) and returned as
    f32."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    mu, log_sigma, emb, dec = model(x, eps=eps, generator=generator, compute_dtype=dtype)
    loss_rec = (dec.float() - x.float()).abs().mean()
    loss_kl = (0.5 * (torch.exp(log_sigma) + mu.square() - 1.0 - log_sigma).mean()).float()
    return loss_rec, loss_kl, (mu, log_sigma, emb, dec)


def make_train_step(
    cfg: TrainConfig, model: AE, optimizer: TorchAdam
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(x, lambda_kl, eps=None, generator=None) -> metrics`` with the
    keys loss, loss_rec, loss_kl, grad_norm (the norm before clipping) as
    tensors on the model's device. ``eps`` is the VAE's normal draw; without
    it the draw comes from ``generator``, which also feeds dropout."""
    sn = cfg.model.decoder.sn
    lambda_rec = cfg.loss.lambda_rec

    def step(x, lambda_kl, eps=None, generator=None):
        model.train()
        x = from_wire_format(x)
        optimizer.zero_grad(set_to_none=True)
        loss_rec, loss_kl, _ = loss_terms(model, cfg, x, eps, generator)
        loss = lambda_rec * loss_rec + lambda_kl * loss_kl
        loss.backward()
        if sn:
            # from the weights this step's forward saw, not the updated ones
            spectral_norm_update(model)
        grad_norm = optimizer.step()
        return {
            "loss": loss.detach(),
            "loss_rec": loss_rec.detach(),
            "loss_kl": loss_kl.detach(),
            "grad_norm": grad_norm,
        }

    return step


def make_eval_step(cfg: TrainConfig, model: AE) -> Callable[..., Dict[str, torch.Tensor]]:
    """``eval_step(x, lambda_kl) -> {loss_rec, loss_kl, loss}``: the model in
    eval mode (no dropout, ``weight_u`` untouched), no gradients, and the
    VAE draw from a generator seeded 0 on every call, so the same batch
    always gives the same losses. The model's mode is restored."""
    lambda_rec = cfg.loss.lambda_rec

    def eval_step(x, lambda_kl):
        was_training = model.training
        model.eval()
        try:
            x = from_wire_format(x)
            gen = torch.Generator(device=x.device).manual_seed(0)
            with torch.no_grad():
                loss_rec, loss_kl, _ = loss_terms(model, cfg, x, generator=gen)
        finally:
            model.train(was_training)
        return {
            "loss_rec": loss_rec,
            "loss_kl": loss_kl,
            "loss": lambda_rec * loss_rec + lambda_kl * loss_kl,
        }

    return eval_step
