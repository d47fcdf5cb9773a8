"""The training and evaluation steps.

One training step is: forward with the VAE sampling, ``loss = lambda_rec *
L1(dec, x) + lambda_kl * KL``, backward, the gradients' global norm before
clipping (the ``grad_norm`` metric), the optimiser (clip, L2 weight decay,
Adam / AMSGrad; train/optim.py). With spectral norm the stored ``u`` of
every decoder layer advances once per step from the weights the step
started with, before the optimiser changes them. The metrics come back as
tensors on the model's device: nothing in the step waits for the device.

``make_device_data_train_step`` runs several such steps per call on a
device-resident corpus, drawing each step's batch on the device.

With a mesh (core/mesh.py) each rank runs the step on its rows of the
global batch, and the ranks together compute what one process computes on
the whole batch: every random draw (the batch positions, ``eps``, the
dropout masks) is made at the global shape from a generator every rank
seeds alike, each rank keeping its rows; the gradients are averaged over
the data axis by one all-reduce of one flat buffer before the spectral-norm
update and the optimiser, so the clip and ``grad_norm`` see the global
batch's gradient; the losses ride in the same buffer, so every rank
reports the one-process numbers. The all-reduce sums in a fixed order on
every call (what an exact resume needs), and it does not overlap backward.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.mesh import Mesh, all_reduce_mean, row_window
from ..data.device_sampler import sample_segments
from ..data.sharded import sample_segments_sharded
from ..models.ae import AE
from ..models.modules import spectral_norm_update
from ..utils.profiling import span
from .optim import TorchAdam, kl_lambda


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
    rows: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """(loss_rec, loss_kl, (mu, log_sigma, emb, dec)) for a batch x
    (B, T, n_mels). The reconstruction loss is taken in f32; the KL term
    is computed in the encoder outputs' dtype (bf16 under
    ``compute_dtype="bfloat16"``, as in the JAX package) and returned as
    f32. ``rows`` is the row window of ``AE.forward``."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    mu, log_sigma, emb, dec = model(
        x, eps=eps, generator=generator, compute_dtype=dtype, rows=rows
    )
    loss_rec = (dec.float() - x.float()).abs().mean()
    loss_kl = (0.5 * (torch.exp(log_sigma) + mu.square() - 1.0 - log_sigma).mean()).float()
    return loss_rec, loss_kl, (mu, log_sigma, emb, dec)


def all_reduce_gradients(model: AE, mesh: Mesh, extra: torch.Tensor) -> torch.Tensor:
    """Replace every parameter's gradient by its mean over the data axis,
    by one all-reduce of one flat buffer that also carries ``extra`` (a few
    f32 scalars, averaged alike); returns the averaged ``extra``."""
    params = [p for p in model.parameters() if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1).float() for p in params] + [extra.float()])
    flat = all_reduce_mean(mesh, flat)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[off : off + n].view_as(p.grad))
        off += n
    return flat[off:]


def make_train_step(
    cfg: TrainConfig, model: AE, optimizer: TorchAdam, mesh: Optional[Mesh] = None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(x, lambda_kl, eps=None, generator=None) -> metrics`` with the
    keys loss, loss_rec, loss_kl, grad_norm (the norm before clipping) as
    tensors on the model's device. ``eps`` is the VAE's normal draw; without
    it the draw comes from ``generator``, which also feeds dropout.

    With ``mesh``, ``x`` (and ``eps``, when given) are this rank's rows of
    the global batch (rows ``r * B_local`` onward at data index ``r``): the
    draws are made at the global shape, the gradients and the losses are
    averaged over the ranks (the module docstring), and every rank returns
    the global batch's metrics."""
    sn = cfg.model.decoder.sn
    lambda_rec = cfg.loss.lambda_rec

    def step(x, lambda_kl, eps=None, generator=None):
        with span("train.forward"):
            model.train()
            x = from_wire_format(x)
            optimizer.zero_grad(set_to_none=True)
            rows = None if mesh is None else row_window(mesh, x.shape[0])
            loss_rec, loss_kl, _ = loss_terms(model, cfg, x, eps, generator, rows)
            loss = lambda_rec * loss_rec + lambda_kl * loss_kl
        with span("train.backward"):
            loss.backward()
        with span("train.update"):
            loss, loss_rec, loss_kl = loss.detach(), loss_rec.detach(), loss_kl.detach()
            if mesh is not None:
                loss, loss_rec, loss_kl = all_reduce_gradients(
                    model, mesh, torch.stack([loss, loss_rec, loss_kl])
                )
            if sn:
                # from the weights this step's forward saw, not the updated ones
                spectral_norm_update(model)
            grad_norm = optimizer.step()
        return {"loss": loss, "loss_rec": loss_rec, "loss_kl": loss_kl, "grad_norm": grad_norm}

    return step


def step_seed(seed: int, iteration: int) -> int:
    """The seed of one step's random draws, a pure function of the run's
    seed and the iteration, so a resumed run draws what the continuous run
    drew."""
    ss = np.random.SeedSequence([seed + 1, iteration])
    return int(ss.generate_state(1, np.uint64)[0])


def make_device_data_train_step(
    cfg: TrainConfig,
    model: AE,
    optimizer: TorchAdam,
    inner_steps: int = 10,
    padded_starts: bool = False,
    sharded_data: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable[..., torch.Tensor]:
    """Multi-step trainer over a device-resident corpus
    (data/device_sampler.py): one call runs ``inner_steps`` iterations of
    sample -> forward -> backward -> update, each the step ``make_train_step``
    builds, with the batch drawn and gathered on the device.

        multi_step(packed, starts, seed, it0) -> (inner_steps, 4) tensor
            [loss, loss_rec, loss_kl, grad_norm] per step, on the device

    ``padded_starts=True``: the function takes ``n_starts`` (a device int64
    scalar) after ``starts``, the number of valid entries of a start list
    padded to a fixed length, so every chunk of data/chunked.py shares it.
    ``packed`` may be the uint16 wire format of bf16 (viewed, not converted).

    Random draws: step ``i`` seeds one generator on the device with
    ``step_seed(seed, it0 + i)``. The batch's positions are its first draw
    (``draw_indices``: ``batch_size`` 62-bit integers), and the VAE's ``eps``
    and any dropout masks follow in the same stream; the generator's state
    advances past every draw, so the two never share random bits. A
    resumed run repeats each step's draws, whatever call the step falls in.
    (The JAX package splits ``fold_in(base_key, it0 + i)`` into an index key
    and a step key instead; its streams cannot be matched in torch.)

    With ``mesh`` every rank holds the whole corpus (or chunk), draws all
    ``batch_size`` positions and gathers its own rows of them.
    ``sharded_data=True`` (needs a mesh): ``packed`` / ``starts`` are this
    rank's shard of a ``ShardedDeviceDataset`` and the rank draws its
    ``batch_size / n_data`` positions from its own starts, from a generator
    of (seed, step, shard) (data/sharded.py ``sample_segments_sharded``);
    ``eps`` and dropout still come from the step's generator at the global
    shape.

    No host synchronisation inside the loop: the seeds and ``lambda_kl`` are
    host arithmetic on ``it0``, shapes are fixed, and the metrics stay on the
    device until the caller reads them.
    """
    if sharded_data and mesh is None:
        raise ValueError("sharded_data requires a mesh")
    if sharded_data and padded_starts:
        raise NotImplementedError("sharded_data with padded_starts")
    step = make_train_step(cfg, model, optimizer, mesh)
    b = cfg.data_loader.batch_size
    seg = cfg.data_loader.segment_size
    device = next(model.parameters()).device

    def run(packed, starts, n_starts, seed, it0):
        packed = from_wire_format(packed)
        gen = torch.Generator(device=device)
        out = []
        for i in range(inner_steps):
            it = it0 + i
            with span("train.sample"):
                gen.manual_seed(step_seed(seed, it))
                if sharded_data:
                    x = sample_segments_sharded(packed, starts, seg, b, seed, it, mesh)
                else:
                    x = sample_segments(packed, starts, seg, b, gen, n_starts, mesh)
                lam = kl_lambda(it, cfg.loss.lambda_kl, cfg.annealing_iters)
            m = step(x, lam, generator=gen)
            out.append(torch.stack([m["loss"], m["loss_rec"], m["loss_kl"], m["grad_norm"]]))
        return torch.stack(out)

    if padded_starts:
        return run
    return lambda packed, starts, seed, it0: run(packed, starts, None, seed, it0)


def make_eval_step(
    cfg: TrainConfig, model: AE, mesh: Optional[Mesh] = None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``eval_step(x, lambda_kl) -> {loss_rec, loss_kl, loss}``: the model in
    eval mode (no dropout, ``weight_u`` untouched), no gradients, and the
    VAE draw from a generator seeded 0 on every call, so the same batch
    always gives the same losses. The model's mode is restored.

    With ``mesh``, ``x`` is this rank's rows of the global batch: the draw
    is made at the global shape and the losses are averaged over the
    ranks, so every rank returns the one-process losses."""
    lambda_rec = cfg.loss.lambda_rec

    def eval_step(x, lambda_kl):
        was_training = model.training
        model.eval()
        try:
            x = from_wire_format(x)
            gen = torch.Generator(device=x.device).manual_seed(0)
            rows = None if mesh is None else row_window(mesh, x.shape[0])
            with torch.no_grad():
                loss_rec, loss_kl, _ = loss_terms(model, cfg, x, generator=gen, rows=rows)
                if mesh is not None:
                    loss_rec, loss_kl = all_reduce_mean(mesh, torch.stack([loss_rec, loss_kl]))
        finally:
            model.train(was_training)
        return {
            "loss_rec": loss_rec,
            "loss_kl": loss_kl,
            "loss": lambda_rec * loss_rec + lambda_kl * loss_kl,
        }

    return eval_step
