"""The training and evaluation steps.

One training step is: forward with the VAE sampling, ``loss = lambda_rec *
L1(dec, x) + lambda_kl * KL``, backward, the gradients' global norm before
clipping (the ``grad_norm`` metric), the optimiser (clip, L2 weight decay,
Adam / AMSGrad; train/optim.py). With spectral norm the stored ``u`` of
every decoder layer advances once per step from the weights the step
started with, before the optimiser changes them. The metrics come back as
tensors on the model's device: nothing in the step waits for the device.

``make_device_data_train_step`` runs several such steps per call on a
device-resident corpus, drawing each step's batch on the device. On a CUDA
device without a mesh it captures one whole step (draw, forward, loss,
backward, spectral-norm update, clip, optimiser) in a CUDA graph and
replays it for the later steps (``StepGraph``): the host then issues a
seed, two copies and a replay a step instead of the step's ~2,100
operations.

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

import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from ..core.config import TrainConfig
from ..core.mesh import Mesh, all_reduce_mean, row_window
from ..data.device_sampler import sample_segments
from ..data.sharded import sample_segments_sharded
from ..models.ae import AE
from ..models.modules import spectral_norm_update
from ..utils.profiling import span
from .optim import TorchAdam, bias_correction_operands, kl_lambda


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
    """``step(x, lambda_kl, eps=None, generator=None, bias_corrections=None)
    -> metrics`` with the keys loss, loss_rec, loss_kl, grad_norm (the norm
    before clipping) as tensors on the model's device. ``eps`` is the VAE's
    normal draw; without it the draw comes from ``generator``, which also
    feeds dropout. ``lambda_kl`` is a float, or a 0-dim f32 tensor on the
    device, and ``bias_corrections`` Adam's two bias corrections as two such
    tensors (train/optim.py ``bias_correction_operands``; None: from the
    optimiser's step count), so that a CUDA graph of the step reads both
    anew at every replay.

    With ``mesh``, ``x`` (and ``eps``, when given) are this rank's rows of
    the global batch (rows ``r * B_local`` onward at data index ``r``): the
    draws are made at the global shape, the gradients and the losses are
    averaged over the ranks (the module docstring), and every rank returns
    the global batch's metrics."""
    sn = cfg.model.decoder.sn
    lambda_rec = cfg.loss.lambda_rec

    def step(x, lambda_kl, eps=None, generator=None, bias_corrections=None):
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
            if bias_corrections is None:
                grad_norm = optimizer.step()
            else:
                grad_norm = optimizer.step(bias_corrections=bias_corrections)
        return {"loss": loss, "loss_rec": loss_rec, "loss_kl": loss_kl, "grad_norm": grad_norm}

    return step


def step_seed(seed: int, iteration: int) -> int:
    """The seed of one step's random draws, a pure function of the run's
    seed and the iteration, so a resumed run draws what the continuous run
    drew."""
    ss = np.random.SeedSequence([seed + 1, iteration])
    return int(ss.generate_state(1, np.uint64)[0])


def step_scalars(
    it0: int, t0: int, n: int, lambda_kl: float, annealing_iters: int, betas, device: torch.device
) -> torch.Tensor:
    """(n, 3) f32 on the host: row ``i`` holds step ``it0 + i``'s KL weight
    and Adam's two bias corrections at ``t = t0 + 1 + i`` (``t0`` the
    optimiser's step count before the call) as the eager step applies them
    on ``device`` (train/optim.py ``bias_correction_operands``), each taken
    in Python floats and rounded to f32 as the eager step's kernels round
    them."""
    return torch.tensor(
        [[kl_lambda(it0 + i, lambda_kl, annealing_iters),
          *bias_correction_operands(betas, t0 + 1 + i, device)] for i in range(n)],
        dtype=torch.float32,
    )


def graph_eligible(device: torch.device, mesh: Optional[Mesh], padded_starts: bool) -> bool:
    """Whether a multi-step may replay its step as a CUDA graph: on a CUDA
    device, without a mesh (its collectives stage through the host;
    ``sharded_data`` needs one) and without padded starts (data/chunked.py
    alternates chunk buffers, and times a call to choose ``chunk_repeats``)."""
    return device.type == "cuda" and mesh is None and not padded_starts


def _backend_flags() -> tuple:
    """The settings that choose the step's kernels when it is captured."""
    cudnn = torch.backends.cudnn
    return (cudnn.enabled, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            torch.get_float32_matmul_precision())


class StepGraph:
    """One training step captured in a CUDA graph and replayed by a
    multi-step (``make_device_data_train_step``).

    The multi-step's first call runs eagerly: it makes the optimiser's state
    and cuDNN's plans. The next captures one step (the draw, the step of
    ``make_train_step``, the metrics) on a side stream into the graph's own
    memory pool, then replays it for each of its steps. A replayed step is:
    seed the multi-step's generator (registered with the graph, so a replay
    draws what an eager step seeded alike draws), copy the step's row of
    the call's ``step_scalars`` table (one host-to-device copy a call) into
    the graph's input, replay, copy the four metrics into the call's output.
    The table holds the bias corrections in the form the eager step's float
    arithmetic applies them, so a replayed step equals an eager one bit for
    bit. The optimiser's host step count advances by the steps replayed, so
    its ``state_dict`` is what eager steps leave.

    The graph is keyed on the tensors it reads by address (the corpus, its
    starts, the parameters, the optimiser's state) and on the backend flags
    that chose its kernels. A call with another key captures anew once;
    after that the multi-step stays eager. A call stays eager, the graph
    kept, while an optimiser step hook is registered (its host code would
    run once, at the capture), and a capture waits for a call with no
    profiler recording. A capture that fails warns and leaves the
    multi-step eager.
    """

    def __init__(self, body, model: AE, optimizer: TorchAdam, generator: torch.Generator,
                 inner_steps: int, cfg: TrainConfig):
        self.body, self.opt, self.gen, self.inner_steps = body, optimizer, generator, inner_steps
        self.params = list(model.parameters())
        self.kl = (cfg.loss.lambda_kl, cfg.annealing_iters)
        self.warm = False  # an eager call has run
        self.off = False  # eager from now on
        self.recaptures = 1
        self.graph = self.key = self.row = self.out = None

    def _key(self, packed: torch.Tensor, starts: torch.Tensor) -> tuple:
        state = [v for st in self.opt.state.values() for v in st.values() if torch.is_tensor(v)]
        return (
            (packed.data_ptr(), packed.shape, packed.dtype, starts.data_ptr(), starts.shape),
            tuple(t.data_ptr() for t in self.params + state),
            _backend_flags(),
        )

    def _hooked(self) -> bool:
        from torch.optim import optimizer as torch_optimizer

        return bool(
            self.opt._optimizer_step_pre_hooks or self.opt._optimizer_step_post_hooks
            or torch_optimizer._global_optimizer_pre_hooks
            or torch_optimizer._global_optimizer_post_hooks
        )

    def mode(self, key, can_capture: bool) -> str:
        """``"eager"``, ``"capture"`` or ``"replay"`` for a call on inputs
        ``key``; ``can_capture`` is false while a capture is unsafe."""
        if self.off or not self.warm:
            self.warm = True
            return "eager"
        if self.graph is not None and key == self.key:
            return "replay"
        if not can_capture:
            return "eager"
        if self.graph is not None:
            self.graph = self.out = None
            if not self.recaptures:
                self.off = True
                return "eager"
            self.recaptures -= 1
        return "capture"

    def _capture(self, packed: torch.Tensor, starts: torch.Tensor) -> bool:
        dev = packed.device
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        steps = [(st, st["step"]) for st in self.opt.state.values()]
        row = torch.zeros(3, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    out = self.body(packed, starts, row[0], (row[1], row[2]))
                finally:
                    graph.capture_end()
        except RuntimeError as exc:
            warnings.warn(f"the training step could not be captured in a CUDA graph, "
                          f"so the multi-step runs eagerly: {exc}")
            self.off = True
            return False
        finally:
            for st, n in steps:  # the capture ran the optimiser's host code once
                st["step"] = n
        self.graph, self.row, self.out = graph, row, out
        return True

    def __call__(self, packed: torch.Tensor, starts: torch.Tensor, seed: int, it0: int):
        """The call's (inner_steps, 4) metrics, or None where it runs eagerly."""
        if self.off:
            return None
        t0 = self.opt.step_count()
        if t0 is None or len(self.opt.param_groups) != 1 or self._hooked():
            self.warm = True
            return None
        key = self._key(packed, starts)
        mode = self.mode(key, can_capture=not _autograd_profiler._is_profiler_enabled)
        if mode == "eager" or (mode == "capture" and not self._capture(packed, starts)):
            return None
        self.key = key
        n, dev = self.inner_steps, packed.device
        table = step_scalars(it0, t0, n, *self.kl, self.opt.param_groups[0]["betas"], dev)
        if dev.type == "cuda":
            table = table.pin_memory().to(dev, non_blocking=True)
        out = torch.empty(n, 4, device=dev)
        for i in range(n):
            with span("train.replay"):
                self.gen.manual_seed(step_seed(seed, it0 + i))
                self.row.copy_(table[i])
                self.graph.replay()
                out[i].copy_(self.out)
        self.opt.advance(n)
        return out


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

    Random draws: step ``i`` seeds the multi-step's generator on the device
    with ``step_seed(seed, it0 + i)``. The batch's positions are its first
    draw (``draw_indices``: ``batch_size`` 62-bit integers), and the VAE's
    ``eps`` and any dropout masks follow in the same stream; the generator's
    state advances past every draw, so the two never share random bits. A
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

    Where ``graph_eligible`` holds, the steps after the first call are
    replays of one CUDA graph (``StepGraph``, reachable as the function's
    ``step_graph``; None where the steps always run eagerly), equal to the
    eager steps bit for bit.
    """
    if sharded_data and mesh is None:
        raise ValueError("sharded_data requires a mesh")
    if sharded_data and padded_starts:
        raise NotImplementedError("sharded_data with padded_starts")
    step = make_train_step(cfg, model, optimizer, mesh)
    b = cfg.data_loader.batch_size
    seg = cfg.data_loader.segment_size
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)

    def body(packed, starts, lam, bias_corrections):
        x = sample_segments(packed, starts, seg, b, gen)
        m = step(x, lam, generator=gen, bias_corrections=bias_corrections)
        return torch.stack([m["loss"], m["loss_rec"], m["loss_kl"], m["grad_norm"]])

    graph = None
    if graph_eligible(device, mesh, padded_starts):
        graph = StepGraph(body, model, optimizer, gen, inner_steps, cfg)

    def run(packed, starts, n_starts, seed, it0):
        packed = from_wire_format(packed)
        if graph is not None:
            out = graph(packed, starts, seed, it0)
            if out is not None:
                return out
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

    call = run if padded_starts else (lambda packed, starts, seed, it0: run(packed, starts, None, seed, it0))
    call.step_graph = graph
    return call


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
