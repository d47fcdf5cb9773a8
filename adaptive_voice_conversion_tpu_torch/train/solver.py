"""Training orchestration, on one GPU or data-parallel over ranks.

- the step (train/step.py) never waits for the device; metrics are fetched
  only every ``summary_steps``
- ``input_mode`` picks the data path, by the JAX package's rule: ``auto`` is
  ``device`` when the corpus (in the dtype it would take on the device) fits
  ``device_data_budget_bytes``, ``device_sharded`` when it fits the budget
  of all ``n_data`` ranks together, and ``chunked`` above that;
  ``device_sharded`` with ``n_data`` < 2 runs as ``device``
  - ``device``: the corpus resident on the GPU (on every rank's), batches
    drawn there, and ``inner_steps`` steps per call (data/device_sampler.py)
  - ``device_sharded``: each rank holds one shard of the corpus and draws
    its rows of every batch from it (data/sharded.py)
  - ``chunked``: the corpus streamed in fixed-size chunks, the next one
    crossing while the current one trains (data/chunked.py); with a mesh
    each rank copies a part of each chunk and the ranks gather the rest
  - ``host``: a seeded resumable cursor (data/loader.py) gathered on a host
    thread and copied ahead on a side stream; with a mesh each rank
    gathers its rows of every global batch
- with a mesh (core/mesh.py, one process per GPU), the parameters start
  from rank 0's, the gradients are averaged over the ranks every step, and
  every rank computes the one-process metrics; rank 0 alone logs, prints,
  saves the config and writes checkpoints, and in-training evaluation is
  skipped (``evaluate`` runs on every rank, with no collective)
- checkpoints are rolling step checkpoints with optimiser state and the
  iteration; resume continues the exact segment sequence and the exact
  per-step random draws, in every mode
"""

from __future__ import annotations

import contextlib
import copy
import os
import pickle
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.config import TrainConfig, save_config
from ..core.device import DeviceLike, resolve_device
from ..core.mesh import Mesh, all_reduce_max, replicate_pytree
from ..data.chunked import ChunkedDeviceStreamer
from ..data.chunked import stream_visits
from ..data.dataset import SegmentDataset
from ..data.device_sampler import DeviceResidentDataset
from ..data.sharded import ShardedDeviceDataset
from ..data.loader import batch_iterator, device_prefetch
from ..models.ae import AE, count_params
from ..models.modules import init_parameters
from .checkpoint import CheckpointManager
from .logger import Logger
from .optim import kl_lambda, make_train_optimizer
from .step import make_device_data_train_step, make_eval_step, make_train_step, step_seed

MODES = ("auto", "device", "device_sharded", "chunked", "host")


@dataclass
class SolverArgs:
    """Run arguments (the reference's flag surface)."""

    data_dir: str = "."
    train_set: str = "train_128"
    train_index_file: str = "train_samples_128.json"
    logdir: str = "log"
    store_model_path: str = "ckpt"
    load_model_path: str = ""
    load_model: bool = False
    summary_steps: int = 100
    save_steps: int = 5000
    tag: str = "init"
    seed: int = 0
    # In-training evaluation cadence. eval_steps=0 disables; eval_set names
    # the split pickle ("in_test"); the index file defaults to the
    # pipeline's {eval_set}_samples_{segment_size}.json. Each eval also
    # emits one converted audio sample from a fixed (source, target)
    # utterance pair of the eval split.
    eval_steps: int = 0
    eval_set: str = ""
    eval_index_file: str = ""
    eval_max_batches: int = 20
    eval_audio: bool = True
    eval_audio_gl_iters: int = 30


class Solver:
    def __init__(
        self, config: TrainConfig, args: SolverArgs, device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ):
        """``device`` defaults to ``cuda`` (the rank's GPU under a process
        group) and raises without a GPU; pass ``"cpu"`` to train on the CPU.
        ``mesh``: train data-parallel over its ranks (the module
        docstring)."""
        self.config = config
        self.args = args
        self.device = resolve_device(device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.logger = Logger(args.logdir)
        self.iteration = 0
        self._mngr: Optional[CheckpointManager] = None
        self._eval_ds_cache: dict = {}
        self._eval_fn = None
        self._audio_convert = None
        self._chunk_repeats_resolved: Optional[int] = None

        self._load_data()
        self._build_model()
        self._save_config()
        if args.load_model:
            self.load_model()

    # -- setup ------------------------------------------------------------

    def _load_data(self) -> None:
        a, c = self.args, self.config
        if c.input_mode not in MODES:
            raise ValueError(f"input_mode={c.input_mode!r}: expected one of {MODES}")
        self.dataset = SegmentDataset(
            os.path.join(a.data_dir, f"{a.train_set}.pkl"),
            os.path.join(a.data_dir, a.train_index_file),
            segment_size=c.data_loader.segment_size,
            storage_dtype=c.data_dtype,
        )
        dtype = "bfloat16" if "bfloat16" in (c.data_dtype, c.compute_dtype) else "float32"
        itemsize = 2 if dtype == "bfloat16" else 4
        wire_bytes = int(self.dataset.packed.size) * itemsize
        n_data = self.mesh.n_data if self.mesh is not None else 1
        mode = c.input_mode
        if mode == "auto":
            if wire_bytes <= c.device_data_budget_bytes:
                mode = "device"
            elif n_data > 1 and wire_bytes <= c.device_data_budget_bytes * n_data:
                mode = "device_sharded"
            else:
                mode = "chunked"
        if mode == "device_sharded" and n_data < 2:
            mode = "device"  # the JAX rule: no data axis to shard over
        self.data_mode = mode
        self.device_data = None
        self.chunked: Optional[ChunkedDeviceStreamer] = None
        if mode == "device":
            self.device_data = DeviceResidentDataset(self.dataset, self.device, dtype=dtype)
        elif mode == "device_sharded":
            self.device_data = ShardedDeviceDataset(self.dataset, self.mesh, self.device, dtype=dtype)
        elif mode == "chunked":
            self.chunked = ChunkedDeviceStreamer(
                self.dataset,
                chunk_bytes=c.chunk_bytes or c.device_data_budget_bytes // 3,
                batch_size=c.data_loader.batch_size,
                inner_steps=c.inner_steps,
                seed=a.seed,
                # "auto" is measured at training start (_resolve_chunk_repeats)
                repeats=1 if c.chunk_repeats == "auto" else c.chunk_repeats,
                device=self.device,
                mesh=self.mesh,
            )

    def _build_model(self) -> None:
        c = self.config
        # a CPU generator, so a seed gives the same weights on every device
        gen = torch.Generator().manual_seed(self.args.seed)
        self.model = AE(c.model)
        init_parameters(self.model, gen)
        self.model.to(self.device)
        self.optimizer = self._make_optimizer(self.model)
        if self.mesh is not None:
            # every rank starts from rank 0's parameters, buffers and
            # optimiser state
            replicate_pytree([self.model.state_dict(), list(self.optimizer.state.values())], self.mesh)
        self.step_fn = make_train_step(c, self.model, self.optimizer, self.mesh)
        self._multi_steps: dict = {}
        self.n_params = count_params(self.model)

    def _make_optimizer(self, model: AE):
        return make_train_optimizer(self.config, model.parameters())

    def _make_multi_step(self, inner_steps: int, model=None, optimizer=None):
        return make_device_data_train_step(
            self.config,
            self.model if model is None else model,
            self.optimizer if optimizer is None else optimizer,
            inner_steps=inner_steps,
            padded_starts=self.data_mode == "chunked",
            sharded_data=self.data_mode == "device_sharded",
            mesh=self.mesh,
        )

    def _multi_step(self, k: int):
        """The multi-step function for calls of ``k`` steps: ``inner_steps``,
        or the remainder at the end of a run or a chunk's visit."""
        if k not in self._multi_steps:
            self._multi_steps[k] = self._make_multi_step(k)
        return self._multi_steps[k]

    def _save_config(self) -> None:
        if not self.is_main:
            return
        os.makedirs(os.path.dirname(self.args.store_model_path) or ".", exist_ok=True)
        save_config(self.config, f"{self.args.store_model_path}.config.yaml")

    @staticmethod
    def checkpoint_dir(path: str) -> str:
        return f"{path}.ckpts"

    # -- checkpointing ----------------------------------------------------

    def save_model(self, iteration: int) -> None:
        if self._mngr is None:
            self._mngr = CheckpointManager(
                self.checkpoint_dir(self.args.store_model_path), mesh=self.mesh
            )
        extra = {"iteration": iteration + 1, "seed": self.args.seed}
        if self._chunk_repeats_resolved is not None:
            # the visit schedule depends on it: a resumed run replays it
            extra["chunk_repeats"] = int(self._chunk_repeats_resolved)
        self._mngr.save(
            iteration + 1, self.model.state_dict(), self.optimizer.state_dict(), extra
        )

    def load_model(self) -> None:
        """Every rank restores the newest checkpoint (the ranks' states are
        equal, so this keeps them so)."""
        path = self.args.load_model_path or self.args.store_model_path
        mngr = CheckpointManager(self.checkpoint_dir(path), mesh=self.mesh)
        model_state, opt_state, extra = mngr.restore()
        self.model.load_state_dict(model_state, strict=True)
        self.optimizer.load_state_dict(opt_state)
        self.iteration = int(extra["iteration"])
        if "chunk_repeats" in extra:
            self._chunk_repeats_resolved = int(extra["chunk_repeats"])
        mngr.close()

    # -- evaluation -------------------------------------------------------

    def _eval_dataset(self, eval_set: str, eval_index_file: str) -> SegmentDataset:
        """The eval split's SegmentDataset, cached: the in-training cadence
        must not unpickle the split at every eval."""
        a, c = self.args, self.config
        key = (eval_set, eval_index_file)
        if key not in self._eval_ds_cache:
            self._eval_ds_cache[key] = SegmentDataset(
                os.path.join(a.data_dir, f"{eval_set}.pkl"),
                os.path.join(a.data_dir, eval_index_file),
                segment_size=c.data_loader.segment_size,
                storage_dtype=c.data_dtype,
            )
        return self._eval_ds_cache[key]

    def evaluate(
        self,
        eval_set: str,
        eval_index_file: str,
        max_batches: int = 20,
        iteration: Optional[int] = None,
    ) -> dict:
        """Deterministic held-out loss on an in_test / out_test split:
        the mean loss terms over up to ``max_batches`` batches in a fixed
        order, with lambda_KL at ``iteration`` (the current training step
        when an in-training hook passes it; ``self.iteration`` otherwise,
        which only advances when ``train`` returns)."""
        c = self.config
        ds = self._eval_dataset(eval_set, eval_index_file)
        if self._eval_fn is None:
            self._eval_fn = make_eval_step(c, self.model)
        bs = c.data_loader.batch_size
        n = min(max_batches, len(ds) // bs)
        it = self.iteration if iteration is None else iteration
        lam = kl_lambda(it, c.loss.lambda_kl, c.annealing_iters)
        sums = None
        order = np.random.default_rng(0).permutation(len(ds))
        for i in range(n):
            idx = order[i * bs : (i + 1) * bs]
            x = torch.from_numpy(ds.gather(np.sort(idx))).to(self.device)
            m = {k: float(v) for k, v in self._eval_fn(x, lam).items()}
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return {k: v / max(n, 1) for k, v in (sums or {}).items()}

    def _eval_hook(self, it: int) -> None:
        """Periodic in-training evaluation: eval losses to the logs under
        ``{tag}/ae_eval_{split}`` plus one fixed (source, target) conversion
        sample per eval, so a run shows converted audio and not only curves."""
        a, c = self.args, self.config
        if not a.eval_set or self.mesh is not None and self.mesh.world_size > 1:
            # as the JAX Solver: a multi-process run evaluates after training
            return
        idx = a.eval_index_file or f"{a.eval_set}_samples_{c.data_loader.segment_size}.json"
        m = self.evaluate(a.eval_set, idx, max_batches=a.eval_max_batches, iteration=it)
        self.logger.scalars_summary(f"{a.tag}/ae_eval_{a.eval_set}", m, it)
        if a.eval_audio:
            self._emit_audio_sample(it, a.eval_set, idx)

    def _build_audio_convert(self):
        """(x, x_cond) normalised mels (1, T, n_mels) on the device -> wav
        tensor: conversion, denormalisation by attr.pkl **before**
        ``mel_to_mag`` (the dB inversion and clip expect the (0, 1]
        normalised-mel space, and training data is z-normalised with the
        attr statistics), exact Griffin-Lim, de-emphasis."""
        from ..dsp.audio import deemphasis_torch
        from ..dsp.vocoder import griffin_lim, mel_to_mag

        c = self.config
        n_iter = self.args.eval_audio_gl_iters
        attr_path = os.path.join(self.args.data_dir, "attr.pkl")
        if os.path.exists(attr_path):
            with open(attr_path, "rb") as f:
                attr = pickle.load(f)
            mean = torch.as_tensor(np.asarray(attr["mean"], np.float32), device=self.device)
            std = torch.as_tensor(np.asarray(attr["std"], np.float32), device=self.device)
        else:
            mean = torch.zeros(c.signal.n_mels, device=self.device)
            std = torch.ones(c.signal.n_mels, device=self.device)

        def convert(x: torch.Tensor, x_cond: torch.Tensor) -> torch.Tensor:
            was_training = self.model.training
            self.model.eval()
            try:
                with torch.no_grad():
                    dec = self.model.inference(x, x_cond)[0] * std + mean
                    mag = mel_to_mag(dec, c.signal)
                    wav = griffin_lim(mag, c.signal, n_iter=n_iter, method="exact")
                    return deemphasis_torch(wav, c.signal.preemphasis)
            finally:
                self.model.train(was_training)

        return convert

    def _emit_audio_sample(self, it: int, eval_set: str, idx: str) -> None:
        """Convert one fixed eval-split pair (utterance 0's content to
        utterance -1's speaker) and log it through ``audio_summary``."""
        c = self.config
        if c.model.decoder.c_out != c.signal.n_mels:
            return  # mel dim mismatch between model and signal config
        ds = self._eval_dataset(eval_set, idx)
        if len(ds.utt_ids) < 2:
            return
        src = ds.get_utterance(ds.utt_ids[0])
        tar = ds.get_utterance(ds.utt_ids[-1])
        if self._audio_convert is None:
            self._audio_convert = self._build_audio_convert()
        sub = int(np.prod(c.model.content_encoder.subsample))
        src = np.pad(src, ((0, (-src.shape[0]) % sub), (0, 0)))
        to_dev = lambda m: torch.from_numpy(np.ascontiguousarray(m[None])).to(self.device)
        wav = self._audio_convert(to_dev(src), to_dev(tar)).cpu().numpy().astype(np.float32)
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / max(peak, 1.0)  # clip guard for playback
        self.logger.audio_summary(
            f"{self.args.tag}/conversion_{eval_set}", wav, it, c.signal.sr
        )

    # -- training ---------------------------------------------------------

    def train(self, n_iterations: int, log_every_print: bool = True) -> dict:
        log_every_print = log_every_print and self.is_main
        if self.data_mode in ("device", "device_sharded"):
            return self._train_device(n_iterations, log_every_print)
        if self.data_mode == "chunked":
            return self._train_chunked(n_iterations, log_every_print)
        return self._train_host(n_iterations, log_every_print)

    def _audio_s_per_batch(self) -> float:
        c = self.config
        return (
            c.data_loader.batch_size * c.data_loader.segment_size * c.signal.hop_length / c.signal.sr
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _after_multi_step(
        self, ms: torch.Tensor, it: int, k: int, end: int, steps_done: int, t_start: float,
        log_every_print: bool,
    ) -> Optional[dict]:
        """Summary, save and eval for a call that ran steps [it - k, it): each
        lands on the first call boundary at or after its cadence's multiple
        (the JAX package's arithmetic). Returns the summary row if one was
        logged."""
        a = self.args
        m = None
        if (it - 1) // a.summary_steps != (it - k - 1) // a.summary_steps or it == end:
            loss, loss_rec, loss_kl, grad_norm = ms[-1].tolist()
            m = {
                "loss": loss, "loss_rec": loss_rec, "loss_kl": loss_kl, "grad_norm": grad_norm,
                "audio_sec_per_sec": steps_done * self._audio_s_per_batch()
                / max(time.time() - t_start, 1e-9),
            }
            self.logger.scalars_summary(f"{a.tag}/ae_train", m, it - 1)
            if log_every_print:
                print(
                    f"AE:[{it}/{end}], loss_rec={m['loss_rec']:.2f}, "
                    f"loss_kl={m['loss_kl']:.2f}, {m['audio_sec_per_sec']:.0f} audio-s/s",
                    end="\r",
                )
        if it // a.save_steps != (it - k) // a.save_steps or it == end:
            self.save_model(it - 1)
        if a.eval_steps and (it // a.eval_steps != (it - k) // a.eval_steps or it == end):
            self._eval_hook(it - 1)
        return m

    def _finish(self, end: int) -> None:
        self.iteration = end
        if self._mngr is not None:
            self._mngr.wait()
        self._sync()

    def _train_device(self, n_iterations: int, log_every_print: bool) -> dict:
        """Device-resident corpus: ``inner_steps`` steps per call, each
        drawing its batch on the device; summaries, saves and evals land on
        call boundaries."""
        K = self.config.inner_steps
        packed, starts = self.device_data.packed, self.device_data.starts
        t_start = time.time()
        it, end = self.iteration, self.iteration + n_iterations
        steps_done = 0
        last = None
        while it < end:
            k = min(K, end - it)
            ms = self._multi_step(k)(packed, starts, self.args.seed, it)
            it += k
            steps_done += k
            last = self._after_multi_step(ms, it, k, end, steps_done, t_start, log_every_print) or last
        self._finish(end)
        return last or {}

    def _resolve_chunk_repeats(self) -> None:
        """``chunk_repeats: auto``: time a chunk's transfer and one
        multi-step call, then take ``choose_repeats`` of the two. The probe
        runs on copies of the model and the optimiser state, so training
        state is untouched; the chosen value is kept in every checkpoint and
        a resumed run replays it (the visit plan depends on it) instead of
        measuring again."""
        c = self.config
        if self.chunked is None or c.chunk_repeats != "auto":
            return
        if self._chunk_repeats_resolved is not None:
            self.chunked.set_repeats(self._chunk_repeats_resolved)
            return
        # the first transfer allocates pinned and device memory: time the second
        self.chunked.put_chunk(0).acquire()
        self._sync()
        t0 = time.perf_counter()
        chunk = self.chunked.put_chunk(0).acquire()
        self._sync()
        bw = self.chunked.chunk_nbytes() / max(time.perf_counter() - t0, 1e-9)
        model = copy.deepcopy(self.model)
        opt = self._make_optimizer(model)
        opt.load_state_dict(copy.deepcopy(self.optimizer.state_dict()))
        probe = self._make_multi_step(c.inner_steps, model, opt)
        args = (chunk.packed, chunk.starts, chunk.n_starts, self.args.seed, 0)
        probe(*args)  # warm-up: cuDNN's algorithm search, first allocations
        self._sync()
        t0 = time.perf_counter()
        probe(*args)
        self._sync()
        t_step = (time.perf_counter() - t0) / c.inner_steps
        del model, opt, probe
        r = self.chunked.choose_repeats(t_step, bw)
        if self.mesh is not None:
            # every rank must follow the same schedule: the largest choice
            r = all_reduce_max(self.mesh, r)
        self._chunk_repeats_resolved = r
        self.chunked.set_repeats(r)
        if self.is_main:
            print(
                f"chunk_repeats=auto -> {r} (H2D {bw / 1e6:.1f} MB/s, step "
                f"{t_step * 1e3:.2f} ms, need {self.chunked.required_bandwidth(t_step) / 1e6:.1f} MB/s)",
                flush=True,
            )

    def _train_chunked(self, n_iterations: int, log_every_print: bool) -> dict:
        """Corpora over the device budget: the chunk schedule of
        data/chunked.py through ``stream_visits``, which starts the next
        chunk's transfer on a thread before the current chunk's steps are
        queued, so the two overlap."""
        self._resolve_chunk_repeats()
        K = self.config.inner_steps
        t_start = time.time()
        end = self.iteration + n_iterations
        steps_done = 0
        last = None
        visits = stream_visits(self.chunked, self.chunked.schedule(self.iteration, n_iterations))
        with contextlib.closing(visits):
            for v, chunk in visits:
                packed, starts, n_starts = chunk[:3]
                it, endv = v.it0, v.it0 + v.k
                while it < endv:
                    k = min(K, endv - it)
                    ms = self._multi_step(k)(packed, starts, n_starts, self.args.seed, it)
                    it += k
                    steps_done += k
                    last = self._after_multi_step(
                        ms, it, k, end, steps_done, t_start, log_every_print
                    ) or last
        self._finish(end)
        return last or {}

    def _train_host(self, n_iterations: int, log_every_print: bool = True) -> dict:
        c, a = self.config, self.args
        batches = device_prefetch(
            batch_iterator(
                self.dataset,
                c.data_loader.batch_size,
                frame_size=c.data_loader.frame_size,
                shuffle=c.data_loader.shuffle,
                seed=a.seed,
                start_step=self.iteration,
                host_index=self.mesh.data_index if self.mesh is not None else 0,
                host_count=self.mesh.n_data if self.mesh is not None else 1,
            ),
            self.device,
        )
        gen = torch.Generator(device=self.device)
        audio_s_per_batch = self._audio_s_per_batch()
        end = self.iteration + n_iterations
        t_start = time.time()
        metrics: dict = {}
        steps_done = 0
        try:
            for it in range(self.iteration, end):
                lam = kl_lambda(it, c.loss.lambda_kl, c.annealing_iters)
                x = next(batches)
                gen.manual_seed(step_seed(a.seed, it))
                metrics = self.step_fn(x, lam, generator=gen)
                steps_done += 1
                if it % a.summary_steps == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    elapsed = time.time() - t_start
                    m["audio_sec_per_sec"] = steps_done * audio_s_per_batch / max(elapsed, 1e-9)
                    self.logger.scalars_summary(f"{a.tag}/ae_train", m, it)
                    if log_every_print:
                        print(
                            f"AE:[{it + 1}/{end}], "
                            f"loss_rec={m['loss_rec']:.2f}, loss_kl={m['loss_kl']:.2f}, "
                            f"lambda={lam:.1e}, {m['audio_sec_per_sec']:.0f} audio-s/s",
                            end="\r",
                        )
                if (it + 1) % a.save_steps == 0 or it + 1 == end:
                    self.save_model(it)
                if a.eval_steps and ((it + 1) % a.eval_steps == 0 or it + 1 == end):
                    self._eval_hook(it)
        finally:
            batches.close()
        self._finish(end)
        return {
            **{k: float(v) for k, v in metrics.items()},
            "audio_sec_per_sec": steps_done * audio_s_per_batch
            / max(time.time() - t_start, 1e-9),
        }
