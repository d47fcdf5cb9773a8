"""Training orchestration on one device.

- the step (train/step.py) never waits for the device; metrics are fetched
  only every ``summary_steps``
- the data path is a seeded resumable cursor (data/loader.py) gathered on a
  host thread and copied ahead on a side stream
- checkpoints are rolling step checkpoints with optimiser state and the
  iteration; resume continues the exact segment sequence and the exact
  per-step random draws

Only ``input_mode: host`` runs so far. ``auto`` resolves to ``host``;
``device``, ``device_sharded`` and ``chunked`` raise until the
device-resident sampler and the chunk streamer are ported (ROADMAP item 9).
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.config import TrainConfig, config_to_dict
from ..core.device import DeviceLike, resolve_device
from ..data.dataset import SegmentDataset
from ..data.loader import batch_iterator, device_prefetch
from ..models.ae import AE, count_params
from ..models.modules import init_parameters
from .checkpoint import CheckpointManager
from .logger import Logger
from .optim import kl_lambda, make_optimizer
from .step import make_eval_step, make_train_step

UNPORTED_MODES = ("device", "device_sharded", "chunked")


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


def step_seed(seed: int, iteration: int) -> int:
    """The seed of one step's random draws, a pure function of the run's
    seed and the iteration, so a resumed run draws what the continuous run
    drew."""
    ss = np.random.SeedSequence([seed + 1, iteration])
    return int(ss.generate_state(1, np.uint64)[0])


class Solver:
    def __init__(self, config: TrainConfig, args: SolverArgs, device: DeviceLike = None):
        """``device`` defaults to ``cuda`` and raises without a GPU; pass
        ``"cpu"`` to train on the CPU."""
        self.config = config
        self.args = args
        self.device = resolve_device(device)
        self.logger = Logger(args.logdir)
        self.iteration = 0
        self._mngr: Optional[CheckpointManager] = None
        self._eval_ds_cache: dict = {}
        self._eval_fn = None
        self._audio_convert = None

        self._load_data()
        self._build_model()
        self._save_config()
        if args.load_model:
            self.load_model()

    # -- setup ------------------------------------------------------------

    def _load_data(self) -> None:
        a, c = self.args, self.config
        mode = c.input_mode
        if mode in UNPORTED_MODES:
            raise NotImplementedError(
                f"input_mode={mode!r}: the device-resident, sharded and chunked "
                "data modes are ROADMAP item 9 (slice 5) and are not ported "
                "yet; use input_mode: host"
            )
        if mode == "auto":
            print(
                "input_mode=auto -> host (the device-resident sampler is not "
                "ported yet: every batch is gathered on the host)",
                flush=True,
            )
        self.data_mode = "host"
        self.dataset = SegmentDataset(
            os.path.join(a.data_dir, f"{a.train_set}.pkl"),
            os.path.join(a.data_dir, a.train_index_file),
            segment_size=c.data_loader.segment_size,
            storage_dtype=c.data_dtype,
        )

    def _build_model(self) -> None:
        c = self.config
        # a CPU generator, so a seed gives the same weights on every device
        gen = torch.Generator().manual_seed(self.args.seed)
        self.model = AE(c.model)
        init_parameters(self.model, gen)
        self.model.to(self.device)
        self.optimizer = make_optimizer(
            c.optimizer, self.model.parameters(),
            state_dtype=c.opt_state_dtype, fused=c.opt_fused,
        )
        self.step_fn = make_train_step(c, self.model, self.optimizer)
        self.n_params = count_params(self.model)

    def _save_config(self) -> None:
        import yaml

        os.makedirs(os.path.dirname(self.args.store_model_path) or ".", exist_ok=True)
        with open(f"{self.args.store_model_path}.config.yaml", "w") as f:
            yaml.safe_dump(config_to_dict(self.config), f)

    @staticmethod
    def checkpoint_dir(path: str) -> str:
        return f"{path}.ckpts"

    # -- checkpointing ----------------------------------------------------

    def save_model(self, iteration: int) -> None:
        if self._mngr is None:
            self._mngr = CheckpointManager(self.checkpoint_dir(self.args.store_model_path))
        extra = {"iteration": iteration + 1, "seed": self.args.seed}
        self._mngr.save(
            iteration + 1, self.model.state_dict(), self.optimizer.state_dict(), extra
        )

    def load_model(self) -> None:
        path = self.args.load_model_path or self.args.store_model_path
        mngr = CheckpointManager(self.checkpoint_dir(path))
        step = mngr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.checkpoint_dir(path)}")
        model_state, opt_state, extra = mngr.restore(step)
        self.model.load_state_dict(model_state, strict=True)
        self.optimizer.load_state_dict(opt_state)
        self.iteration = int(extra["iteration"])
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
        if not a.eval_set:
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
        return self._train_host(n_iterations, log_every_print)

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
            ),
            self.device,
        )
        gen = torch.Generator(device=self.device)
        audio_s_per_batch = (
            c.data_loader.batch_size
            * c.data_loader.segment_size
            * c.signal.hop_length
            / c.signal.sr
        )
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
        self.iteration = end
        if self._mngr is not None:
            self._mngr.wait()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {
            **{k: float(v) for k, v in metrics.items()},
            "audio_sec_per_sec": steps_done * audio_s_per_batch
            / max(time.time() - t_start, 1e-9),
        }
