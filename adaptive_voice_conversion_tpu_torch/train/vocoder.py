"""Training the HiFi-GAN V1 vocoder on the port's own features.

The job is jik876/hifi-gan's ``train.py`` (Kong, Kim and Bae,
arXiv:2010.05646) at 24 kHz and hop 300, as ParallelWaveGAN's VCTK recipe
runs it, configured by the ``vocoder_train`` section (core/config.py
``VocoderTrainConfig``): the generator (models/hifigan.py, weight-normed)
against the multi-period and multi-scale discriminators
(models/hifigan_disc.py). One step is, in jik876's order:

1. the batch: ``batch_size`` segments of ``segment_samples`` samples at
   frame-aligned starts, drawn on the device; the generator's input is the
   port's featurizer on each segment (dsp/features.py
   ``mel_from_wave_batched``: pre-emphasis, STFT, 512-bin mel, dB), the
   frames the whole utterance's featurization gives there, z-normalised by
   the attribute file's mean and std, as the served mels are;
2. the discriminators' update: y_hat = G(mel); least-squares loss of both
   discriminators on y and y_hat detached; backward; AdamW;
3. the generator's update: both discriminators again on y and y_hat;
   ``lambda_adv`` x the least-squares adversarial loss + ``lambda_fm`` x
   feature matching + ``lambda_mel`` x the L1 of the log mels of y and
   y_hat; backward; AdamW.

The loss mel is jik876's ``mel_spectrogram``: reflect-pad by (n_fft - hop)
/ 2, frames without centring, magnitude sqrt(re^2 + im^2 + 1e-9), this
system's 512-bin mel basis up to sr / 2, log(max(., 1e-5)). The
discriminators run y's passes of the generator's update without autograd,
and take no weight gradient there (their parameters are frozen for it): the
generator's gradient is jik876's, with less work.

Each network has its own AdamW (``torch.optim.AdamW``, its multi-tensor
form; no clipping), and each lr is ``lr x lr_decay **
epoch`` at the step's epoch (jik876's ``ExponentialLR`` stepped once an
epoch; an epoch is one segment from each utterance: ``steps_per_epoch`` =
ceil(utterances / batch_size)). The lr is set in the optimisers before each
step, so a decayed lr takes effect at the step it belongs to, resumed or
not.

The corpus lives on the device (``WaveCorpus``), as the AE's device mode
keeps its mels, within ``device_data_budget_bytes``; a larger one raises.
``make_vocoder_train_step`` runs ``inner_steps`` steps a call with nothing
synchronised inside; each step's draws come from ``step_seed(seed, it)``
(train/step.py), so a resumed run draws what the continuous one drew. With
``compute_dtype: bfloat16`` both updates run under bf16 autocast.

On a CUDA device the steps after a multi-step's first call are replays of
two CUDA graphs (``GANGraphs``): the host then issues a seed, the two lrs
and two replays a step instead of the step's ~12,000 operations, so the
step runs at the device's pace rather than the host's. The optimisers are
``capturable`` there, with their lr a device tensor that each step fills.
A replayed step equals an eager one bit for bit.

Spans and counters (utils/profiling.py): ``vtrain.sample`` (draw,
featurise, normalise), ``vtrain.disc`` (the generator's forward and the
discriminators' update to its optimiser step), ``vtrain.gen`` (the
generator's update to its optimiser step); ``vtrain.segments`` (segments a
step) and ``vtrain.disc_samples`` (samples the sub-discriminators take a
step, over the four passes). A replayed step has no ``vtrain.sample``
span (its draw is in the first graph, inside ``vtrain.disc``), and its
``vtrain.disc`` and ``vtrain.gen`` hold the host's launch of each graph.

A checkpoint is ParallelWaveGAN's layout: ``{"model": {"generator",
"discriminator"}, "optimizer": {"generator", "discriminator"}, "steps"}``;
its generator loads for serving through models/weights.py
``load_generator``.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
import torch.nn.functional as F

from ..core.config import SignalConfig, TrainConfig, VocoderTrainConfig
from ..core.device import DeviceLike, resolve_device
from ..data.device_sampler import draw_indices
from ..dsp.features import _mel_basis, mel_from_wave_batched
from ..dsp.stft import stft_frames
from ..models.hifigan import Generator, apply_weight_norm
from ..models.hifigan_disc import Discriminator, discriminator_loss, feature_loss, generator_adv_loss
from ..utils.profiling import count, span
from .step import _backend_flags, step_seed

# the columns of a step's row in a multi-step's output
LOSS_NAMES = ("loss_d", "loss_adv", "loss_fm", "loss_mel")


class WaveCorpus:
    """Waves on the device, each reflect-padded by n_fft // 2 at both ends
    (the layout the featurizer frames without centring), packed into one
    f32 vector, with ``starts``: the packed offset of the featurizer's window
    of every frame-aligned segment, frame f of an utterance of L samples for
    every f with f x hop + ``segment_samples`` <= L. The segment itself
    begins n_fft // 2 after its window. Utterances shorter than a segment
    are left out (ParallelWaveGAN's rule)."""

    def __init__(self, waves: Sequence[np.ndarray], sig: SignalConfig, segment_samples: int,
                 device: torch.device, budget_bytes: int):
        pad, hop = sig.n_fft // 2, sig.hop_length
        waves = [np.asarray(w, np.float32) for w in waves if len(w) >= max(segment_samples, pad + 1)]
        if not waves:
            raise ValueError(f"no utterance holds a segment of {segment_samples} samples")
        lens = np.array([len(w) for w in waves], np.int64)
        total = int((lens + 2 * pad).sum())
        if 4 * total > budget_bytes:
            raise ValueError(
                f"the wav corpus takes {4 * total} bytes on the device, over "
                f"device_data_budget_bytes={budget_bytes}: streaming a wav corpus in chunks "
                "is not supported; raise the budget or train on fewer utterances")
        host = np.empty(total, np.float32)
        offsets = np.concatenate([[0], np.cumsum(lens + 2 * pad)[:-1]])
        for o, w in zip(offsets, waves):
            host[o : o + len(w) + 2 * pad] = np.pad(w, pad, mode="reflect")
        counts = (lens - segment_samples) // hop + 1
        first = np.repeat(offsets, counts)
        frame = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        self.packed = torch.from_numpy(host).to(device)
        self.starts = torch.from_numpy(first + frame * hop).to(device)
        self.n_utterances = len(waves)
        self.samples = int(lens.sum())

    def steps_per_epoch(self, batch_size: int) -> int:
        return -(-self.n_utterances // batch_size)


def sample_batch(packed: torch.Tensor, starts: torch.Tensor, vt: VocoderTrainConfig, sig: SignalConfig,
                 generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mel (B, frames, n_mels) in the featurizer's [0, 1] scale, y (B,
    segment_samples)): ``batch_size`` windows of ``WaveCorpus.starts`` drawn
    uniformly (train/step.py's 62-bit draw), pre-emphasised and featurised
    without centring, and the segments they frame."""
    frames, pad = vt.segment_samples // sig.hop_length, sig.n_fft // 2
    sel = draw_indices(starts.shape[0], vt.batch_size, generator)
    width = (frames - 1) * sig.hop_length + sig.n_fft
    win = packed[starts[sel][:, None] + torch.arange(width, device=packed.device)[None, :]]
    pre = torch.cat([win[:, :1], win[:, 1:] - sig.preemphasis * win[:, :-1]], dim=1)
    mel, _ = mel_from_wave_batched(pre, sig, centered=False)
    return mel, win[:, pad : pad + vt.segment_samples]


def log_mel(y: torch.Tensor, sig: SignalConfig) -> torch.Tensor:
    """jik876's ``mel_spectrogram`` of waves (B, T) with this system's STFT
    and mel basis: (B, n_mels, T / hop)."""
    pad = (sig.n_fft - sig.hop_length) // 2
    yp = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.view_as_real(stft_frames(yp, sig.n_fft, sig.hop_length, sig.win_length))
    mag = torch.sqrt(spec.square().sum(-1) + 1e-9)
    basis = _mel_basis(sig.sr, sig.n_fft, sig.n_mels, y.device)
    return torch.log(torch.clamp(torch.matmul(basis, mag), min=1e-5))


def build_models(cfg: TrainConfig, seed: int, device: DeviceLike = None) -> Tuple[Generator, Discriminator]:
    """The weight-normed generator and the discriminators, drawn from
    ``seed`` with PyTorch's default initialisation (and spectral norm's
    normal ``u``, ``v``) on the CPU, then moved to ``device``, in training
    mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = apply_weight_norm(Generator(cfg.vocoder))
        disc = Discriminator(cfg.vocoder_train)
    dev = resolve_device(device)
    return generator.to(dev).train(), disc.to(dev).train()


def make_optimizers(vt: VocoderTrainConfig, generator: Generator, disc: Discriminator):
    """(the generator's AdamW, the discriminators'). On a CUDA device each is
    ``capturable``, its lr a 0-dim f32 tensor on the device, so that a CUDA
    graph of the step holds the optimiser's step and reads the lr anew at
    every replay (``GANGraphs``)."""
    def adamw(module: torch.nn.Module) -> torch.optim.AdamW:
        dev = next(module.parameters()).device
        cuda = dev.type == "cuda"
        opt = torch.optim.AdamW(module.parameters(), lr=torch.tensor(vt.lr, device=dev) if cuda else vt.lr,
                                betas=tuple(vt.betas), eps=vt.eps, weight_decay=vt.weight_decay,
                                foreach=True, capturable=cuda)
        # a multi-step's first call steps eagerly by design: no warning that
        # a capturable optimiser ran outside a capture
        opt._warned_capturable_if_run_uncaptured = True
        return opt

    return adamw(generator), adamw(disc)


def lr_at(vt: VocoderTrainConfig, it: int, steps_per_epoch: int) -> float:
    """The lr of step ``it``: ``lr x lr_decay ** epoch``."""
    return vt.lr * vt.lr_decay ** (it // steps_per_epoch)


def set_lr(optimizers: Sequence[torch.optim.Optimizer], lr: float) -> None:
    """Every group's lr: a tensor lr is filled in place (a graph reads it
    there), a float one replaced."""
    for opt in optimizers:
        for group in opt.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr


def _hooked(optimizers: Sequence[torch.optim.Optimizer]) -> bool:
    """Whether an optimiser step hook is registered: its host code would run
    once, at a capture, and never at a replay."""
    from torch.optim import optimizer as torch_optimizer

    return bool(torch_optimizer._global_optimizer_pre_hooks or torch_optimizer._global_optimizer_post_hooks
                or any(o._optimizer_step_pre_hooks or o._optimizer_step_post_hooks for o in optimizers))


def drop_weight_history(modules: Sequence[torch.nn.Module]) -> None:
    """Detaches the weights that weight norm's and spectral norm's forward
    pre-hooks left on their modules. Each holds the autograd graph of the
    step that computed it, and with it its parameters' gradient
    accumulators, which belong to the stream that step ran on: a capture on
    its own stream has to make its own, and eager steps after it theirs."""
    for root in modules:
        for m in root.modules():
            w = m.__dict__.get("weight")
            if torch.is_tensor(w) and w.grad_fn is not None:
                m.weight = w.detach()


def graph_eligible(device: torch.device) -> bool:
    """Whether a multi-step may replay its steps as CUDA graphs."""
    return device.type == "cuda"


class GANGraphs:
    """The vocoder's training step as two CUDA graphs, replayed by a
    multi-step (``make_vocoder_train_step``).

    ``first(packed, starts)`` is the draw from the multi-step's generator
    (registered with the first graph, so a replay draws what an eager step
    seeded alike draws), the generator's forward and the discriminators'
    update; it returns what ``second`` takes, the generator's update, whose
    backward runs through the first graph's forward. Both graphs share one
    memory pool and are replayed in the order they were captured. A replayed
    step is: seed the generator, fill the lrs, replay both, copy the four
    losses into the call's output.

    The multi-step's first call runs eagerly: it makes the optimisers'
    state and cuDNN's and cuFFT's plans. The next captures one step on a
    side stream, then replays it for each of its steps. The graphs are
    keyed on the tensors they read by address (the corpus, its starts, the
    parameters and buffers, the optimisers' state and lrs) and on the
    backend flags that chose their kernels; a call with another key captures
    anew once, and after that the multi-step stays eager. A call stays eager,
    the graphs kept, while an optimiser step hook is registered or an
    optimiser is not ``capturable`` with a tensor lr, and a capture waits for
    a call with no profiler recording. A capture that fails warns and leaves
    the multi-step eager."""

    def __init__(self, first: Callable, second: Callable, modules: Sequence[torch.nn.Module],
                 optimizers: Sequence[torch.optim.Optimizer], generator: torch.Generator,
                 per_step: Callable[[int], None]):
        self.first, self.second, self.opts, self.gen = first, second, tuple(optimizers), generator
        self.per_step, self.modules = per_step, tuple(modules)
        self.tensors = [t for m in modules for t in list(m.parameters()) + list(m.buffers())]
        self.warm = False  # an eager call has run
        self.off = False  # eager from now on
        self.recaptures = 1
        self.graphs = self.key = self.out = None

    def eligible(self) -> bool:
        """Whether the optimisers can step inside a graph."""
        return all(g["capturable"] and torch.is_tensor(g["lr"]) for o in self.opts for g in o.param_groups)

    def _key(self, packed: torch.Tensor, starts: torch.Tensor) -> tuple:
        state = [v for o in self.opts for st in o.state.values() for v in st.values() if torch.is_tensor(v)]
        lrs = [g["lr"] for o in self.opts for g in o.param_groups if torch.is_tensor(g["lr"])]
        return (
            (packed.data_ptr(), packed.shape, packed.dtype, starts.data_ptr(), starts.shape),
            tuple(t.data_ptr() for t in self.tensors + state + lrs),
            _backend_flags(),
        )

    def mode(self, key, can_capture: bool) -> str:
        """``"eager"``, ``"capture"`` or ``"replay"`` for a call on inputs
        ``key``; ``can_capture`` is false while a capture is unsafe."""
        if self.off or not self.warm:
            self.warm = True
            return "eager"
        if self.graphs is not None and key == self.key:
            return "replay"
        if not can_capture:
            return "eager"
        if self.graphs is not None:
            self.graphs = self.out = None
            if not self.recaptures:
                self.off = True
                return "eager"
            self.recaptures -= 1
        return "capture"

    def _capture(self, packed: torch.Tensor, starts: torch.Tensor) -> bool:
        dev = packed.device
        first, second = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        first.register_generator_state(self.gen)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        drop_weight_history(self.modules)
        try:
            with torch.cuda.stream(side):
                first.capture_begin()
                try:
                    carry = self.first(packed, starts)
                finally:
                    first.capture_end()
                second.capture_begin(pool=first.pool())
                try:
                    out = self.second(*carry)
                finally:
                    second.capture_end()
        except RuntimeError as exc:
            warnings.warn(f"the vocoder's training step could not be captured in CUDA graphs, "
                          f"so the multi-step runs eagerly: {exc}")
            self.off = True
            return False
        finally:
            drop_weight_history(self.modules)
        self.graphs, self.out = (first, second), out
        return True

    def __call__(self, packed: torch.Tensor, starts: torch.Tensor, seed: int, it0: int,
                 n: int) -> Optional[torch.Tensor]:
        """The call's (n, 4) losses, or None where it runs eagerly."""
        if self.off:
            return None
        if not self.eligible() or _hooked(self.opts):
            self.warm = True
            return None
        key = self._key(packed, starts)
        mode = self.mode(key, can_capture=not _autograd_profiler._is_profiler_enabled)
        if mode == "eager" or (mode == "capture" and not self._capture(packed, starts)):
            return None
        self.key = key
        out = torch.empty(n, len(LOSS_NAMES), device=packed.device)
        for i in range(n):
            self.gen.manual_seed(step_seed(seed, it0 + i))
            self.per_step(it0 + i)
            for name, graph in zip(("vtrain.disc", "vtrain.gen"), self.graphs):
                with span(name):
                    graph.replay()
            out[i].copy_(self.out)
        return out


def make_vocoder_train_step(cfg: TrainConfig, generator: Generator, disc: Discriminator,
                            opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer, attr: Dict[str, np.ndarray],
                            inner_steps: int = 10, steps_per_epoch: int = 1):
    """The multi-step over a ``WaveCorpus``:

        multi_step(packed, starts, seed, it0) -> (inner_steps, 4) tensor

    of each step's ``LOSS_NAMES`` on the device (the terms before their
    lambdas: the discriminators' loss, the adversarial loss, feature
    matching, the mel L1). ``attr`` is the attribute file's ``mean`` and
    ``std``, by which the input mels are normalised. Where ``graph_eligible``
    holds, the steps after the first call are replays of ``GANGraphs``
    (the function's ``graphs``; None where the steps always run eagerly)."""
    vt, sig = cfg.vocoder_train, cfg.signal
    dev = next(generator.parameters()).device
    mean = torch.as_tensor(np.asarray(attr["mean"]), dtype=torch.float32, device=dev)
    std = torch.as_tensor(np.asarray(attr["std"]), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    disc_samples = 4 * vt.batch_size * disc.samples(vt.segment_samples)
    bf16 = cfg.compute_dtype == "bfloat16"

    def autocast():
        return torch.autocast(dev.type, dtype=torch.bfloat16) if bf16 else contextlib.nullcontext()

    def disc_update(mel: torch.Tensor, y: torch.Tensor):
        y = y[:, None]
        with autocast():
            y_hat = generator(mel.transpose(1, 2))
            opt_d.zero_grad(set_to_none=True)
            real, fake, _, _ = disc(y, y_hat.detach())
            loss_d = discriminator_loss(real, fake)
            loss_d.backward()
            opt_d.step()
        return y, y_hat, loss_d

    def gen_update(y: torch.Tensor, y_hat: torch.Tensor, loss_d: torch.Tensor) -> torch.Tensor:
        with autocast():
            opt_g.zero_grad(set_to_none=True)
            loss_mel = F.l1_loss(log_mel(y_hat[:, 0].float(), sig), log_mel(y[:, 0], sig))
            disc.requires_grad_(False)
            try:
                _, fake, fmap_r, fmap_g = disc(y, y_hat, real_graph=False)
                loss_adv = generator_adv_loss(fake)
                loss_fm = feature_loss(fmap_r, fmap_g)
                loss_g = vt.lambda_adv * loss_adv + vt.lambda_fm * loss_fm + vt.lambda_mel * loss_mel
                loss_g.backward()
            finally:
                disc.requires_grad_(True)
            opt_g.step()
        return torch.stack([t.detach().float() for t in (loss_d, loss_adv, loss_fm, loss_mel)])

    def draw(packed: torch.Tensor, starts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mel, y = sample_batch(packed, starts, vt, sig, gen)
        return (mel - mean) / std, y

    def per_step(it: int) -> None:
        set_lr((opt_g, opt_d), lr_at(vt, it, steps_per_epoch))
        count("vtrain.segments", vt.batch_size)
        count("vtrain.disc_samples", disc_samples)

    graphs = None
    if graph_eligible(dev):
        graphs = GANGraphs(lambda packed, starts: disc_update(*draw(packed, starts)), gen_update,
                           (generator, disc), (opt_g, opt_d), gen, per_step)

    def multi_step(packed: torch.Tensor, starts: torch.Tensor, seed: int, it0: int) -> torch.Tensor:
        if graphs is not None:
            out = graphs(packed, starts, seed, it0, inner_steps)
            if out is not None:
                return out
        out = []
        for i in range(inner_steps):
            it = it0 + i
            with span("vtrain.sample"):
                gen.manual_seed(step_seed(seed, it))
                mel, y = draw(packed, starts)
            per_step(it)
            with span("vtrain.disc"):
                carry = disc_update(mel, y)
            with span("vtrain.gen"):
                out.append(gen_update(*carry))
        return torch.stack(out)

    multi_step.graphs = graphs
    return multi_step


class VocoderTrainer:
    """The training job over waves in host memory (``cli/train_vocoder.py``):
    the corpus on ``device``, the networks from ``seed``, the optimisers,
    and the multi-step of ``cfg.inner_steps`` steps a call."""

    def __init__(self, cfg: TrainConfig, waves: Sequence[np.ndarray], attr: Dict[str, np.ndarray],
                 seed: int = 0, device: DeviceLike = None):
        if cfg.vocoder_train is None or cfg.vocoder.kind != "hifigan":
            raise ValueError("training the vocoder needs a hifigan vocoder section and a vocoder_train section")
        self.cfg, self.seed = cfg, int(seed)
        self.device = resolve_device(device)
        vt = cfg.vocoder_train
        self.corpus = WaveCorpus(waves, cfg.signal, vt.segment_samples, self.device,
                                 cfg.device_data_budget_bytes)
        self.generator, self.disc = build_models(cfg, self.seed, self.device)
        self.opt_g, self.opt_d = make_optimizers(vt, self.generator, self.disc)
        self.steps_per_epoch = self.corpus.steps_per_epoch(vt.batch_size)
        self.attr = attr
        self.steps = 0
        self._multi: Dict[int, object] = {}

    def _multi_step(self, k: int):
        if k not in self._multi:
            self._multi[k] = make_vocoder_train_step(
                self.cfg, self.generator, self.disc, self.opt_g, self.opt_d, self.attr, k,
                self.steps_per_epoch)
        return self._multi[k]

    def train(self, n_steps: int, log_every: int = 0, log=print) -> Dict[str, float]:
        """``n_steps`` more steps; every ``log_every`` steps (at call
        boundaries) prints the newest step's losses. Returns the last
        step's."""
        start, end, t0 = self.steps, self.steps + n_steps, time.time()
        vt = self.cfg.vocoder_train
        losses = None
        while self.steps < end:
            k = min(self.cfg.inner_steps, end - self.steps)
            losses = self._multi_step(k)(self.corpus.packed, self.corpus.starts, self.seed, self.steps)
            self.steps += k
            if log_every and (self.steps // log_every != (self.steps - k) // log_every or self.steps == end):
                row = dict(zip(LOSS_NAMES, losses[-1].tolist()))
                audio_s = (self.steps - start) * vt.batch_size * vt.segment_samples / self.cfg.signal.sr
                log(f"vocoder [{self.steps}/{end}] " + ", ".join(f"{n}={v:.4f}" for n, v in row.items())
                    + f", {audio_s / max(time.time() - t0, 1e-9):.1f} audio-s/s")
        return {} if losses is None else dict(zip(LOSS_NAMES, losses[-1].tolist()))

    def save(self, path: str) -> None:
        """ParallelWaveGAN's checkpoint layout, tensors on the CPU."""
        cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}
        torch.save({"model": {"generator": cpu(self.generator.state_dict()),
                              "discriminator": cpu(self.disc.state_dict())},
                    "optimizer": {"generator": self.opt_g.state_dict(),
                                  "discriminator": self.opt_d.state_dict()},
                    "steps": self.steps}, path)

    def load(self, path: str) -> None:
        """Restores a ``save``d checkpoint, keys matched exactly."""
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.generator.load_state_dict(ckpt["model"]["generator"], strict=True)
        self.disc.load_state_dict(ckpt["model"]["discriminator"], strict=True)
        self.opt_g.load_state_dict(ckpt["optimizer"]["generator"])
        self.opt_d.load_state_dict(ckpt["optimizer"]["discriminator"])
        self.steps = int(ckpt["steps"])

