"""Training the HiFi-GAN V1 vocoder: the port's GAN step
(train/vocoder.py) on a wav corpus resident on the card.

Set-up makes the corpus from the seed: utterances of ``utt_frames`` [lo,
hi] frames (uniform) up to ``corpus_frames`` frames, each a seeded voiced
wave (``traffic.voiced_waves``, made on the device in batches), laid out
on the device by ``WaveCorpus``. The attribute file is drawn as the
serving cells draw it (``traffic.write_attr``). The weights are the
reference's, drawn from the seed (``reference/hifigan_train.py``: PyTorch's
default initialisation, weight-normed, the first scale discriminator's
spectral-norm vectors), loaded into the program's generator and
discriminators. Set-up builds the program's networks and optimisers once and holds
those objects to the reference: it runs their first ``CHECK_STEPS`` steps
in f32 with TF32 off (``make_vocoder_train_step(CHECK_STEPS)``), reads the
loss terms, each network's first gradient (AdamW's first moment after one
step, from an optimiser step hook) and the change of every leaf and
spectral-norm ``u`` after the steps, then loads the weights back and
clears the optimisers' state. It then builds the timed
``make_vocoder_train_step(inner_steps)`` on the same objects and runs its
first calls at the configuration's precision (``precision`` null: cuDNN's
convolutions in TF32); the first step's four loss terms are kept. The first
call runs eagerly and the second captures the step in CUDA graphs
(train/vocoder.py ``GANGraphs``), so the window's steps are replays, each
equal to an eager step bit for bit. A unit of the window is one call of
``inner_steps`` steps; nothing is synchronised until the window closes.

The check, after the program is freed, runs the reference's first
``CHECK_STEPS`` steps from the same weights on the same corpus and draws,
in f32 with TF32 off, and holds the program to them:

- ``loss1_gap``: the timed run's first step, its four loss terms, the
  forward at the weights both sides start from: TF32 reads up to ~1e-4,
  a lower precision tens of times more;
- ``loss_gap``, ``grad_gap``, ``grad_dist``, ``change_gap``
  (``compare_steps``): the set-up's steps with TF32 off. Under TF32 the
  GAN's first gradient moves by a few % from rounding alone (LeakyReLUs
  near zero switch slope), as much as a fault such as feature matching
  weighted 1 in place of 2; in f32 the program's arithmetic is held to the
  reference's to the rounding of f32.

The control (``ctx.control``) is the program's own step under bf16
autocast (``compute_dtype: bfloat16``), in both.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
from adaptive_voice_conversion_tpu_torch.models.hifigan import Generator, apply_weight_norm
from adaptive_voice_conversion_tpu_torch.models.hifigan_disc import Discriminator
from adaptive_voice_conversion_tpu_torch.train.vocoder import (
    WaveCorpus,
    make_optimizers,
    make_vocoder_train_step,
)

from .. import traffic
from ..reference import hifigan_train as ref

CHECK_STEPS = 3
# the streams of the seed the generator's and the discriminators' weights take
GEN_SEED_OFFSET, DISC_SEED_OFFSET = 5, 6
# utterances made on the device in one batch
WAVE_BATCH = 512


def make_waves(cell: dict, sig: dict, seed: int, device) -> list:
    """The corpus' utterances as host f32 arrays."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 3])
    lo, hi = cell["utt_frames"]
    total = cell["corpus_frames"]
    lens = rng.integers(lo, hi + 1, size=total // lo + 1)
    lens = lens[: int(np.searchsorted(np.cumsum(lens), total))]
    secs = lens * sig["hop_length"] / sig["sr"]
    waves = []
    for b in range(0, len(lens), WAVE_BATCH):
        waves += traffic.voiced_waves(secs[b : b + WAVE_BATCH], sig["sr"], seed + 17 + b, device)
    return waves


def build(tcfg, gen0: dict, disc0: dict, dev):
    """The program's generator and discriminators holding the weights, and
    their optimisers."""
    with torch.device(dev):
        generator = apply_weight_norm(Generator(tcfg.vocoder))
        disc = Discriminator(tcfg.vocoder_train)
    generator.load_state_dict(gen0, strict=True)
    disc.load_state_dict(disc0, strict=True)
    return (generator, disc) + make_optimizers(tcfg.vocoder_train, generator, disc)


def setup(ctx) -> dict:
    cfg, cell, dev = ctx.cfg, ctx.cell, ctx.device
    tcfg = config_from_dict(dict(cfg, compute_dtype="bfloat16") if ctx.control else cfg)
    vt = tcfg.vocoder_train
    with tempfile.TemporaryDirectory() as d:
        attr = traffic.write_attr(os.path.join(d, "attr.pkl"), cfg["signal"]["n_mels"], ctx.seed)
    gen0 = ref.make_gen_params(cfg["vocoder"], ctx.seed + GEN_SEED_OFFSET, dev)
    disc0 = ref.make_disc_params(cfg["vocoder_train"], ctx.seed + DISC_SEED_OFFSET, dev)
    nets = build(tcfg, gen0, disc0, dev)
    ctx.mark("weights and models")
    corpus = WaveCorpus(make_waves(cell, cfg["signal"], ctx.seed, dev), tcfg.signal, vt.segment_samples, dev,
                        tcfg.device_data_budget_bytes)
    ctx.sync()
    ctx.mark(f"corpus: {corpus.n_utterances} utterances, {corpus.samples} samples")
    with ref.no_tf32():
        prog = program_steps(tcfg, *nets, gen0, disc0, corpus, attr, ctx.seed, CHECK_STEPS)
    restore(*nets, gen0, disc0)
    ctx.sync()
    ctx.mark(f"{CHECK_STEPS} steps in f32 for the check")
    inner = cell["inner_steps"]
    multi_step = make_vocoder_train_step(tcfg, *nets, attr, inner, corpus.steps_per_epoch(vt.batch_size))
    first = multi_step(corpus.packed, corpus.starts, ctx.seed, 0)
    ctx.sync()
    ctx.mark("first call")
    state = {"multi_step": multi_step, "nets": nets, "corpus": corpus, "attr": attr, "gen0": gen0,
             "disc0": disc0, "it": inner, "outs": [first], "inner": inner, "prog": prog,
             "first_losses": first[0].tolist()}
    for _ in range(cell["warmup_calls"] - 1):
        unit(state, ctx, -1)
    state["outs"] = []
    return state


def program_steps(tcfg, generator: Generator, disc: Discriminator, opt_g, opt_d, gen0: dict, disc0: dict,
                  corpus: WaveCorpus, attr: dict, seed: int, n: int) -> dict:
    """The first ``n`` steps of these networks and optimisers, which hold
    ``gen0`` / ``disc0`` and have taken no step, as ``reference_steps``
    reads them: the loss terms, each network's first gradient (AdamW's first
    moment after one step over 1 - beta1), the change of every leaf and
    spectral-norm ``u``."""
    multi_step = make_vocoder_train_step(tcfg, generator, disc, opt_g, opt_d, attr, n,
                                         corpus.steps_per_epoch(tcfg.vocoder_train.batch_size))
    b1 = tcfg.vocoder_train.betas[0]
    grad1 = {}

    def first_moments(prefix, module):
        def hook(optimizer, args, kwargs):
            if not any(k.startswith(prefix + ".") for k in grad1):
                # a leaf without state took no step: its moment is 0
                grad1.update({f"{prefix}.{name}": optimizer.state[p]["exp_avg"] / (1 - b1)
                              if "exp_avg" in optimizer.state.get(p, {}) else torch.zeros_like(p)
                              for name, p in module.named_parameters()})
        return hook

    handles = [opt_g.register_step_post_hook(first_moments("gen", generator)),
               opt_d.register_step_post_hook(first_moments("disc", disc))]
    try:
        losses = multi_step(corpus.packed, corpus.starts, seed, 0)
    finally:
        for h in handles:
            h.remove()
    with torch.no_grad():
        change = {f"gen.{name}": p - gen0[name] for name, p in generator.named_parameters()}
        change.update({f"disc.{name}": p - disc0[name] for name, p in disc.named_parameters()})
        change.update({f"disc.{name}": b - disc0[name] for name, b in disc.named_buffers()
                       if name.endswith(".weight_u")})
    return ref.program_reads(losses, grad1, change)


def restore(generator: Generator, disc: Discriminator, opt_g, opt_d, gen0: dict, disc0: dict) -> None:
    """The networks back at ``gen0`` / ``disc0`` (spectral norm's vectors
    too) and the optimisers without state: where ``program_steps`` began."""
    generator.load_state_dict(gen0, strict=True)
    disc.load_state_dict(disc0, strict=True)
    for opt in (opt_g, opt_d):
        opt.state.clear()


def unit(state: dict, ctx, k: int) -> dict:
    c = state["corpus"]
    state["outs"].append(state["multi_step"](c.packed, c.starts, ctx.seed, state["it"]))
    state["it"] += state["inner"]
    return {"steps": state["inner"]}


def finish(state: dict, ctx, unit_s, window_s: float) -> dict:
    vt, sig = ctx.cfg["vocoder_train"], ctx.cfg["signal"]
    losses = torch.stack(state["outs"]).reshape(-1, 4)
    steps = losses.shape[0]
    audio_s = vt["batch_size"] * vt["segment_samples"] / sig["sr"]
    return {
        "attempted": steps,
        "failed": int((~torch.isfinite(losses).all(dim=1)).sum()),
        "metrics": {"train_audio_s_per_s": steps * audio_s / window_s},
    }


def check(state: dict, ctx) -> dict:
    """The timed run's first step and the set-up's ``CHECK_STEPS`` steps in
    f32 against the reference's (the module docstring), after the program's
    networks, optimisers and step are freed (the corpus and the weights the
    benchmark made stay)."""
    for key in ("multi_step", "nets", "outs"):
        state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    c, prog = state["corpus"], state["prog"]
    ref_out = ref.reference_steps(ctx.cfg, state["gen0"], state["disc0"], c.packed, c.starts, state["attr"],
                                  ctx.seed, CHECK_STEPS)
    first = ref.loss_gaps([state["first_losses"]], ref_out["losses"][:1])
    gaps = {"loss1_gap": max(first), **ref.compare_steps(prog, ref_out)}
    print("[vtrain] the timed run's first step, loss gaps " + " ".join(f"{g:.3g}" for g in first), file=sys.stderr)
    for i, (p, r) in enumerate(zip(prog["losses"], ref_out["losses"])):
        print(f"[vtrain] f32 step {i} loss gaps " + " ".join(f"{abs(a - b) / abs(b):.3g}" for a, b in zip(p, r))
              + f" (reference {' '.join(f'{b:.5g}' for b in r)})", file=sys.stderr)
    for key in ("grad1", "change"):
        r, p = ref_out[key], prog[key]
        med = float(np.median(list(r.values())))
        top = sorted(r, key=lambda n: -abs(p[n] - r[n]) / max(r[n], med))[:3]
        print(f"[vtrain] f32 {key} worst leaves " + ", ".join(f"{n} {p[n]:.4g}/{r[n]:.4g}" for n in top)
              + f" (median {med:.4g})", file=sys.stderr)
    limits = ctx.cell["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
