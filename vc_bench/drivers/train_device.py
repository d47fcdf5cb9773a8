"""Training on a corpus resident on the device: the port's device-mode loop.

Set-up makes the weights and the corpus on the device from the seed, builds
the model, the optimiser and ``make_device_data_train_step(inner_steps)``
once, and runs its first calls: the first ``CHECK_STEPS`` steps' losses, the
first gradient (Adam's first moment after one step) and the parameters'
change after ``CHECK_STEPS`` steps are read there, from that same object,
which the window then drives. A unit of the window is one call of
``inner_steps`` steps, as ``Solver._train_device`` makes them; nothing is
synchronised until the window closes.

The control (``ctx.control``) is the program with its own lower-precision
path switched on: ``compute_dtype: bfloat16``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.train.optim import make_train_optimizer
from adaptive_voice_conversion_tpu_torch.train.step import make_device_data_train_step

from ..reference.model import make_params
from ..reference.train import compare_steps, reference_steps

CHECK_STEPS = 3


def make_corpus(cell: dict, n_mels: int, seg: int, seed: int, device):
    """(packed, starts): ``corpus_frames`` x n_mels unit-normal f32 frames,
    made on the device, cut into utterances of ``utt_frames`` [lo, hi]
    frames (uniform), and every segment start of every utterance."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 3])
    lo, hi = cell["utt_frames"]
    total = cell["corpus_frames"]
    lens = rng.integers(lo, hi + 1, size=total // lo + 1)
    ends = np.cumsum(lens)
    n = int(np.searchsorted(ends, total))
    lens = lens[:n]
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    counts = lens - seg + 1
    starts = np.repeat(offsets, counts) + (
        np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts))
    gen = torch.Generator(device=device).manual_seed((seed + 1) & 0x7FFFFFFFFFFFFFFF)
    packed = torch.randn(int(lens.sum()), n_mels, generator=gen, device=device)
    return packed, torch.from_numpy(starts.astype(np.int64)).to(device)


def setup(ctx) -> dict:
    cfg, cell, dev = ctx.cfg, ctx.cell, ctx.device
    raw = dict(cfg, compute_dtype="bfloat16") if ctx.control else cfg
    tcfg = config_from_dict(raw)
    params = make_params(cfg, ctx.seed, dev)
    with torch.device(dev):
        model = AE(tcfg.model)
    model.load_state_dict(params, strict=True)
    opt = make_train_optimizer(tcfg, model.parameters())
    ctx.mark("weights and model")
    packed, starts = make_corpus(
        cell, cfg["SpeakerEncoder"]["c_in"], cfg["data_loader"]["segment_size"], ctx.seed, dev)
    ctx.sync()
    inner = cell["inner_steps"]
    multi_step = make_device_data_train_step(tcfg, model, opt, inner_steps=inner)

    named = [(n, p) for n, p in model.named_parameters()]
    b1 = tcfg.optimizer.beta1
    seen = {"steps": 0}
    reads = {}

    def hook(optimizer, args, kwargs):
        seen["steps"] += 1
        with torch.no_grad():
            if seen["steps"] == 1:
                # a parameter without state has taken no step: its moment is 0
                zero = torch.zeros((), device=dev)
                reads["grad1"] = torch.stack(
                    [(optimizer.state[p]["exp_avg"] / (1 - b1)).norm() if "exp_avg" in optimizer.state.get(p, {})
                     else zero for _, p in named])
            if seen["steps"] == CHECK_STEPS:
                reads["change"] = torch.stack([(p - params[n]).norm() for n, p in named])

    ctx.mark("corpus")
    handle = opt.register_step_post_hook(hook)
    first = multi_step(packed, starts, ctx.seed, 0)
    handle.remove()
    ctx.sync()
    ctx.mark("first call")
    state = {"multi_step": multi_step, "model": model, "opt": opt, "packed": packed,
             "starts": starts, "params": params, "it": inner, "outs": [first],
             "names": [n for n, _ in named], "reads": reads, "inner": inner}
    for _ in range(cell["warmup_calls"] - 1):
        unit(state, ctx, -1)
    state["outs"] = []
    state["prog"] = {
        "losses": first[:, 0].tolist(),
        "grad1": dict(zip(state["names"], reads["grad1"].tolist())),
        "change": dict(zip(state["names"], reads["change"].tolist())),
    }
    return state


def unit(state: dict, ctx, k: int) -> dict:
    state["outs"].append(state["multi_step"](state["packed"], state["starts"], ctx.seed, state["it"]))
    state["it"] += state["inner"]
    return {"steps": state["inner"]}


def finish(state: dict, ctx, unit_s, window_s: float) -> dict:
    cfg = ctx.cfg
    losses = torch.stack(state["outs"])[..., 0]
    steps = losses.numel()
    sig, dl = cfg["signal"], cfg["data_loader"]
    audio_s = dl["batch_size"] * dl["segment_size"] * sig["hop_length"] / sig["sr"]
    return {
        "attempted": steps,
        "failed": int((~torch.isfinite(losses)).sum()),
        "metrics": {"train_audio_s_per_s": steps * audio_s / window_s},
    }


def check(state: dict, ctx) -> dict:
    """The first ``CHECK_STEPS`` steps against the reference's, after the
    program's model, optimiser and step are freed (the corpus and the
    weights the benchmark made stay)."""
    for key in ("multi_step", "model", "opt", "outs"):
        state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(ctx.cfg, state["params"], state["packed"], state["starts"], ctx.seed, CHECK_STEPS)
    gaps = compare_steps(state["prog"], ref)
    prog = state["prog"]
    steps = [f"{abs(p - r) / abs(r):.3g}" for p, r in zip(prog["losses"], ref["losses"])]
    print(f"[train] loss gap by step {steps}", file=sys.stderr)
    for key in ("grad1", "change"):
        r, p = ref[key], prog[key]
        med = float(np.median(list(r.values())))
        top = sorted(r, key=lambda n: -abs(p[n] - r[n]) / max(r[n], med))[:3]
        print(f"[train] {key} worst leaves " + ", ".join(
            f"{n} {p[n]:.4g}/{r[n]:.4g}" for n in top) + f" (median {med:.4g})", file=sys.stderr)
    limits = ctx.cell["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
