"""Training on a corpus over the device's budget: the port's chunked mode
(data/chunked.py), as ``Solver._train_chunked`` runs it.

Set-up makes ``corpus_frames`` x n_mels unit-normal f32 frames in host
memory (drawn on the device from the seed in pieces and copied out), cut
into utterances of ``utt_frames`` [lo, hi] frames with every segment start,
and a ``ChunkedDeviceStreamer`` of ``chunk_bytes`` chunks and
``chunk_repeats`` over it. The multi-step is
``make_device_data_train_step(inner_steps, padded_starts=True)``, which runs
eagerly. The first call takes steps 0 .. inner_steps - 1 on the first chunk
of the schedule from step 0; the first ``CHECK_STEPS`` steps' losses, the
first gradient and the parameters' change after ``CHECK_STEPS`` steps are
read there, as in ``train_device``. The window then follows the schedule
from the step that leaves ``warmup_calls - 1 + trace_first_unit +
trace_units - 1`` calls in that first visit: the warm-up calls, then the
units before the last traced one, which is the first of the next chunk, so
a traced run holds a chunk switch. A unit is one call of ``inner_steps``
steps. The visits and their chunks come from the program's own
``data/chunked.py`` ``stream_visits``, which ``Solver._train_chunked``
runs: the next chunk crosses on a thread from the start of a visit and the
switch waits for it (span ``train.chunk_wait``). A program without that
function (the one before it) runs ``_stream_visits``, its Solver's loop of
that time.

The check runs the reference's first ``CHECK_STEPS`` steps
(``reference/train.py``) on the first chunk and its valid starts, which is
the draw the program took. The control (``ctx.control``) is the program
with ``compute_dtype: bfloat16``.
"""

from __future__ import annotations

import sys
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

import adaptive_voice_conversion_tpu_torch.data.chunked as chunked
from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.train.optim import make_train_optimizer
from adaptive_voice_conversion_tpu_torch.train.step import make_device_data_train_step

from ..reference.model import make_params
from ..reference.train import compare_steps, reference_steps

CHECK_STEPS = 3
# frames drawn on the device in one piece
PIECE_ROWS = 1 << 18


def host_corpus(cell: dict, n_mels: int, seg: int, seed: int, device) -> types.SimpleNamespace:
    """The corpus as the streamer takes it: ``packed`` (frames, n_mels) f32
    in host memory, ``starts`` every segment start, ``segment_size``."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 3])
    lo, hi = cell["utt_frames"]
    total = cell["corpus_frames"]
    lens = rng.integers(lo, hi + 1, size=total // lo + 1)
    lens = lens[: int(np.searchsorted(np.cumsum(lens), total))]
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    counts = lens - seg + 1
    starts = np.repeat(offsets, counts) + (np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts))
    rows = int(lens.sum())
    packed = np.empty((rows, n_mels), np.float32)
    gen = torch.Generator(device=device).manual_seed((seed + 1) & 0x7FFFFFFFFFFFFFFF)
    host = torch.from_numpy(packed)
    for r0 in range(0, rows, PIECE_ROWS):
        n = min(PIECE_ROWS, rows - r0)
        host[r0 : r0 + n].copy_(torch.randn(n, n_mels, generator=gen, device=device))
    return types.SimpleNamespace(packed=packed, starts=starts.astype(np.int64), segment_size=seg)


def setup(ctx) -> dict:
    cfg, cell, dev = ctx.cfg, ctx.cell, ctx.device
    tcfg = config_from_dict(dict(cfg, compute_dtype="bfloat16") if ctx.control else cfg)
    params = make_params(cfg, ctx.seed, dev)
    with torch.device(dev):
        model = AE(tcfg.model)
    model.load_state_dict(params, strict=True)
    opt = make_train_optimizer(tcfg, model.parameters())
    ctx.mark("weights and model")
    dl = cfg["data_loader"]
    data = host_corpus(cell, cfg["SpeakerEncoder"]["c_in"], dl["segment_size"], ctx.seed, dev)
    inner = cell["inner_steps"]
    streamer = chunked.ChunkedDeviceStreamer(data, chunk_bytes=cell["chunk_bytes"], batch_size=dl["batch_size"],
                                             inner_steps=inner, seed=ctx.seed, repeats=cell["chunk_repeats"],
                                             device=dev)
    ctx.mark(f"corpus: {data.packed.shape[0]} frames, {streamer.n_chunks} chunks of {streamer.R} rows")
    multi_step = make_device_data_train_step(tcfg, model, opt, inner_steps=inner, padded_starts=True)

    first_visit = next(streamer.schedule(0, 1 << 40))
    chunk0 = streamer.put_chunk(first_visit.chunk_id).acquire()
    named = list(model.named_parameters())
    b1 = tcfg.optimizer.beta1
    seen = {"steps": 0}
    reads = {}

    def hook(optimizer, args, kwargs):
        seen["steps"] += 1
        with torch.no_grad():
            if seen["steps"] == 1:
                zero = torch.zeros((), device=dev)
                reads["grad1"] = torch.stack(
                    [(optimizer.state[p]["exp_avg"] / (1 - b1)).norm() if "exp_avg" in optimizer.state.get(p, {})
                     else zero for _, p in named])
            if seen["steps"] == CHECK_STEPS:
                reads["change"] = torch.stack([(p - params[n]).norm() for n, p in named])

    handle = opt.register_step_post_hook(hook)
    first = multi_step(chunk0.packed, chunk0.starts, chunk0.n_starts, ctx.seed, 0)
    handle.remove()
    ctx.sync()
    ctx.mark("first call")
    lead = cell["warmup_calls"] - 1 + cell["trace_first_unit"] + cell["trace_units"] - 1
    start = first_visit.it0 + first_visit.k - inner * lead
    if start < inner:
        raise ValueError(f"the first chunk's visit ({first_visit.k} steps) is too short to start "
                         f"{lead} calls before its end")
    names = [n for n, _ in named]
    stream = getattr(chunked, "stream_visits", _stream_visits)
    state = {"multi_step": multi_step, "model": model, "opt": opt,
             "visits": stream(streamer, streamer.schedule(start, 1 << 40)),
             "chunk": None, "left": 0, "it": start, "inner": inner, "outs": [first],
             "params": params, "check_chunk": (chunk0.packed, chunk0.starts[: int(chunk0.n_starts)]),
             "prog": {"losses": first[:CHECK_STEPS, 0].tolist(),
                      "grad1": dict(zip(names, reads["grad1"].tolist())),
                      "change": dict(zip(names, reads["change"].tolist()))}}
    for _ in range(cell["warmup_calls"] - 1):
        unit(state, ctx, -1)
    state["outs"] = []
    return state


def _stream_visits(streamer, visits) -> Iterator:
    """``data/chunked.py`` ``stream_visits`` for a program that lacks it:
    the loop of its ``Solver._train_chunked``, as a generator."""
    visits = iter(visits)
    v = next(visits)
    with ThreadPoolExecutor(max_workers=1) as pool:
        chunk = streamer.put_chunk(v.chunk_id).acquire()
        while True:
            nxt = next(visits)
            pending = pool.submit(streamer.put_chunk, nxt.chunk_id) if nxt.chunk_id != v.chunk_id else None
            yield v, chunk
            if pending is not None:
                chunk = pending.result().acquire()
            v = nxt


def unit(state: dict, ctx, k: int) -> dict:
    """One call of ``inner_steps`` steps (a visit is a multiple of them)."""
    if state["left"] == 0:
        v, state["chunk"] = next(state["visits"])
        state["left"], state["it"] = v.k, v.it0
    c = state["chunk"]
    state["outs"].append(state["multi_step"](c.packed, c.starts, c.n_starts, ctx.seed, state["it"]))
    state["it"] += state["inner"]
    state["left"] -= state["inner"]
    return {"steps": state["inner"]}


def finish(state: dict, ctx, unit_s, window_s: float) -> dict:
    cfg = ctx.cfg
    losses = torch.cat([o[:, 0] for o in state["outs"]])
    steps = losses.numel()
    sig, dl = cfg["signal"], cfg["data_loader"]
    audio_s = dl["batch_size"] * dl["segment_size"] * sig["hop_length"] / sig["sr"]
    return {
        "attempted": steps,
        "failed": int((~torch.isfinite(losses)).sum()),
        "metrics": {"train_audio_s_per_s": steps * audio_s / window_s},
    }


def check(state: dict, ctx) -> dict:
    """The first ``CHECK_STEPS`` steps against the reference's on the first
    chunk, after the program's model, optimiser, step and stream are freed."""
    state["visits"].close()
    for key in ("multi_step", "model", "opt", "outs", "chunk", "visits"):
        state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    packed, starts = state["check_chunk"]
    ref = reference_steps(ctx.cfg, state["params"], packed, starts, ctx.seed, CHECK_STEPS)
    gaps = compare_steps(state["prog"], ref)
    steps = [f"{abs(p - r) / abs(r):.3g}" for p, r in zip(state["prog"]["losses"], ref["losses"])]
    print(f"[train] loss gap by step {steps}", file=sys.stderr)
    limits = ctx.cell["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
