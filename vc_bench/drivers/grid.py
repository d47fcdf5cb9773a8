"""Batched conversion: back-to-back ``Inferencer.convert_grid`` calls.

A unit is one call on ``n_src`` x ``n_tar`` normalised mels in host memory,
with the fused vocoder and the trim, to the trimmed wavs in host memory.
Each cycle of ``cycle_calls`` calls takes its lengths from one set spread
evenly over ``mel_frames``, in a seeded order, so every call sees mixed
lengths and the masked model and the ragged vocoder always run. The mels
are slices of a pool of unit-normal mels made on the device from the seed.

``check_units`` calls drawn from the seed among the first ``check_among``,
and the call with the longest source, keep their wavs; after the window the reference converts each of their pairs
alone at its true lengths and judges each wav by its SC against the
reference's magnitude, less the SC the reference's own Griffin-Lim reaches.

The control (``ctx.control``) puts the reference in the program's place one
precision down: the model in bfloat16, Griffin-Lim with int8 rounding,
pair by pair.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.ae import AE

from .. import traffic
from ..reference import featurize as ref_feat
from ..reference import vocoder as ref_voc
from ..reference.flops import decoder_frames
from ..reference.model import Net, make_params


class Program:
    def __init__(self, ctx, params, attr_path: str):
        tcfg = config_from_dict(ctx.cfg)
        with torch.device(ctx.device):
            model = AE(tcfg.model)
        model.load_state_dict(params, strict=True)
        self.inf = Inferencer(tcfg, model, attr_path, gl_method=ctx.cell["gl_method"],
                              precision=ctx.cfg["precision"], device=ctx.device)
        self.gl_method = ctx.cell["gl_method"]

    def convert(self, srcs, tars):
        return self.inf.convert_grid(srcs, tars, gl_method=self.gl_method, trim=True)


class Control:
    """The reference in the program's place, one precision down, pair by pair."""

    def __init__(self, ctx, params, attr):
        self.ctx, self.attr = ctx, attr
        self.net = Net(ctx.cfg, params, dtype=torch.bfloat16)

    def convert(self, srcs, tars):
        sig, dev = self.ctx.cfg["signal"], self.ctx.device
        mean = torch.from_numpy(self.attr["mean"]).to(dev)
        std = torch.from_numpy(self.attr["std"]).to(dev)
        out = []
        with torch.no_grad():
            for s in srcs:
                for t in tars:
                    mel = self.net.inference(torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
                    y = ref_voc.griffin_lim(ref_voc.mel_to_mag(mel * std + mean, sig), sig,
                                            sig["n_iter"], int8=True)
                    w = ref_voc.deemphasis(y.cpu().numpy(), sig["preemphasis"])
                    out.append(ref_feat.trim(w[: sig["hop_length"] * (len(s) - 1)], 60.0)[0])
        return out


def setup(ctx) -> dict:
    cfg, cell = ctx.cfg, ctx.cell
    sig = cfg["signal"]
    params = make_params(cfg, ctx.seed, ctx.device)
    fd, attr_path = tempfile.mkstemp(suffix=".pkl", prefix="vc_bench_attr_")
    os.close(fd)
    try:
        attr = traffic.write_attr(attr_path, sig["n_mels"], ctx.seed)
        system = Control(ctx, params, attr) if ctx.control else Program(ctx, params, attr_path)
    finally:
        os.unlink(attr_path)
    lo, hi = cell["mel_frames"]
    ns, nt = cell["n_src"], cell["n_tar"]
    sub = int(np.prod(cfg["ContentEncoder"]["subsample"][: cfg["ContentEncoder"]["n_conv_blocks"]]))
    pool = traffic.normal_mels(cell["pool"], -(-hi // sub) * sub, sig["n_mels"], ctx.seed + 2, ctx.device)
    lengths = np.rint(traffic.strata(cell["cycle_calls"] * (ns + nt), lo, hi)).astype(int)
    state = {"system": system, "params": params, "attr": attr, "pool": pool, "lengths": lengths,
             "kept": {}, "longest": None, "failed": 0,
             "keep": traffic.kept(ctx.seed, cell["check_among"], cell["check_units"])}
    ctx.mark("weights, model and inputs")
    # warm-up: every padded source length and every target length that the
    # window's first ``warm_calls`` calls will see (a shape the model has
    # not seen costs the host ~0.1 s in cuDNN's set-up of its convolutions),
    # each in a call of mixed lengths, then the spans are cleared
    src_pads, tar_maxes = set(), set()
    for k in range(cell["warm_calls"]):
        lens = call_plan(state, ctx, k)[1]
        src_pads.add(int(-(-max(lens[:ns]) // sub) * sub))
        tar_maxes.add(int(max(lens[ns:])))
    src_pads, tar_maxes = sorted(src_pads, reverse=True), sorted(tar_maxes, reverse=True)
    for w in range(max(len(src_pads), len(tar_maxes)) if not ctx.control else 0):
        ts, tt = src_pads[min(w, len(src_pads) - 1)], tar_maxes[min(w, len(tar_maxes) - 1)]
        ls = [ts - a for a in range(ns)] + [tt - b for b in range(nt)]
        srcs, tars = _mels(state, list(range(ns + nt)), ls, ns)
        system.convert(srcs, tars)
    ctx.sync()
    ctx.spans.clear()
    return state


def _mels(state, picks, lens, ns):
    mels = [state["pool"][p][:l] for p, l in zip(picks, lens)]
    return mels[:ns], mels[ns:]


def call_plan(state: dict, ctx, k: int):
    """(pool picks, lengths) of call k: its slice of the cycle's order."""
    cell = ctx.cell
    per = cell["n_src"] + cell["n_tar"]
    calls = cell["cycle_calls"]
    order = traffic.cycle_order(ctx.seed, 1, k // calls, calls * per)
    idx = order[(k % calls) * per : (k % calls + 1) * per]
    picks = traffic.cycle_order(ctx.seed, 2, k, cell["pool"])[:per]
    return picks, state["lengths"][idx]


def unit(state: dict, ctx, k: int) -> dict:
    ns = ctx.cell["n_src"]
    picks, lens = call_plan(state, ctx, k)
    srcs, tars = _mels(state, picks, lens, ns)
    try:
        wavs = state["system"].convert(srcs, tars)
    except Exception as e:  # a call that fails is counted, and the loop goes on
        state["failed"] += len(srcs) * len(tars)
        print(f"[grid] call {k} failed: {e!r}", file=sys.stderr)
        return {"failed": True}
    out = (picks, lens, wavs)
    if k < len(state["keep"]) and state["keep"][k]:
        state["kept"][k] = out
    if state["longest"] is None or max(lens[:ns]) > max(state["longest"][1][:ns]):
        state["longest"] = out
    # the ragged vocoder's one launch runs every pair at its decoder's length
    gl_frames = sum(decoder_frames(ctx.cfg, int(x)) for x in lens[:ns]) * (len(lens) - ns)
    return {"src_frames": [int(x) for x in lens[:ns]], "tar_frames": [int(x) for x in lens[ns:]],
            "gl_frames": gl_frames, "conversions": len(wavs)}


def finish(state: dict, ctx, unit_s, window_s: float) -> dict:
    per = ctx.cell["n_src"] * ctx.cell["n_tar"]
    done = len(unit_s) * per - state["failed"]
    return {"attempted": len(unit_s) * per, "failed": state["failed"],
            "metrics": {"conversions_per_s": done / window_s}}


def judge_call(ctx, params, attr, state, picks, lens, wavs) -> list:
    """Each pair of one call against the reference at its true lengths."""
    cfg, sig, dev = ctx.cfg, ctx.cfg["signal"], ctx.device
    ns, nt = ctx.cell["n_src"], ctx.cell["n_tar"]
    srcs, tars = _mels(state, picks, lens, ns)
    if len(wavs) != ns * nt:
        return [float("inf")]
    mean = torch.from_numpy(attr["mean"]).to(dev)
    std = torch.from_numpy(attr["std"]).to(dev)
    net = Net(cfg, params)
    out = []
    with torch.no_grad():
        for a, s in enumerate(srcs):
            for b, t in enumerate(tars):
                mel = net.inference(torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev)) * std + mean
                mag = ref_voc.mel_to_mag(mel, sig)
                n = len(s)
                y = ref_voc.griffin_lim(mag, sig, sig["n_iter"])[: sig["hop_length"] * (n - 1)]
                sc_ref = ref_voc.sc_signal(y, mag[:, :n], sig)
                out.append(ref_voc.spectral_convergence(wavs[a * nt + b], mag[:, :n], sig) - sc_ref)
    return out


def check(state: dict, ctx) -> dict:
    state.pop("system", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    calls = list(state["kept"].values())
    if state["longest"] is not None:
        calls.append(state["longest"])
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        excess = [x for c in calls for x in judge_call(ctx, state["params"], state["attr"], state, *c)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    limits = ctx.cell["limits"]
    values = {"sc_excess": max(excess, default=float("inf")),
              "sc_excess_mean": float(np.mean(excess)) if excess else float("inf")}
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}
