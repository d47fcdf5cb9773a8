"""One-shot conversion, one client in a closed loop.

A unit is one request: a source and a target wave in host memory through
the port's featurizer (``dsp/audio.py`` trim and pre-emphasis,
``dsp/features.py::mel_from_wave``), ``Inferencer.normalize`` and
``Inferencer.inference_one_utterance`` with the fused vocoder, to the
trimmed converted wav in host memory. The waves come from two pools whose
lengths are spread evenly over ``wave_seconds``; each cycle through a pool
is a seeded permutation.

``check_units`` requests drawn from the seed among the first
``check_among``, and the one with the longest source, keep what the
program returned (the two mels its featurizer made, the
converted mel, the wav); after the window the reference featurizes the same
waves, converts them and vocodes the result, and judges those.

The control (``ctx.control``) puts the reference in the program's place one
precision down: the featurizer's STFT in float32, the model in bfloat16,
Griffin-Lim with int8 rounding.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
from adaptive_voice_conversion_tpu_torch.dsp.audio import preemphasis, trim_silence
from adaptive_voice_conversion_tpu_torch.dsp.features import mel_from_wave
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.ae import AE

from .. import traffic
from ..reference import featurize as ref_feat
from ..reference import vocoder as ref_voc
from ..reference.model import Net, make_params


class Program:
    """The port as a one-shot service."""

    def __init__(self, ctx, params, attr_path: str):
        cfg = ctx.cfg
        self.tcfg = config_from_dict(cfg)
        with torch.device(ctx.device):
            model = AE(self.tcfg.model)
        model.load_state_dict(params, strict=True)
        self.inf = Inferencer(self.tcfg, model, attr_path, gl_method=ctx.cell["gl_method"],
                              precision=cfg["precision"], device=ctx.device)
        self.ctx = ctx

    def featurize(self, y: np.ndarray) -> np.ndarray:
        sig = self.tcfg.signal
        y, _ = trim_silence(y, sig.top_db)
        return mel_from_wave(preemphasis(y, sig.preemphasis), sig)[0]

    def convert(self, src: np.ndarray, tar: np.ndarray):
        with self.ctx.span("featurize"):
            src_mel, tar_mel = self.featurize(src), self.featurize(tar)
        with self.ctx.span("convert"):
            wav, mel = self.inf.inference_one_utterance(
                self.inf.normalize(src_mel), self.inf.normalize(tar_mel))
        return wav, mel, src_mel, tar_mel


class Control:
    """The reference in the program's place, one precision down."""

    def __init__(self, ctx, params, attr):
        self.ctx, self.attr = ctx, attr
        self.net = Net(ctx.cfg, params, dtype=torch.bfloat16)

    def convert(self, src: np.ndarray, tar: np.ndarray):
        sig = self.ctx.cfg["signal"]
        with self.ctx.span("featurize"):
            src_mel = ref_feat.featurize(src, sig, control=True)
            tar_mel = ref_feat.featurize(tar, sig, control=True)
        norm = lambda m: torch.from_numpy((m - self.attr["mean"]) / self.attr["std"]).to(self.ctx.device)
        with torch.no_grad():
            dec = self.net.inference(norm(src_mel), norm(tar_mel))
            mel = dec * torch.from_numpy(self.attr["std"]).to(dec.device) + torch.from_numpy(
                self.attr["mean"]).to(dec.device)
            y = ref_voc.griffin_lim(ref_voc.mel_to_mag(mel, sig), sig, sig["n_iter"], int8=True)
        wav = ref_voc.deemphasis(y.cpu().numpy(), sig["preemphasis"])
        wav, _, _ = ref_feat.trim(wav, 60.0)
        return wav, mel.cpu().numpy(), src_mel, tar_mel


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
    n = cell["pool"]
    lo, hi = cell["wave_seconds"]
    lengths = traffic.strata(n, lo, hi)
    waves = traffic.voiced_waves(np.concatenate([lengths, lengths]), sig["sr"], ctx.seed + 2, ctx.device)
    state = {"system": system, "params": params, "attr": attr, "src": waves[:n], "tar": waves[n:],
             "kept": {}, "longest": None, "failed": 0, "n": n,
             "keep": traffic.kept(ctx.seed, cell["check_among"], cell["check_units"])}
    ctx.mark("weights, model and inputs")
    # warm-up: every wave of both pools once, as the window will see them
    # (a length the model has not seen costs the host ~0.1 s in cuDNN's
    # set-up of its convolutions), longest first, then the spans are cleared
    order = np.argsort(lengths)[::-1]
    for i, j in zip(order, order[::-1]) if not ctx.control else ():
        system.convert(state["src"][i], state["tar"][j])
    ctx.sync()
    ctx.spans.clear()
    return state


def unit(state: dict, ctx, k: int) -> dict:
    n = state["n"]
    i = int(traffic.cycle_order(ctx.seed, 1, k // n, n)[k % n])
    j = int(traffic.cycle_order(ctx.seed, 2, k // n, n)[k % n])
    src, tar = state["src"][i], state["tar"][j]
    try:
        wav, mel, src_mel, tar_mel = state["system"].convert(src, tar)
    except Exception as e:  # a request that fails is counted, and the loop goes on
        state["failed"] += 1
        print(f"[oneshot] request {k} failed: {e!r}", file=sys.stderr)
        return {"failed": True}
    out = (i, j, wav, mel, src_mel, tar_mel)
    if k < len(state["keep"]) and state["keep"][k]:
        state["kept"][k] = out
    if state["longest"] is None or len(src) > len(state["src"][state["longest"][0]]):
        state["longest"] = out
    return {"src_frames": [src_mel.shape[0]], "tar_frames": [tar_mel.shape[0]], "gl_frames": mel.shape[0]}


def finish(state: dict, ctx, unit_s, window_s: float) -> dict:
    ms = np.asarray(unit_s) * 1e3
    return {
        "attempted": len(unit_s),
        "failed": state["failed"],
        "metrics": {"convert_p50_ms": float(np.percentile(ms, 50)),
                    "convert_p95_ms": float(np.percentile(ms, 95))},
    }


def judge(ctx, params, attr, src, tar, wav, mel, src_mel, tar_mel) -> dict:
    """One request against the reference: the featurizer's mels, the
    converted mel, and the wav's SC against the reference's magnitude less
    the SC the reference's own Griffin-Lim reaches there."""
    sig = ctx.cfg["signal"]
    r_src, r_tar = ref_feat.featurize(src, sig), ref_feat.featurize(tar, sig)
    gap = lambda a, b: float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    feat = max(gap(src_mel, r_src), gap(tar_mel, r_tar))
    mean = torch.from_numpy(attr["mean"]).to(ctx.device)
    std = torch.from_numpy(attr["std"]).to(ctx.device)
    to = lambda m: (torch.from_numpy(m).to(ctx.device) - mean) / std
    with torch.no_grad():
        r_mel = Net(ctx.cfg, params).inference(to(r_src), to(r_tar)) * std + mean
        mag = ref_voc.mel_to_mag(r_mel, sig)
        sc_ref = ref_voc.sc_signal(ref_voc.griffin_lim(mag, sig, sig["n_iter"]), mag, sig)
        sc = ref_voc.spectral_convergence(wav, mag, sig)
    return {"feat_gap": feat, "mel_gap": gap(np.asarray(mel), r_mel.cpu().numpy()),
            "sc_excess": sc - sc_ref}


def check(state: dict, ctx) -> dict:
    state.pop("system", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    outs = list(state["kept"].values())
    if state["longest"] is not None:
        outs.append(state["longest"])
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        rows = [judge(ctx, state["params"], state["attr"], state["src"][i], state["tar"][j],
                      wav, mel, sm, tm) for i, j, wav, mel, sm, tm in outs]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    limits = ctx.cell["limits"]
    worst = {k: max((r[k] for r in rows), default=float("inf")) for k in limits}
    return {k: {"value": worst[k], "limit": limits[k]} for k in limits}
