"""Batched conversion with a neural vocoder: back-to-back
``Inferencer.convert_grid`` calls on a configuration whose ``vocoder`` is
the HiFi-GAN generator.

A unit is one call on ``n_src`` x ``n_tar`` normalised mels in host memory,
through the masked model and one length-masked generator call, with the
trim, to the trimmed wavs in host memory. The lengths and the pool are
``grid.py``'s: each cycle of ``cycle_calls`` calls takes its lengths from one
set spread evenly over ``mel_frames``, in a seeded order, and the mels are
slices of a pool of unit-normal mels made on the device from the seed. The
calls pad to multiples of ``len_bucket`` frames, and set-up warms every
padded source and target length the range allows.

The generator's weights are drawn from the seed with PyTorch's default
convolution initialisation (``reference/hifigan.py``), as the model's are.

``check_units`` calls drawn from the seed among the first ``check_among``,
and the call with the longest source, keep their wavs; after the window the
reference converts each of their pairs alone at its true lengths, in f32
with TF32 off (the model, the generator, the same crop and trim). Each wav
is judged by its distance from that reference in units of the distance the
reference itself reaches at the configuration's precision (``precision``
null: cuDNN convolutions in TF32, matmuls in f32), over the same trimmed
span: ``||w - w_ref|| / ||w_ref@precision - w_ref||``, inf where the
trimmed lengths differ. A program that rounds as the configuration allows
reads about 1, and a lower precision reads many. The unit is no smaller than
``UNIT_FLOOR`` of the reference's varying part, f32's own rounding, where
the device has no TF32 (the CPU) and the two references are one.

The unit moves with the seed: the seeded biases give the generator's wav a
constant offset 1 to 22 times its varying part, and the activations under
it a large mean, which TF32 rounds the same way at every sample. Measured
against the reference's varying part, the program's distance read from
1.3e-3 to 1.05e-2 over six seeds on the H100, and the reference's own at
TF32 read the same at each seed within 8 %, while the bfloat16 control read
2.0e-2 to 9.2e-2: an absolute limit could not lie between them on every
seed. In the unit, the program read 0.92 to 1.04 and the control 8.8 to 23.

The control (``ctx.control``) puts the reference in the program's place one
precision down: the model and the generator in bfloat16, pair by pair.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile

import numpy as np
import torch

from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.hifigan import Generator

from .. import traffic
from ..reference import featurize as ref_feat
from ..reference import hifigan as ref_gen
from ..reference.model import Net, make_params

# a unit and the window's rate are grid.py's: a unit's ``gl_frames`` are
# every pair at its decoder's length, the frames the vocoder runs over
from .grid import _mels, call_plan, finish, unit  # noqa: F401

# the generator's weights take their own stream of the seed
GEN_SEED_OFFSET = 5
# the check's least unit, as a share of the reference's varying part
UNIT_FLOOR = 1e-5


class Program:
    def __init__(self, ctx, params, gen_params, attr_path: str):
        tcfg = config_from_dict(ctx.cfg)
        with torch.device(ctx.device):
            model, gen = AE(tcfg.model), Generator(tcfg.vocoder)
        model.load_state_dict(params, strict=True)
        gen.load_state_dict(gen_params, strict=True)
        self.inf = Inferencer(tcfg, model, attr_path, precision=ctx.cfg["precision"], device=ctx.device,
                              vocoder=gen)
        self.len_bucket = ctx.cell["len_bucket"]

    def convert(self, srcs, tars):
        return self.inf.convert_grid(srcs, tars, trim=True, len_bucket=self.len_bucket)


def reference_wav(ctx, net, gen_params, src, tar, dtype=None, tf32=False) -> np.ndarray:
    """One pair alone at its true lengths: the model, the generator, then the
    program's crop to its source's frames. ``tf32`` runs the generator under
    the TF32 switches as the caller set them."""
    hop = ctx.cfg["signal"]["hop_length"]
    with torch.no_grad():
        mel = net.inference(torch.from_numpy(src).to(ctx.device), torch.from_numpy(tar).to(ctx.device))
        wav = ref_gen.generate(mel, gen_params, ctx.cfg["vocoder"], dtype, tf32).cpu().numpy()
    return wav[: hop * (len(src) - 1)].astype(np.float32)


def reference_pair(ctx, net, gen_params, src, tar, dtype=None) -> np.ndarray:
    """``reference_wav`` with the program's trim."""
    return ref_feat.trim(reference_wav(ctx, net, gen_params, src, tar, dtype), 60.0)[0].astype(np.float32)


class Control:
    """The reference in the program's place, one precision down, pair by pair."""

    def __init__(self, ctx, params, gen_params):
        self.ctx, self.gen_params = ctx, gen_params
        self.net = Net(ctx.cfg, params, dtype=torch.bfloat16)

    def convert(self, srcs, tars):
        return [reference_pair(self.ctx, self.net, self.gen_params, s, t, torch.bfloat16)
                for s in srcs for t in tars]


def padded(n: int, step: int) -> int:
    return -(-n // step) * step


def setup(ctx) -> dict:
    cfg, cell = ctx.cfg, ctx.cell
    sig = cfg["signal"]
    params = make_params(cfg, ctx.seed, ctx.device)
    gen_params = ref_gen.make_params(cfg["vocoder"], ctx.seed + GEN_SEED_OFFSET, ctx.device)
    fd, attr_path = tempfile.mkstemp(suffix=".pkl", prefix="vc_bench_attr_")
    os.close(fd)
    try:
        attr = traffic.write_attr(attr_path, sig["n_mels"], ctx.seed)
        system = (Control(ctx, params, gen_params) if ctx.control
                  else Program(ctx, params, gen_params, attr_path))
    finally:
        os.unlink(attr_path)
    lo, hi = cell["mel_frames"]
    ns, nt, bucket = cell["n_src"], cell["n_tar"], cell["len_bucket"]
    sub = int(np.prod(cfg["ContentEncoder"]["subsample"][: cfg["ContentEncoder"]["n_conv_blocks"]]))
    # the Inferencer pads sources to multiples of both, targets of the bucket
    step = sub * bucket // math.gcd(sub, bucket)
    pool = traffic.normal_mels(cell["pool"], padded(hi, step), sig["n_mels"], ctx.seed + 2, ctx.device)
    lengths = np.rint(traffic.strata(cell["cycle_calls"] * (ns + nt), lo, hi)).astype(int)
    state = {"system": system, "params": params, "gen_params": gen_params, "pool": pool,
             "lengths": lengths, "kept": {}, "longest": None, "failed": 0,
             "keep": traffic.kept(ctx.seed, cell["check_among"], cell["check_units"])}
    ctx.mark("weights, model and inputs")
    # warm-up: every padded source and target length that lengths in
    # mel_frames can give (a shape the model and the generator have not
    # seen costs the host cuDNN's set-up of its convolutions), longest
    # first, each in a call of mixed lengths; then the spans are cleared
    src_pads = list(range(padded(hi, step), padded(lo, step) - 1, -step))
    tar_pads = list(range(padded(hi, bucket), padded(lo, bucket) - 1, -bucket))
    for w in range(max(len(src_pads), len(tar_pads)) if not ctx.control else 0):
        ts, tt = src_pads[min(w, len(src_pads) - 1)], tar_pads[min(w, len(tar_pads) - 1)]
        ls = [ts - a for a in range(ns)] + [tt - b for b in range(nt)]
        system.convert(*_mels(state, list(range(ns + nt)), ls, ns))
    ctx.sync()
    ctx.spans.clear()
    return state


@contextlib.contextmanager
def tf32_switches(matmul: bool, cudnn: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def stated_switches(precision) -> tuple:
    """(matmul, cuDNN) TF32 switches of a configuration's ``precision``, as
    the program's ``set_precision`` reads it: null and "default" are
    PyTorch's defaults."""
    return {None: (False, True), "default": (False, True), "high": (True, True),
            "highest": (False, False)}[precision]


def judge_call(ctx, net, gen_params, state, picks, lens, wavs) -> list:
    """Each pair of one call against the reference at its true lengths, in
    the unit of the module docstring."""
    ns, nt = ctx.cell["n_src"], ctx.cell["n_tar"]
    srcs, tars = _mels(state, picks, lens, ns)
    if len(wavs) != ns * nt:
        return [float("inf")]
    out = []
    for a, s in enumerate(srcs):
        for b, t in enumerate(tars):
            with tf32_switches(False, False):
                ref, lo, hi = ref_feat.trim(reference_wav(ctx, net, gen_params, s, t), 60.0)
            with tf32_switches(*stated_switches(ctx.cfg["precision"])):
                at_precision = reference_wav(ctx, net, gen_params, s, t, tf32=True)[lo:hi]
            w = np.asarray(wavs[a * nt + b], np.float32)
            if w.shape != ref.shape or not len(ref):
                out.append(float("inf"))
                continue
            unit = max(np.linalg.norm(at_precision - ref), UNIT_FLOOR * np.linalg.norm(ref - ref.mean()))
            out.append(float(np.linalg.norm(w - ref) / unit))
    return out


def check(state: dict, ctx) -> dict:
    state.pop("system", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    calls = list(state["kept"].values())
    if state["longest"] is not None:
        calls.append(state["longest"])
    net = Net(ctx.cfg, state["params"])
    gaps = [x for c in calls for x in judge_call(ctx, net, state["gen_params"], state, *c)]
    limits = ctx.cell["limits"]
    values = {"wav_gap": max(gaps, default=float("inf")),
              "wav_gap_mean": float(np.mean(gaps)) if gaps else float("inf")}
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}
