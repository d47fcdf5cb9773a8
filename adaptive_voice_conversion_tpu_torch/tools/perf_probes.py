"""Microprobes behind the training step's recorded experiments, on the card.

The JAX package's probes (adaptive_voice_conversion_tpu/tools/perf_probes.py),
the same six under the same names:

- ``bank``: the conv bank (8 convs of 512 -> 128 channels, k = 1..8) in
  five groupings, ``conv_bank``'s ``group_size`` 8, 1, 2, 4 and 3; the
  five outputs must agree;
- ``parts``: the forward of each encoder, the decoder, the whole model and
  the loss;
- ``residual``: the content encoder's residual chain (6 blocks of two k=5
  convs at 128 channels, every second one strided) as cuDNN convolutions,
  as im2col and one product, and as a sum of shifted products;
- ``bank_split``: the bank and the 1x1 in-conv over its concat against
  ops/conv.py ``conv_bank_in`` (no concat);
- ``opt``: the device-resident multi-step with ``opt_state_dtype`` float32
  against bfloat16;
- ``profile``: a ``torch.profiler`` trace of the multi-step.

The timer. The JAX package times N = 50 applications of a unit inside one
compiled scan, the input moved by ``i * 1e-6`` at application ``i``, so
that dispatch drops out. Here the N applications are captured in one CUDA
graph, replayed once to warm up and then timed by CUDA events; a unit
that cannot be captured fails its probe. Beside it the same N
applications run eagerly, timed by CUDA events: the port's production
path runs eagerly and is bound by the host's launches (PERF.md §5), so
the two times bracket what a unit costs. On the CPU (``device="cpu"``,
as the tests run them) there is no graph and the timer is the host clock
around the eager applications.

Shapes are the JAX probes' by default (B=128, T=128, 512 mel channels,
c_bank 128, bf16 compute; a 40,000 x 512 bf16 corpus with 200,000 starts
for ``opt`` and ``profile``) and keyword arguments, so that the tests run
every probe small. JAX's ``unroll`` 2 and 5 of ``opt`` are a knob of XLA's
scan with no eager counterpart, so ``probe_opt`` has none (as
``core/cache.py``, ROADMAP.md's "Not ported, by design").

    python -m adaptive_voice_conversion_tpu_torch.tools.perf_probes \
        [bank|parts|residual|bank_split|opt|profile] [--device cuda] \
        [--calls N] [--out_dir DIR]

Times of the card go to PERF.md beside its name and power limit, which the
CLI prints first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import tempfile
import time
from argparse import ArgumentParser
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import TrainConfig
from ..core.device import DeviceLike, resolve_device
from ..ops.conv import conv1d, conv_bank, conv_bank_in
from ..ops.norm import instance_norm_time
from ..ops.padding import conv_pad_amounts, reflect_pad_time

N_APPLICATIONS = 50
BF16 = torch.bfloat16
PROBES = ("bank", "parts", "residual", "bank_split", "opt", "profile")
# probe_bank's groupings: name -> conv_bank's group_size over k = 1..8
BANK_GROUPINGS = {"fused1": 8, "sep8": 1, "pair4": 2, "quad2": 4, "tri3": 3}


@dataclasses.dataclass(frozen=True)
class Timing:
    """ms per application: ``graph`` (None off the card) and ``eager``."""

    graph: Optional[float]
    eager: float


def _apply(unit: Callable, x0: torch.Tensor, n: int) -> torch.Tensor:
    return torch.stack([unit(x0 + i * 1e-6) for i in range(n)])


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def unit_time(unit: Callable, x0: torch.Tensor, n: int = N_APPLICATIONS, label: str = "unit") -> Timing:
    """ms per application of ``unit`` over ``n`` applications to ``x0 + i *
    1e-6`` (the module docstring)."""
    if x0.device.type != "cuda":
        _apply(unit, x0, 1)
        t0 = time.perf_counter()
        _apply(unit, x0, n)
        return Timing(None, (time.perf_counter() - t0) * 1e3 / n)
    _apply(unit, x0, 2)  # cuDNN's plans, the allocator's first blocks
    torch.cuda.synchronize()
    eager = _event_ms(lambda: _apply(unit, x0, n)) / n
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a capture's warm-up runs on a side stream
        _apply(unit, x0, 2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            _apply(unit, x0, n)
    except RuntimeError as exc:
        raise RuntimeError(f"{label}: its {n} applications could not be captured in a CUDA graph") from exc
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(graph.replay) / n
    del graph
    return Timing(ms, eager)


def fmt(t_fwd: Timing, t_bwd: Optional[Timing] = None) -> str:
    """``fwd G ms   fwd+bwd G ms   eager fwd E ms   eager fwd+bwd E ms``;
    the graph's times only where there is one, fwd+bwd only when given."""
    parts = []
    if t_fwd.graph is not None:
        parts.append(f"fwd {t_fwd.graph:.4f} ms")
        if t_bwd is not None:
            parts.append(f"fwd+bwd {t_bwd.graph:.4f} ms")
    parts.append(f"eager fwd {t_fwd.eager:.4f} ms")
    if t_bwd is not None:
        parts.append(f"eager fwd+bwd {t_bwd.eager:.4f} ms")
    return "   ".join(parts)


def fwd_unit(fn: Callable) -> Callable:
    """sum(fn(x)) in f32, without autograd."""

    def unit(xx):
        with torch.no_grad():
            return fn(xx).float().sum()

    return unit


def fwd_bwd_unit(fn: Callable) -> Callable:
    """sum(d/dx sum(fn(x)^2)), the JAX probes' fwd+bwd unit."""

    def unit(xx):
        d = xx.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(fn(d).float().square().sum(), d)
        return g.sum()

    return unit


def time_fn(fn: Callable, x: torch.Tensor, n: int, label: str) -> dict:
    return {
        "fwd": unit_time(fwd_unit(fn), x, n, f"{label} fwd"),
        "fwd+bwd": unit_time(fwd_bwd_unit(fn), x, n, f"{label} fwd+bwd"),
    }


def _init_conv(gen: torch.Generator, k: int, c_in: int, c_out: int, device) -> tuple:
    """(w (c_out, c_in, k), b (c_out,)) from U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    the layers' init (models/modules.py ``init_parameters``)."""
    bound = 1.0 / np.sqrt(c_in * k)
    w = (torch.rand((c_out, c_in, k), generator=gen) * 2 - 1) * bound
    b = (torch.rand((c_out,), generator=gen) * 2 - 1) * bound
    return w.to(device), b.to(device)


def _input(b: int, t: int, c: int, device, seed: int = 0) -> torch.Tensor:
    """The JAX probes' (B, T, C) normal input from numpy's ``seed``, on the
    port's (B, C, T) layout."""
    x = np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)
    return torch.from_numpy(x).transpose(1, 2).contiguous().to(device)


@contextlib.contextmanager
def strict_numerics():
    """TF32 off and cuDNN's deterministic algorithms, restored on exit."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def probe_bank(device: DeviceLike = None, B: int = 128, T: int = 128, c_in: int = 512,
               c_bank: int = 128, n: int = N_APPLICATIONS) -> dict:
    """The five groupings of the bank, bf16, forward and forward+backward.

    The JAX probe asserts the five outputs bit-equal. Here each grouping
    is a convolution of another shape, which cuDNN (or the CPU) may sum in
    another order; in f32 that moves the last bits, and a bf16 output may
    round one unit in the last place the other way, which the bf16 bias
    add can carry to two. So the outputs are held to two bf16 units at the
    largest magnitude, ``2**-6 * max|out|``, with TF32 off and cuDNN
    deterministic; the largest difference is printed, 0 where bit-equal."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    ks = list(range(1, 9))
    bank = [_init_conv(gen, k, c_in, c_bank, dev) for k in ks]
    ws, bs = [w for w, _ in bank], [b for _, b in bank]
    x = _input(B, T, c_in, dev)
    fns = {name: (lambda xx, gs=gs: conv_bank(xx, ws, bs, ks, F.relu, group_size=gs, compute_dtype=BF16))
           for name, gs in BANK_GROUPINGS.items()}
    with strict_numerics(), torch.no_grad():
        outs = {name: fn(x).float() for name, fn in fns.items()}
    ref = outs["fused1"]
    tol = 2.0 ** -6 * float(ref.abs().max())
    diffs = {name: float((o - ref).abs().max()) for name, o in outs.items()}
    print(f"bank outputs against fused1 (bf16, TF32 off, cuDNN deterministic; tol 2 bf16 units at "
          f"max|out| {float(ref.abs().max()):.4f} = {tol:.3e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
    bad = {k: v for k, v in diffs.items() if not v <= tol}
    if bad:
        raise RuntimeError(f"probe_bank: groupings differ from fused1 beyond {tol:.3e}: {bad}")
    times = {}
    for name, fn in fns.items():
        times[name] = time_fn(fn, x, n, f"bank {name}")
        print(f"{name}: {fmt(times[name]['fwd'], times[name]['fwd+bwd'])}", flush=True)
    return {"max_diff": diffs, "tol": tol, "times": times}


def probe_parts(device: DeviceLike = None, B: int = 128, T: int = 128,
                cfg: Optional[TrainConfig] = None, n: int = N_APPLICATIONS) -> dict:
    """Forward of each part at bf16 compute: the speaker encoder, the
    content encoder, the decoder (from a fixed code and embedding), the
    whole model and the loss (a fixed ``eps``: the JAX probe's fixed key).
    ``cfg`` defaults to ``TrainConfig()``, the published widths."""
    from ..models.ae import AE
    from ..models.modules import init_parameters
    from ..train.step import loss_terms

    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg or TrainConfig(), compute_dtype="bfloat16")
    m = cfg.model
    model = AE(m)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(dev).train()
    t_code = T // int(np.prod(m.content_encoder.subsample))
    rng = lambda seed, shape: torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)
    x = rng(0, (B, T, m.speaker_encoder.c_in))
    z = rng(1, (B, t_code, m.decoder.c_in)).transpose(1, 2)
    emb = rng(2, (B, m.decoder.c_cond))
    eps = rng(3, (B, t_code, m.content_encoder.c_out))

    def loss(xx):
        loss_rec, loss_kl, _ = loss_terms(model, cfg, xx, eps=eps)
        return 10.0 * loss_rec + 0.5 * loss_kl

    fns = {
        "spk_fwd": lambda xx: model.speaker_encoder(xx.transpose(1, 2), compute_dtype=BF16),
        "cnt_fwd": lambda xx: model.content_encoder(xx.transpose(1, 2), compute_dtype=BF16)[0],
        "dec_fwd": lambda xx: model.decoder(z + xx.float().sum() * 0.0, emb, compute_dtype=BF16),
        "ae_fwd": lambda xx: model(xx, eps=eps, compute_dtype=BF16)[3],
        "loss_fwd": loss,
    }
    times = {}
    for name, fn in fns.items():
        times[name] = unit_time(fwd_unit(fn), x, n, name)
        print(f"{name}: {fmt(times[name])}", flush=True)
    return {"times": times}


def _conv_im2col(xx, w, b, stride):
    """The conv as one product: (C_out, C_in*K) x (B, C_in*K, T_out)."""
    k = w.shape[-1]
    xp = reflect_pad_time(xx, *conv_pad_amounts(k)).to(BF16)
    t_out = (xp.shape[-1] - k) // stride + 1
    cols = torch.stack([xp[:, :, j : j + stride * t_out : stride] for j in range(k)], dim=2)
    cols = cols.reshape(xp.shape[0], -1, t_out)
    return torch.matmul(w.reshape(w.shape[0], -1).to(BF16), cols) + b.to(BF16)[:, None]


def _conv_shifts(xx, w, b, stride):
    """The conv as a sum of one product per tap."""
    k = w.shape[-1]
    xp = reflect_pad_time(xx, *conv_pad_amounts(k)).to(BF16)
    t_out = (xp.shape[-1] - k) // stride + 1
    out = None
    for j in range(k):
        term = torch.matmul(w[:, :, j].to(BF16), xp[:, :, j : j + stride * t_out : stride])
        out = term if out is None else out + term
    return out + b.to(BF16)[:, None]


def probe_residual(device: DeviceLike = None, B: int = 128, T: int = 128, C: int = 128,
                   n: int = N_APPLICATIONS) -> dict:
    """The content encoder's residual chain (6 blocks of two k=5 convs,
    the second strided 1, 2, 1, 2, 1, 2; instance norm before each
    activation) in three formulations of the conv, bf16, forward and
    forward+backward; each one's largest difference from cuDNN's."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    convs = [_init_conv(gen, 5, C, C, dev) for _ in range(12)]
    subsample = (1, 2, 1, 2, 1, 2)
    x = _input(B, T, C, dev)
    variants = {
        "conv": lambda xx, w, b, s: conv1d(xx, w, b, stride=s, compute_dtype=BF16),
        "im2col": _conv_im2col,
        "shifts": _conv_shifts,
    }

    def chain(conv):
        def fn(xx):
            out = xx
            for l, sub in enumerate(subsample):
                (w1, b1), (w2, b2) = convs[2 * l], convs[2 * l + 1]
                y = F.relu(instance_norm_time(conv(out, w1, b1, 1)))
                y = F.relu(instance_norm_time(conv(y, w2, b2, sub)))
                if sub > 1:
                    out = out[:, :, ::2] * 0.5 + out[:, :, 1::2] * 0.5
                out = y + out
            return out

        return fn

    fns = {name: chain(conv) for name, conv in variants.items()}
    with torch.no_grad():
        outs = {name: fn(x).float() for name, fn in fns.items()}
    diffs = {name: float((o - outs["conv"]).abs().max()) for name, o in outs.items()}
    times = {}
    for name, fn in fns.items():
        if name != "conv":
            print(f"{name}: max|diff| vs conv = {diffs[name]:.2e}", flush=True)
        times[name] = time_fn(fn, x, n, f"residual {name}")
        print(f"{name}: {fmt(times[name]['fwd'], times[name]['fwd+bwd'])}", flush=True)
    return {"max_diff": diffs, "times": times}


def probe_bank_split(device: DeviceLike = None, B: int = 128, T: int = 128, c_in: int = 512,
                     c_bank: int = 128, c_h: int = 128, n: int = N_APPLICATIONS) -> dict:
    """The pair-grouped bank and the 1x1 in-conv over its concat against
    ``conv_bank_in``, the partial products summed (no concat), bf16, then
    the activation; forward and forward+backward, and their largest
    difference."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    ks = list(range(1, 9))
    bank = [_init_conv(gen, k, c_in, c_bank, dev) for k in ks]
    ws, bs = [w for w, _ in bank], [b for _, b in bank]
    w_in, b_in = _init_conv(gen, 1, c_bank * len(ks) + c_in, c_h, dev)
    x = _input(B, T, c_in, dev)
    fns = {
        "concat+1x1": lambda xx: F.relu(conv1d(
            conv_bank(xx, ws, bs, ks, F.relu, compute_dtype=BF16), w_in, b_in, compute_dtype=BF16)),
        "split-partials": lambda xx: F.relu(
            conv_bank_in(xx, ws, bs, ks, F.relu, w_in, b_in, compute_dtype=BF16)),
    }
    with torch.no_grad():
        y0, y1 = (fn(x).float() for fn in fns.values())
    diff = float((y0 - y1).abs().max())
    print(f"split vs concat max|diff| = {diff:.2e}", flush=True)
    times = {}
    for name, fn in fns.items():
        times[name] = time_fn(fn, x, n, f"bank_split {name}")
        print(f"{name}: {fmt(times[name]['fwd'], times[name]['fwd+bwd'])}", flush=True)
    return {"max_diff": diff, "times": times}


def _multi_step_setup(dev, cfg: TrainConfig, n_frames: int, n_starts: int):
    """A bf16 corpus of ``n_frames`` x n_mels with ``n_starts`` starts, on
    the device, and a fresh seeded model's 10-step multi-step of ``cfg``
    (bf16 compute and data)."""
    from ..models.ae import AE
    from ..models.modules import init_parameters
    from ..train.optim import make_train_optimizer
    from ..train.step import make_device_data_train_step

    rng = np.random.default_rng(0)
    n_mels = cfg.model.speaker_encoder.c_in
    packed = torch.from_numpy(rng.standard_normal((n_frames, n_mels)).astype(np.float32)).to(dev, BF16)
    starts = torch.from_numpy(rng.integers(0, n_frames - cfg.data_loader.segment_size, size=n_starts)).to(dev)
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(dev)
    opt = make_train_optimizer(cfg, model.parameters())
    multi = make_device_data_train_step(cfg, model, opt, inner_steps=cfg.inner_steps)
    return lambda it0: multi(packed, starts, 1, it0)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bf16_cfg(cfg: Optional[TrainConfig], **changes) -> TrainConfig:
    return dataclasses.replace(cfg or TrainConfig(), compute_dtype="bfloat16", data_dtype="bfloat16",
                               inner_steps=10, **changes)


def probe_opt(device: DeviceLike = None, n_frames: int = 40_000, n_starts: int = 200_000,
              calls: int = 30, cfg: Optional[TrainConfig] = None) -> dict:
    """The multi-step (10 steps a call, bf16 compute and data) with
    ``opt_state_dtype`` float32 and bfloat16: ms a step over ``calls``
    calls after one of warm-up, host clock to a synchronise."""
    dev = resolve_device(device)
    out = {}
    for sd in ("float32", "bfloat16"):
        c = _bf16_cfg(cfg, opt_state_dtype=sd, opt_fused=False)
        run = _multi_step_setup(dev, c, n_frames, n_starts)
        ms = run(0)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(calls):
            ms = run((i + 1) * c.inner_steps)
        _sync(dev)
        if not bool(torch.isfinite(ms).all()):
            raise RuntimeError(f"probe_opt: opt_state_dtype={sd}: the losses are not finite: {ms}")
        out[sd] = (time.perf_counter() - t0) * 1e3 / (calls * c.inner_steps)
        print(f"opt_state_dtype={sd} fused=False: {out[sd]:.3f} ms/step", flush=True)
    return out


def probe_profile(device: DeviceLike = None, out_dir: str = "", n_frames: int = 40_000,
                  n_starts: int = 200_000, calls: int = 5, cfg: Optional[TrainConfig] = None) -> list:
    """A ``torch.profiler`` trace (utils/profiling.py ``profile_trace``)
    of ``calls`` calls of the multi-step (10 steps a call, bf16) after one
    of warm-up, into ``out_dir`` (a new temporary directory when empty);
    returns [(path, bytes)] of the files written."""
    from ..utils.profiling import profile_trace

    dev = resolve_device(device)
    out_dir = out_dir or tempfile.mkdtemp(prefix="avc_profile_")
    c = _bf16_cfg(cfg)
    run = _multi_step_setup(dev, c, n_frames, n_starts)
    run(0)
    _sync(dev)
    with profile_trace(out_dir):
        for i in range(calls):
            run((i + 1) * c.inner_steps)
        _sync(dev)
    files = sorted(os.path.join(root, f) for root, _, names in os.walk(out_dir) for f in names)
    print(f"trace captured in {out_dir}:", flush=True)
    out = []
    for f in files:
        out.append((f, os.path.getsize(f)))
        print(f"  {os.path.relpath(f, out_dir)}  {out[-1][1]} B", flush=True)
    return out


def card_line(dev: torch.device) -> str:
    """The device, and on the card nvidia-smi's name and power limit."""
    if dev.type != "cuda":
        return f"devices: {dev} (timer: host clock around {N_APPLICATIONS} eager applications)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi not read: {exc}"
    return (f"devices: {dev} {torch.cuda.get_device_name(dev)} [{smi}] (timer: one CUDA graph of "
            f"{N_APPLICATIONS} applications, CUDA events; eager: the same applications uncaptured)")


def main(argv=None) -> None:
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("probe", nargs="?", default="bank")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--calls", type=int, default=0,
                        help="multi-step calls of opt (default 30) and profile (default 5)")
    parser.add_argument("--out_dir", default="", help="profile's trace directory (default: a new temporary one)")
    args = parser.parse_args(argv)
    which = args.probe
    if which not in PROBES:
        raise SystemExit(f"unknown probe {which!r} (bank|parts|residual|bank_split|opt|profile)")
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    calls = {"calls": args.calls} if args.calls else {}
    if which == "bank":
        probe_bank(dev)
    elif which == "parts":
        probe_parts(dev)
    elif which == "residual":
        probe_residual(dev)
    elif which == "bank_split":
        probe_bank_split(dev)
    elif which == "opt":
        probe_opt(dev, **calls)
    else:
        try:
            probe_profile(dev, args.out_dir, **calls)
        except Exception as exc:  # a failed capture is a result too, as in the JAX CLI
            print(f"trace FAILED: {type(exc).__name__}: {exc}", flush=True)


if __name__ == "__main__":
    main()
