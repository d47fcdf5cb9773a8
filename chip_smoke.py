#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card: require CUDA, print nvidia-smi's name and power limit, turn
     TF32 off for the parity phases;
  2. the build: compile csrc/griffin_lim.cu with nvcc for sm_90a, and hold
     the constants it exports against the Python model's;
  3. the fused Griffin-Lim kernel: its two basis images against the Python
     model of the operand layout, bit for bit; then against its plain
     PyTorch version on the card, at the main path's shape (one utterance,
     t_pad 344), at T=500 (two 384-frame segments stacked along the rows),
     at the serving shape (32 ragged blocks of t_pad 128 = 4096 rows, zero
     past each block's length) and at the tiles' edges (27 ragged blocks of
     t_pad 152 = 4104 rows, n_iter 1, 2 and 3); after every launch the plan
     the kernel took against the Python model of the launch plan;
  4. the main path at the full examples/config.yaml width: seeded wavs,
     attr.pkl and a reference-format .ckpt of seeded weights, then the
     one-shot conversion CLI with --gl_method fused in a subprocess, with
     the kernel's launch count read around it; the converted mel on the card
     against the same model on the CPU; fused against exact vocoder SC;
  5. batched serving at the same width: 4 source and 8 target wavs of
     mixed lengths through the convert_grid CLI with --gl_method fused in a
     subprocess (32 wavs, one kernel launch for the grid); in process, the
     grid's mels against one-at-a-time conversion and against convert_pairs,
     the ragged fused vocoder's SC against the masked exact one's, and the
     serving times;
  6. the kernel's times at both shapes, each beside the card's name and
     power limit.
The last three lines are the kernels JSON line, the card line, and
{"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from scipy.io import wavfile

from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig, load_config
from adaptive_voice_conversion_tpu_torch.dsp.audio import save_wav
from adaptive_voice_conversion_tpu_torch.dsp.features import get_spectrograms
from adaptive_voice_conversion_tpu_torch.dsp.stft import (
    hann_window,
    istft,
    istft_env_inv_masked,
    istft_masked,
    stft_np,
)
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import (
    griffin_lim,
    griffin_lim_masked,
    mel_to_mag,
    melspectrogram2wav,
)
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer, utt_make_frames
from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as gl
from adaptive_voice_conversion_tpu_torch.kernels._build import build
from adaptive_voice_conversion_tpu_torch.models.ae import AE, count_params
from adaptive_voice_conversion_tpu_torch.models.masked import ae_inference_masked
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.models.weights import (
    load_checkpoint,
    save_checkpoint,
)

REPO = Path(__file__).resolve().parent
SEED = 0
SIG = SignalConfig()
# The main path's kernel shape: a 4 s wav is 321 frames, the decoder
# returns 328 (content code ceil(321/8) = 41, upsampled x8), reflect-
# extension by 6 frames per side gives 340, padded to t_pad 344.
MAIN_FRAMES = 340
N_KERNEL_ITERS = SIG.n_iter - 4 - 2  # warm start 4, polish 2
# The serving grid: 4 sources x 8 targets of mixed lengths, in mel frames.
# The decoder returns ceil(L/8)*8 frames per source (128, 120, 128, 104), so
# the grid's vocoder batch is 32 blocks of t_pad 128 = 4096 kernel rows, of
# which 8 * (128 + 120 + 128 + 104) = 3840 are valid.
GRID_SRC_FRAMES = (128, 117, 128, 99)
GRID_TAR_FRAMES = tuple(96 + 8 * i for i in range(8))
GRID_DEC_FRAMES = tuple(-(-n // 8) * 8 for n in GRID_SRC_FRAMES)
GRID_BLOCK_FRAMES = tuple(n for n in GRID_DEC_FRAMES for _ in GRID_TAR_FRAMES)
# Grid mels against one-at-a-time mels on the card, TF32 off: the JAX
# package's own gate for its batched serving path
TOL_GRID_MEL = 1e-5
# H100 SXM peaks (NVIDIA data sheet, 700 W): dense bf16 tensor cores,
# f32 outside them, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# Tolerances, kernel vs plain version on the same inputs:
# - one iteration seeded with the signal's own STFT phases: the projection
#   is well-conditioned, only f32 summation order, the projection's last
#   few ulp and the rare bf16 rounding flips they cause differ
#   -> max |diff| <= 1e-3 * max|mag|. A bin's error is at most twice its
#   magnitude, so that cannot fail at bins below ~5e-4 * max|mag|, most of
#   the spectrum's noise floor; the relative Frobenius error of the whole
#   output, <= 1e-3, holds those too;
# - the full iteration count from zero phase: early projections divide by
#   near-vanishing |X2| at some bins, so summation order moves those phases
#   and the trajectories part; both must converge equally well -> the SC of
#   the two waves within 0.005.
TOL_ONE_ITER = 1e-3
TOL_ONE_ITER_FRO = 1e-3
TOL_SC = 0.005


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase_card() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device_count {torch.cuda.device_count()}; TF32 off")
    return card


def phase_build() -> None:
    built = build("griffin_lim")
    log(f"[build] {built.path.name} in {built.seconds:.2f} s")
    worst = [ln.strip() for ln in built.log.splitlines() if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    regs = sorted({int(ln.split("Used ")[1].split(" registers")[0]) for ln in built.log.splitlines() if "Used " in ln and " registers" in ln})
    log(f"[build] ptxas: {sum('Used ' in ln for ln in built.log.splitlines())} kernels, "
        f"registers per thread {regs}, kernels that spill: {len(worst)}")
    for line in worst:
        log(f"[build] {line}")
    # the constants the Python models repeat are the file's own
    out = (ctypes.c_int * 6)()
    gl._gl_lib().gl_constants(out)
    mine = [gl.IMAGE_K, gl.NUM_SMS, gl.PLAN_START, gl.PLAN_EPI_SYN, gl.PLAN_EPI_ANA, gl.PLAN_SPLIT]
    check(list(out) == mine, f"gl_constants {list(out)} != the Python model's {mine}")
    check(gl._gl_lib().gl_tile_rows() == gl.IMAGE_ROW_PAD,
          f"gl_tile_rows {gl._gl_lib().gl_tile_rows()} != IMAGE_ROW_PAD {gl.IMAGE_ROW_PAD}")
    log(f"[build] exported constants agree with kernels/griffin_lim.py: {mine}, "
        f"image row padding {gl.IMAGE_ROW_PAD}")


def synthetic_spec(n_frames: int, seed: int) -> np.ndarray:
    """Complex STFT (n_freq, n_frames) of a seeded voiced-like signal."""
    rng = np.random.default_rng(seed)
    n = SIG.hop_length * (n_frames - 1)
    t = np.arange(n) / SIG.sr
    f0 = 110.0 + 80.0 * rng.random()
    vib = 1.0 + 0.02 * np.sin(2 * np.pi * 5.0 * t)
    y = sum(
        rng.uniform(0.2, 1.0) / h * np.sin(2 * np.pi * h * f0 * np.cumsum(vib) / SIG.sr)
        for h in range(1, 12)
    )
    y = y * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t)) + 0.01 * rng.standard_normal(n)
    return stft_np(y.astype(np.float32), SIG.n_fft, SIG.hop_length, SIG.win_length)


def _sc(mag: np.ndarray, wav: np.ndarray) -> float:
    """Spectral convergence of a wav against the magnitude (n_freq, T)."""
    est = np.abs(stft_np(wav, SIG.n_fft, SIG.hop_length, SIG.win_length))
    f = min(est.shape[1], mag.shape[1])
    return float(np.linalg.norm(est[:, :f] - mag[:, :f]) / np.linalg.norm(mag[:, :f]))


def _stack_segments(spec: np.ndarray) -> np.ndarray:
    """(n_freq, T) -> (n_seg, n_freq, SEG_FRAMES), as the segmented path
    stacks them for one launch."""
    return np.stack([spec[:, s : s + gl.SEG_FRAMES] for s in gl._segment_starts(spec.shape[1])])


def ragged_grid_spec() -> np.ndarray:
    """The serving grid's vocoder batch as consistent spectrograms: 32
    blocks (32, n_freq, 128) complex, block k the STFT of a seeded signal of
    GRID_BLOCK_FRAMES[k] frames, zero past them."""
    t = max(GRID_BLOCK_FRAMES)
    blocks = []
    for k, n in enumerate(GRID_BLOCK_FRAMES):
        spec = synthetic_spec(n, SEED + 10 + k)
        blocks.append(np.pad(spec, ((0, 0), (0, t - n))))
    return np.stack(blocks)


def _waves(spec: torch.Tensor, lengths) -> np.ndarray:
    """Complex (B, n_freq, T) -> waves (B, hop*(T-1)); with ``lengths``, by
    the masked ISTFT (each block normalised over its own valid frames)."""
    if lengths is None:
        return istft(spec, SIG.n_fft, SIG.hop_length, SIG.win_length).cpu().numpy()
    lens = torch.tensor(lengths, device=spec.device)
    env = istft_env_inv_masked(lens, spec.shape[-1], SIG.n_fft, SIG.hop_length, SIG.win_length)
    return istft_masked(spec, env, SIG.n_fft, SIG.hop_length, SIG.win_length).cpu().numpy()


def _block_scs(mag_np: np.ndarray, wav: np.ndarray, lengths) -> list:
    """SC of each block's wave against its magnitude, over its valid frames."""
    lengths = [mag_np.shape[-1]] * len(wav) if lengths is None else lengths
    return [
        _sc(mag_np[i][:, :n], wav[i][: SIG.hop_length * (n - 1)])
        for i, n in enumerate(lengths)
    ]


# The tiles' edges: 27 blocks of 150 frames (t_pad 152, no multiple of the
# 64-row wgmma tiles) = 4104 rows, one 128-row tile past 4096, valid lengths
# ragged from 150 down
EDGE_BLOCK_FRAMES = tuple(150 - 3 * (k % 9) for k in range(27))


def check_layout(dev: torch.device) -> None:
    """gl_tile_bases' two images against the Python model of the operand
    layout, bit for bit."""
    c = gl._device_consts(SIG.n_fft, SIG.win_length, SIG.hop_length, dev)
    syn_b, ana_b = gl._kernel_bases(SIG.n_fft, SIG.win_length, SIG.hop_length, dev)
    cs = c.cs.cpu().view(torch.int16).numpy()
    for name, image, plain in (("syn_b", syn_b, cs), ("ana_b", ana_b, cs.T)):
        rows, k = plain.shape
        off = gl.operand_offset(np.arange(rows)[:, None], np.arange(k)[None, :], rows)
        want = np.empty(rows * k, np.int16)
        want[off.reshape(-1)] = plain.reshape(-1)
        got = image.cpu().view(torch.int16).numpy().reshape(-1)
        check(np.array_equal(got, want), f"{name} is not the image operand_offset describes: "
              f"{int((got != want).sum())} of {got.size} elements differ")
    log(f"[kernel] layout: gl_tile_bases' images of cs ({c.s_pad} rows) and cs^T "
        f"({2 * c.f_pad} rows) equal the Python model operand_offset bit for bit")


def check_plan(rows: int, what: str) -> "gl.LaunchPlan":
    """The plan the kernel's last launch took against the Python model's."""
    took, want = gl.kernel_last_plan(), gl.launch_plan(rows)
    check(took == want, f"{what}: gl_run took {took} at {rows} rows, launch_plan says {want}")
    return took


def phase_kernel_edges(dev: torch.device) -> None:
    """Case d: n_iter 1, 2 and 3 (first = last; the operand buffers reused
    once and twice) at a row count one tile past 4096, t_pad no multiple of
    64, ragged zero-magnitude pad frames."""
    t = max(EDGE_BLOCK_FRAMES)
    spec_b = np.stack([
        np.pad(synthetic_spec(n, SEED + 50 + k), ((0, 0), (0, t - n)))
        for k, n in enumerate(EDGE_BLOCK_FRAMES)
    ])
    mag = torch.from_numpy(np.abs(spec_b).astype(np.float32)).to(dev)
    init = torch.from_numpy(spec_b).to(dev)
    mag_max = float(mag.max())
    lengths = torch.tensor(EDGE_BLOCK_FRAMES, device=dev)
    pad = torch.arange(t, device=dev)[None, :] >= lengths[:, None]
    rows = len(EDGE_BLOCK_FRAMES) * (-(-t // 8) * 8)
    worst = {}
    for n_iter in (1, 2, 3):
        k = gl.griffin_lim_phases(mag, SIG, n_iter=n_iter, init_spec=init)
        plan = check_plan(rows, f"case d n_iter={n_iter}")
        p = gl.griffin_lim_phases_plain(mag, SIG, n_iter=n_iter, init_spec=init)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        fro = float(torch.linalg.norm(k - p) / torch.linalg.norm(p))
        check(torch.isfinite(k.real).all().item() and torch.isfinite(k.imag).all().item(),
              f"case d n_iter={n_iter}: kernel output not finite")
        check(err <= TOL_ONE_ITER * n_iter * mag_max,
              f"case d n_iter={n_iter}: max|diff| {err} > {TOL_ONE_ITER} * {n_iter} * {mag_max}")
        check(fro <= TOL_ONE_ITER_FRO,
              f"case d n_iter={n_iter}: relative Frobenius {fro} > {TOL_ONE_ITER_FRO}")
        pad_max = float((k.abs() * pad[:, None, :]).max())
        check(pad_max == 0.0, f"case d n_iter={n_iter}: padded rows reach {pad_max}, not 0")
        worst[n_iter] = (err / mag_max, fro)
    log(f"[kernel] case d: {len(EDGE_BLOCK_FRAMES)} ragged blocks of t_pad {-(-t // 8) * 8} = "
        f"{rows} rows ({sum(EDGE_BLOCK_FRAMES)} valid), plan {plan}; seeded with the signal's "
        f"own phases, n_iter 1 / 2 / 3 max|diff| of max|mag| "
        + " / ".join(f"{worst[n][0]:.3e}" for n in (1, 2, 3))
        + f" (tol {TOL_ONE_ITER} x n_iter: each projection amplifies the difference the one "
        "before left at bins where |X2| nearly vanishes), "
        "relative Frobenius " + " / ".join(f"{worst[n][1]:.3e}" for n in (1, 2, 3))
        + f" (tol {TOL_ONE_ITER_FRO}); padded rows exactly zero")


def phase_kernel() -> dict:
    dev = torch.device("cuda")
    check_layout(dev)
    out = {}
    cases = (
        ("a", synthetic_spec(MAIN_FRAMES, SEED)[None], None),
        ("b", _stack_segments(synthetic_spec(500, SEED + 1)), None),
        ("c", ragged_grid_spec(), list(GRID_BLOCK_FRAMES)),
    )
    for case, spec_b, lengths in cases:
        mag = torch.from_numpy(np.abs(spec_b).astype(np.float32)).to(dev)
        init = torch.from_numpy(spec_b).to(dev)
        mag_max = float(mag.max())
        before = gl.griffin_lim_phases.launches
        k1 = gl.griffin_lim_phases(mag, SIG, n_iter=1, init_spec=init)
        plan = check_plan(mag.shape[0] * (-(-mag.shape[2] // 8) * 8), f"case {case}")
        p1 = gl.griffin_lim_phases_plain(mag, SIG, n_iter=1, init_spec=init)
        torch.cuda.synchronize()
        err1 = float((k1 - p1).abs().max())
        fro1 = float(torch.linalg.norm(k1 - p1) / torch.linalg.norm(p1))
        check(torch.isfinite(k1.real).all().item() and torch.isfinite(k1.imag).all().item(),
              f"case {case}: kernel output not finite")
        check(err1 <= TOL_ONE_ITER * mag_max,
              f"case {case}: n_iter=1 max|diff| {err1} > {TOL_ONE_ITER} * {mag_max}")
        check(fro1 <= TOL_ONE_ITER_FRO,
              f"case {case}: n_iter=1 relative Frobenius {fro1} > {TOL_ONE_ITER_FRO}")
        kn = gl.griffin_lim_phases(mag, SIG, n_iter=N_KERNEL_ITERS)
        pn = gl.griffin_lim_phases_plain(mag, SIG, n_iter=N_KERNEL_ITERS)
        torch.cuda.synchronize()
        check(gl.griffin_lim_phases.launches == before + 2,
              f"case {case}: launch counter did not move by 2")
        check(torch.isfinite(kn.real).all().item() and torch.isfinite(kn.imag).all().item(),
              f"case {case}: kernel output after {N_KERNEL_ITERS} iterations not finite")
        if lengths is not None:
            # pad frames have zero magnitude and must come out exactly zero
            pad = torch.arange(mag.shape[-1], device=dev)[None, :] >= torch.tensor(lengths, device=dev)[:, None]
            for name, spec in (("kernel n_iter=1", k1), (f"kernel n_iter={N_KERNEL_ITERS}", kn),
                               (f"plain n_iter={N_KERNEL_ITERS}", pn)):
                worst = float((spec.abs() * pad[:, None, :]).max())
                check(worst == 0.0, f"case {case}: {name} padded rows reach {worst}, not 0")
        wk, wp = _waves(kn, lengths), _waves(pn, lengths)
        check(np.isfinite(wk).all(), f"case {case}: kernel wave not finite")
        mag_np = mag.cpu().numpy()
        scs_k, scs_p = _block_scs(mag_np, wk, lengths), _block_scs(mag_np, wp, lengths)
        gap = max(abs(a - b) for a, b in zip(scs_k, scs_p))
        check(gap <= TOL_SC,
              f"case {case}: SC kernel vs plain differ by {gap:.5f} > {TOL_SC} in some block")
        sck, scp = max(scs_k), max(scs_p)
        t_pad = -(-mag.shape[2] // 8) * 8
        ragged = "" if lengths is None else (
            f", {sum(lengths)} valid rows, padded rows exactly zero")
        log(f"[kernel] case {case}: T={mag.shape[2]}, {mag.shape[0]} block(s) of "
            f"t_pad {t_pad} = {mag.shape[0] * t_pad} rows{ragged}, plan {plan}; n_iter=1 max|diff| {err1:.3e} "
            f"= {err1 / mag_max:.3e} of max|mag| (tol {TOL_ONE_ITER}), relative "
            f"Frobenius {fro1:.3e} (tol {TOL_ONE_ITER_FRO}); "
            f"n_iter={N_KERNEL_ITERS} worst block SC kernel {sck:.5f} plain {scp:.5f}, "
            f"largest per-block gap {gap:.5f} (tol {TOL_SC})")
        out[case] = {"max_abs_err": err1, "fro": fro1, "sc_kernel": sck, "sc_plain": scp}
    phase_kernel_edges(dev)
    log(f"[kernel] tolerances: n_iter=1 seeded with the signal's own phases, "
        f"max|diff| <= {TOL_ONE_ITER}*max|mag| and relative Frobenius <= "
        f"{TOL_ONE_ITER_FRO} (only f32 summation order, the projection's last "
        f"ulp and the bf16 rounding flips they cause differ; the per-bin "
        f"bound cannot see bins below ~{TOL_ONE_ITER / 2}*max|mag|, the "
        f"Frobenius bound holds them as a whole); "
        f"full count from zero "
        f"phase, SC within {TOL_SC} (early projections divide by near-zero "
        f"|X2| at some bins, so trajectories part but must converge alike)")
    return out


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us_by_kernel(fn) -> dict:
    """{kernel name: (device us summed, launches)} for one run of fn(),
    from torch.profiler's CUDA activity: device-side events only, since a
    CPU-side op's own device time repeats its kernels'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {
        evt.key: (float(evt.self_device_time_total), int(evt.count))
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
    }


def kernel_bound(lengths, n_iter: int) -> dict:
    """Least time for griffin_lim_phases on stacked blocks with these valid
    frame counts (one utterance: a list of one) from zero phase: the larger
    of the bytes it must move (inputs read once, outputs written once) over
    the HBM rate and its operations over the peak rate of their type.
    Counted at the sizes the function needs: the valid frames only (zero
    pad frames need no work), n_freq complex bins, the window's nonzero
    support. The bf16 products and the f32 rest run on separate units, so
    the operations take the larger of their two times. The kernel's padded
    sizes (blocks x t_pad rows, 2*f_pad columns, s_pad samples) are
    reported beside it as executed work."""
    c = gl._device_consts(SIG.n_fft, SIG.win_length, SIG.hop_length, torch.device("cuda"))
    n_freq = 1 + SIG.n_fft // 2
    support = int(np.count_nonzero(hann_window(SIG.win_length, SIG.n_fft)))
    frames = int(sum(lengths))
    # two products per iteration, (frames x 2 n_freq) x (2 n_freq x support)
    # and back
    bf16_flops = n_iter * 2 * (2 * frames * 2 * n_freq * support)
    # the ck scaling (2 per bin), the band (2*taps adds and the gain per
    # sample) and the projection (~8 per bin)
    f32_flops = n_iter * (frames * n_freq * (2 + 8) + frames * support * (2 * c.n_taps + 1))
    n_bytes = (frames * n_freq * 4  # mag
               + support * 2 * n_freq * 2 + n_freq * 4 + support * 4  # basis (bf16), ck, g
               + frames * n_freq * 8)  # the complex output
    ops_ms = max(bf16_flops / PEAK_BF16, f32_flops / PEAK_F32) * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    rows = len(lengths) * (-(-max(lengths) // 8) * 8)
    executed = 2 * (2 * rows * 2 * c.f_pad * c.s_pad)
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "frames": frames,
        "rows": rows,
        "bf16_gflop_per_iter": bf16_flops / n_iter / 1e9,
        "f32_mflop_per_iter": f32_flops / n_iter / 1e6,
        "support": support,
        "executed_gflop_per_iter": executed / 1e9,
        "bytes_mb": n_bytes / 1e6,
        # what one iteration would move if basis and state came from HBM
        "per_iter_hbm_mb": (2 * c.s_pad * 2 * c.f_pad * 2 + 4 * rows * c.f_pad * 4
                            + rows * c.s_pad * (4 + 2) * 2) / 1e6,
    }


def time_kernel(card: str, label: str, mag: torch.Tensor, lengths, reps: int) -> dict:
    """The kernel's wrapper from zero phase on ``mag`` (B, n_freq, T) with
    these valid frame counts: CUDA-event time, the plain version's, the
    library yardstick's, the bound, and the per-launch split."""
    dev = mag.device
    n = N_KERNEL_ITERS
    ms = cuda_ms(lambda: gl.griffin_lim_phases(mag, SIG, n_iter=n), reps=reps)
    plain_ms = cuda_ms(lambda: gl.griffin_lim_phases_plain(mag, SIG, n_iter=n), reps=3, warmup=1)
    bound = kernel_bound(lengths, n)
    rows = bound["rows"]  # the kernel's padded shapes
    # yardstick, timed only: the two bf16 products of every iteration as
    # torch.matmul calls on the same shapes
    c = gl._device_consts(SIG.n_fft, SIG.win_length, SIG.hop_length, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a_syn = torch.randn(rows, 2 * c.f_pad, device=dev, generator=gen).to(torch.bfloat16)
    a_ana = torch.randn(rows, c.s_pad, device=dev, generator=gen).to(torch.bfloat16)
    cs_t = c.cs.t()

    def library():
        for _ in range(n):
            torch.matmul(a_syn, cs_t)
            torch.matmul(a_ana, c.cs)

    # device time from the profiler: the host cannot launch 2 x 94 cuBLAS
    # calls as fast as the card runs them, so CUDA events around the loop
    # would time the host
    library_ms = sum(us for us, _ in device_us_by_kernel(library).values()) / 1e3
    split = device_us_by_kernel(lambda: gl.griffin_lim_phases(mag, SIG, n_iter=n))
    plan = check_plan(rows, label)
    launches = 0
    for name, (us, count) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        if "gl_" in name:
            launches += count
            short = name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            log(f"[time] {label} kernel launch {short}: {us / count:.2f} us x {count} "
                f"(torch.profiler; the loop's launches overlap, each span "
                f"includes its wait on the one before) ({card})")
        elif "memset" in name.lower() or "fill" in name.lower():
            log(f"[time] {label} wrapper zero-fill of scratch and seed state: "
                f"{us / count:.2f} us x {count} (torch.profiler) ({card})")
    # the same launches one after the other: each span is the launch's own time
    gl.set_launch_overlap(False)
    try:
        serial_ms = cuda_ms(lambda: gl.griffin_lim_phases(mag, SIG, n_iter=n), reps=reps)
        serial = device_us_by_kernel(lambda: gl.griffin_lim_phases(mag, SIG, n_iter=n))
    finally:
        gl.set_launch_overlap(True)
    own = {name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]: us / count
           for name, (us, count) in serial.items() if "gl_" in name and count > 1}
    log(f"[time] {label} launches serialised (no programmatic dependent launch): "
        + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(own.items(), key=lambda kv: -kv[1]))
        + f"; sum {sum(own.values()):.2f} us per iteration, {serial_ms:.4f} ms per call "
        f"against {ms:.4f} overlapped (torch.profiler spans, CUDA-event ms) ({card})")
    # achieved rates from the plan's own counts: the padded products the
    # kernel executes, and the device-memory bytes of its iterations
    moved = (n - 1) * gl.iteration_bytes(rows, plan, c.f_pad, c.s_pad)["total"] + \
        gl.iteration_bytes(rows, plan, c.f_pad, c.s_pad, last=True)["total"]
    log(f"[time] {label} kernel griffin_lim_phases rows {rows} ({bound['frames']} valid) "
        f"x {n} iters, plan {plan}: {ms:.4f} ms per call, {ms / n * 1e3:.2f} us per iteration, "
        f"{launches} CUDA launches in one wrapper launch (torch.profiler's count); "
        f"{bound['executed_gflop_per_iter'] * n / ms:.1f} TFLOP/s bf16 executed, "
        f"{moved / ms / 1e6:.1f} GB/s of device memory if every array of an iteration "
        f"({gl.iteration_bytes(rows, plan, c.f_pad, c.s_pad)['total'] / 1e6:.1f} MB) moved once "
        f"({card})")
    log(f"[time] {label} plain version {plain_ms:.4f} ms; library yardstick (2 bf16 "
        f"torch.matmul per iteration x {n} at {rows} rows, device time by "
        f"torch.profiler) {library_ms:.4f} ms ({card})")
    log(f"[time] {label} bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}: "
        f"{bound['bf16_gflop_per_iter']:.3f} bf16 GFLOP per iteration at "
        f"{bound['frames']} frames x {2 * (1 + SIG.n_fft // 2)} x {bound['support']} "
        f"samples (the kernel executes {bound['executed_gflop_per_iter']:.3f} "
        f"at its padded {rows} x {2 * c.f_pad} x {c.s_pad}), "
        f"{bound['f32_mflop_per_iter']:.2f} f32 MFLOP per iteration, "
        f"{bound['bytes_mb']:.2f} MB in+out once; "
        f"~{bound['per_iter_hbm_mb']:.1f} MB per iteration if basis, state and "
        f"scratch all went to HBM; kernel at {ms / bound['bound_ms']:.2f}x its bound, "
        f"{ms / library_ms:.2f}x the library yardstick ({card})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound}


def phase_kernel_times(card: str) -> dict:
    """The main path's shape (one utterance of 340 frames: the `kernels`
    line), then the serving shape (the 4 x 8 grid's 32 ragged blocks)."""
    dev = torch.device("cuda")
    spec = synthetic_spec(MAIN_FRAMES, SEED)
    mag = torch.from_numpy(np.abs(spec)[None].astype(np.float32)).to(dev)
    main = time_kernel(card, "main path:", mag, [MAIN_FRAMES], reps=10)
    grid_mag = torch.from_numpy(np.abs(ragged_grid_spec()).astype(np.float32)).to(dev)
    serving = time_kernel(card, "serving grid:", grid_mag, list(GRID_BLOCK_FRAMES), reps=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gl.griffin_lim_phases(grid_mag, SIG, n_iter=N_KERNEL_ITERS)
    torch.cuda.synchronize()
    rows = serving["rows"]
    scratch = gl.scratch_bytes(rows, gl.launch_plan(rows))
    log(f"[time] serving grid: peak device memory above the inputs during one wrapper call "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e6:.1f} MB, of which the kernel's "
        f"state and scratch {sum(scratch.values()) / 1e6:.1f} MB by scratch_bytes "
        f"(syn partial sums {scratch['syn'] / 1e6:.1f} MB; the rest is the wrapper's padded "
        f"frames and complex result) ({card})")
    return {"main": main, "serving": serving}


def make_wav(path: Path, seconds: float, f0: float, seed: int) -> None:
    """A seeded voiced-like wav: harmonics with vibrato, a slow envelope
    that trim_silence keeps whole, and a little noise in every mel band."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SIG.sr))
    t = np.arange(n) / SIG.sr
    phase = 2 * np.pi * f0 * np.cumsum(1.0 + 0.03 * np.sin(2 * np.pi * 4.0 * t)) / SIG.sr
    y = sum(rng.uniform(0.3, 1.0) / h * np.sin(h * phase) for h in range(1, 16))
    y = 0.3 * y * (0.7 + 0.3 * np.sin(2 * np.pi * 0.8 * t)) + 0.005 * rng.standard_normal(n)
    save_wav(str(path), y.astype(np.float32), SIG.sr)


# Runs a CLI's entry point (argv[1] names its module under cli/) in a fresh
# process and reports the kernel's launch count, reset just before the run
# and read just after it.
CLI_RUNNER = (
    "import importlib, json, sys\n"
    "from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as gl\n"
    "cli = importlib.import_module('adaptive_voice_conversion_tpu_torch.cli.' + sys.argv[1])\n"
    "gl.griffin_lim_phases.launches = 0\n"
    "cli.main(sys.argv[2:])\n"
    "print(json.dumps({'griffin_lim_phases': gl.griffin_lim_phases.launches}))\n"
)


def run_cli(module: str, argv) -> tuple:
    """(kernel launches, wall seconds) of one CLI run in a subprocess."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, module, *map(str, argv)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli.{module} failed:\n{proc.stdout}\n{proc.stderr}")
    launches = json.loads(proc.stdout.strip().splitlines()[-1])["griffin_lim_phases"]
    return launches, seconds


def write_model_and_attr(d: Path, cfg, mels) -> tuple:
    """attr.pkl (mean and std of these mels) and a reference-format .ckpt of
    the seeded full-width model in ``d``; returns (attr, attr path, ckpt
    path, parameter count)."""
    allm = np.concatenate(mels)
    attr = {"mean": allm.mean(axis=0), "std": allm.std(axis=0)}
    check(bool((attr["std"] > 0).all()), "attr std has zeros")
    with open(d / "attr.pkl", "wb") as f:
        pickle.dump(attr, f)
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    save_checkpoint(model, str(d / "model.ckpt"))
    return attr, d / "attr.pkl", d / "model.ckpt", count_params(model)


def phase_main_path(card: str) -> dict:
    cfg_path = REPO / "examples" / "config.yaml"
    cfg = load_config(str(cfg_path))
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        src, tar, out = d / "source.wav", d / "target.wav", d / "converted.wav"
        make_wav(src, 4.0, 130.0, SEED)
        make_wav(tar, 4.0, 215.0, SEED + 1)
        mels = [get_spectrograms(str(p), cfg.signal)[0] for p in (src, tar)]
        check(mels[0].shape == (321, 512), f"source mel shape {mels[0].shape}")
        attr, attr_p, ckpt, n_params = write_model_and_attr(d, cfg, mels)
        log(f"[main] full examples/config.yaml model, {n_params} "
            f"parameters, seeded weights; 4 s wavs -> mels {mels[0].shape}")

        argv = ["-a", attr_p, "-c", cfg_path, "-m", ckpt, "-s", src, "-t", tar,
                "-o", out, "--gl_method", "fused"]
        launches, cli_s = run_cli("inference", argv)
        check(launches >= 1, "the CLI's conversion never launched the kernel")
        sr, wav = wavfile.read(out)
        n_max = SIG.hop_length * (328 - 1)
        check(sr == SIG.sr and wav.ndim == 1 and 0 < len(wav) <= n_max,
              f"output wav sr {sr}, shape {wav.shape}, expected 1-D <= {n_max}")
        check(bool(np.isfinite(wav).all()), "output wav not finite")
        log(f"[main] CLI one-shot conversion --gl_method fused: {len(wav)} samples "
            f"written (trimmed from {n_max}), kernel launches {launches}, "
            f"{cli_s:.2f} s wall clock for the whole process ({card})")

        # the converted mel on the card against the same model on the CPU
        gpu = load_checkpoint(str(ckpt), cfg.model, "cuda")
        cpu = load_checkpoint(str(ckpt), cfg.model, "cpu")
        norm = lambda m: torch.from_numpy(
            utt_make_frames(((m - attr["mean"]) / attr["std"]).astype(np.float32), 1)
        )
        x, xc = norm(mels[0]), norm(mels[1])
        with torch.no_grad():
            dec_gpu = gpu.inference(x.to(dev), xc.to(dev))
            dec_cpu = cpu.inference(x, xc)
        mel_err = float((dec_gpu.cpu() - dec_cpu).abs().max())
        check(tuple(dec_gpu.shape) == (1, 328, 512), f"converted mel {tuple(dec_gpu.shape)}")
        check(mel_err <= 1e-4, f"converted mel card vs CPU max|diff| {mel_err} > 1e-4")
        log(f"[main] converted mel (1, 328, 512) card vs CPU, TF32 off: max|diff| "
            f"{mel_err:.3e} (tol 1e-4)")

        # fused against exact vocoder on the same magnitude
        mean = torch.from_numpy(attr["mean"]).to(dev)
        std = torch.from_numpy(attr["std"]).to(dev)
        mel = dec_gpu[0] * std + mean
        mag = mel_to_mag(mel, SIG)
        with torch.no_grad():
            wav_f = griffin_lim(mag, SIG, method="fused")
            wav_e = griffin_lim(mag, SIG, method="exact")
        for w in (wav_f, wav_e):
            check(tuple(w.shape) == (n_max,) and bool(torch.isfinite(w).all()),
                  f"vocoder wav shape {tuple(w.shape)} or not finite")
        mag_np = mag.cpu().numpy()
        sc_f, sc_e = _sc(mag_np, wav_f.cpu().numpy()), _sc(mag_np, wav_e.cpu().numpy())
        check(sc_f < sc_e + 0.05, f"fused SC {sc_f} not < exact SC {sc_e} + 0.05")
        log(f"[main] vocoder SC on the converted magnitude: fused {sc_f:.5f}, "
            f"exact {sc_e:.5f} (fused must be < exact + 0.05)")

        with torch.no_grad():
            model_ms = cuda_ms(lambda: gpu.inference(x.to(dev), xc.to(dev)), reps=20)
            busy = device_us_by_kernel(lambda: gpu.inference(x.to(dev), xc.to(dev)))
        busy_ms = sum(us for us, _ in busy.values()) / 1e3
        log(f"[time] model device busy {busy_ms:.4f} ms of {model_ms:.4f} ms "
            f"(torch.profiler kernel time over the CUDA-event span): idle share "
            f"{1 - busy_ms / model_ms:.3f}, {sum(c for _, c in busy.values())} "
            f"kernel launches ({card})")
        voc_ms = {}
        for method in ("fused", "exact"):
            melspectrogram2wav(mel, SIG, gl_method=method)  # warm-up
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                melspectrogram2wav(mel, SIG, gl_method=method)
                runs.append((time.perf_counter() - t0) * 1e3)
            voc_ms[method] = float(np.median(runs))
        log(f"[time] model AE.inference 321 -> 328 frames, TF32 off: {model_ms:.4f} ms "
            f"({card})")
        log(f"[time] vocoder melspectrogram2wav, one 4 s utterance, 100 iterations: "
            f"fused {voc_ms['fused']:.3f} ms, exact {voc_ms['exact']:.3f} ms "
            f"(host clock, median of 3) ({card})")
    return {"launches": launches, "model_ms": model_ms, "voc_ms": voc_ms,
            "sc_fused": sc_f, "sc_exact": sc_e, "mel_err": mel_err}


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of fn() followed by a synchronise, after one
    warm-up run."""
    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(runs))


def phase_serving(card: str) -> None:
    """Batched serving: the 4 x 8 mixed-length grid through the convert_grid
    CLI, then in process against one-at-a-time conversion."""
    cfg_path = REPO / "examples" / "config.yaml"
    cfg = load_config(str(cfg_path))
    dev = torch.device("cuda")
    ns, nt = len(GRID_SRC_FRAMES), len(GRID_TAR_FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        srcs = [d / f"src{i}.wav" for i in range(ns)]
        tars = [d / f"tar{j}.wav" for j in range(nt)]
        frames = GRID_SRC_FRAMES + GRID_TAR_FRAMES
        for k, (path, n) in enumerate(zip(srcs + tars, frames)):
            # hop * (n - 1) samples frame into exactly n frames
            make_wav(path, SIG.hop_length * (n - 1) / SIG.sr, 110.0 + 17.0 * k, SEED + 20 + k)
        mels = [get_spectrograms(str(p), cfg.signal)[0] for p in srcs + tars]
        check(tuple(m.shape[0] for m in mels) == frames,
              f"grid mel frame counts {[m.shape[0] for m in mels]}, expected {frames}")
        attr, attr_p, ckpt, n_params = write_model_and_attr(d, cfg, mels)
        out = d / "grid"
        argv = ["-a", attr_p, "-c", cfg_path, "-m", ckpt, "-s", *srcs, "-t", *tars,
                "-o", out, "--gl_method", "fused"]
        launches, cli_s = run_cli("convert_grid", argv)
        check(launches == 1, f"the grid launched the kernel {launches} times, expected exactly 1")
        written = sorted(q.name for q in out.iterdir())
        check(written == sorted(f"src{i}__to__tar{j}.wav" for i in range(ns) for j in range(nt)),
              f"convert_grid wrote {written}")
        for i in range(ns):
            n_max = SIG.hop_length * (GRID_SRC_FRAMES[i] - 1)
            for j in range(nt):
                sr, wav = wavfile.read(out / f"src{i}__to__tar{j}.wav")
                check(sr == SIG.sr and wav.ndim == 1 and 0 < len(wav) <= n_max,
                      f"grid wav {i},{j}: sr {sr}, shape {wav.shape}, expected 1-D <= {n_max}")
                check(bool(np.isfinite(wav).all()), f"grid wav {i},{j} not finite")
        log(f"[serving] full examples/config.yaml model, {n_params} parameters, seeded "
            f"weights; CLI convert_grid --gl_method fused: sources {GRID_SRC_FRAMES} x "
            f"targets {GRID_TAR_FRAMES} frames -> {ns * nt} wavs written, kernel launches "
            f"{launches} for the grid, {cli_s:.2f} s wall clock for the whole process ({card})")

        # in process, TF32 off: the grid against one-at-a-time conversion
        inf = Inferencer.from_torch_checkpoint(
            cfg, str(ckpt), str(attr_p), device="cuda", gl_method="fused"
        )
        src_m = [inf.normalize(m).astype(np.float32) for m in mels[:ns]]
        tar_m = [inf.normalize(m).astype(np.float32) for m in mels[ns:]]
        before = gl.griffin_lim_phases.launches
        wavs, grid_mels = inf.convert_grid(src_m, tar_m, trim=False, return_mels=True)
        check(gl.griffin_lim_phases.launches == before + 1,
              "convert_grid in process did not launch the kernel exactly once")
        pairs = [(s_, t_) for s_ in src_m for t_ in tar_m]
        # 6 iterations: warm start and polish alone, the mels do not depend on them
        _, pair_mels = inf.convert_pairs(pairs, gl_iters=6, trim=False, return_mels=True)
        err_single = err_pairs = 0.0
        for k, (s_, t_) in enumerate(pairs):
            # compared as the model returns them (normalized), the scale the
            # tolerance was stated for
            got = inf.normalize(grid_mels[k])
            single = inf.convert_mel(s_, t_)
            check(got.shape == single.shape == (GRID_BLOCK_FRAMES[k], 512),
                  f"pair {k}: grid mel {got.shape}, single {single.shape}")
            err_single = max(err_single, float(np.abs(got - single).max()))
            err_pairs = max(err_pairs, float(np.abs(grid_mels[k] - pair_mels[k]).max()))
            check(wavs[k].shape == (SIG.hop_length * (GRID_SRC_FRAMES[k // nt] - 1),)
                  and bool(np.isfinite(wavs[k]).all()), f"pair {k}: wav {wavs[k].shape} or not finite")
        check(err_single <= TOL_GRID_MEL,
              f"grid mels vs one-at-a-time max|diff| {err_single} > {TOL_GRID_MEL}")
        check(err_pairs <= TOL_GRID_MEL,
              f"convert_pairs mels vs grid max|diff| {err_pairs} > {TOL_GRID_MEL}")
        log(f"[serving] {ns * nt} pairs on the card, TF32 off: grid mels vs one-at-a-time "
            f"convert_mel max|diff| {err_single:.3e}, convert_pairs vs grid {err_pairs:.3e} "
            f"(tol {TOL_GRID_MEL})")

        # the ragged fused vocoder against the masked exact one, on a
        # consistent magnitude (a random-weight decoder's is not one)
        lengths = list(GRID_BLOCK_FRAMES)
        mag = torch.from_numpy(np.abs(ragged_grid_spec()).astype(np.float32)).to(dev)
        with torch.no_grad():
            w_f = griffin_lim_masked(mag, lengths, SIG, method="fused").cpu().numpy()
            w_e = griffin_lim_masked(mag, lengths, SIG, method="exact").cpu().numpy()
        check(bool(np.isfinite(w_f).all()), "ragged fused vocoder wave not finite")
        mag_np = mag.cpu().numpy()
        sc_f, sc_e = _block_scs(mag_np, w_f, lengths), _block_scs(mag_np, w_e, lengths)
        worst = max(f - e for f, e in zip(sc_f, sc_e))
        check(worst < 0.05, f"ragged fused SC exceeds masked exact SC by {worst} >= 0.05 in some block")
        log(f"[serving] ragged vocoder SC over 32 blocks: fused {min(sc_f):.5f}..{max(sc_f):.5f}, "
            f"masked exact {min(sc_e):.5f}..{max(sc_e):.5f}, largest fused - exact "
            f"{worst:.5f} (must be < 0.05)")

        # times
        src_b, sl_b, tar_b, tl_b = inf._grid_batch(src_m, tar_m)
        with torch.no_grad():
            model = lambda: ae_inference_masked(inf.model, src_b, sl_b, tar_b, tl_b)
            model_ms = cuda_ms(model, reps=10)
            busy = device_us_by_kernel(model)
            dec, dec_lens = model()
            voc_ms = {
                m: host_ms(lambda: inf._vocode(dec, dec_lens, m, None, False)) for m in ("fused", "exact")
            }
        busy_ms = sum(us for us, _ in busy.values()) / 1e3
        grid_ms = host_ms(lambda: inf.convert_grid(src_m, tar_m))
        untrimmed_ms = host_ms(lambda: inf.convert_grid(src_m, tar_m, trim=False))
        log(f"[time] serving model ae_inference_masked, {ns * nt} pairs (sources padded to 128, "
            f"targets to {max(GRID_TAR_FRAMES)} frames), TF32 off: {model_ms:.4f} ms by CUDA events; "
            f"device busy {busy_ms:.4f} ms (torch.profiler kernel time), idle share "
            f"{max(0.0, 1 - busy_ms / model_ms):.3f}, {sum(c for _, c in busy.values())} kernel "
            f"launches ({card})")
        log(f"[time] serving vocode chain for the grid (32 x 128 frames, 100 iterations, "
            f"denormalise to de-preemphasis): fused {voc_ms['fused']:.3f} ms, masked exact "
            f"{voc_ms['exact']:.3f} ms (host clock, median of 3) ({card})")
        log(f"[time] serving convert_grid --gl_method fused, {ns * nt} conversions from mels to "
            f"trimmed wavs on the host: {grid_ms:.3f} ms wall (host clock, median of 3) = "
            f"{ns * nt / grid_ms * 1e3:.1f} conversions per second; with trim=False "
            f"{untrimmed_ms:.3f} ms, so the host's trim of {ns * nt} wavs takes "
            f"{grid_ms - untrimmed_ms:.3f} ms ({card})")


def main() -> None:
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    kern = phase_kernel()
    main_path = phase_main_path(card)
    phase_serving(card)
    times = phase_kernel_times(card)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "griffin_lim_phases",
        "route": "cuda",
        "source": "adaptive_voice_conversion_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "adaptive_voice_conversion_tpu/kernels/griffin_lim.py:159",
        "launches": main_path["launches"],
        "max_abs_err": kern["a"]["max_abs_err"],
        "ms": times["main"]["ms"],
        "plain_ms": times["main"]["plain_ms"],
        "bound_ms": times["main"]["bound_ms"],
        "bound_by": times["main"]["bound_by"],
        "library_ms": times["main"]["library_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
