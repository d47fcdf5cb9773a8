#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card: require CUDA, print nvidia-smi's name and power limit, turn
     TF32 off for the parity phases;
  2. the build: compile csrc/griffin_lim.cu with nvcc for sm_90a;
  3. the fused Griffin-Lim kernel against its plain PyTorch version on the
     card, at the main path's shape (one utterance, t_pad 344) and at T=500
     (two 384-frame segments stacked along the rows);
  4. the main path at the full examples/config.yaml width: seeded wavs,
     attr.pkl and a reference-format .ckpt of seeded weights, then the
     one-shot conversion CLI with --gl_method fused in a subprocess, with
     the kernel's launch count read around it; the converted mel on the card
     against the same model on the CPU; fused against exact vocoder SC;
  5. times, each beside the card's name and power limit.
The last three lines are the kernels JSON line, the card line, and
{"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

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
from adaptive_voice_conversion_tpu_torch.dsp.stft import hann_window, istft, stft_np
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import (
    griffin_lim,
    mel_to_mag,
    melspectrogram2wav,
)
from adaptive_voice_conversion_tpu_torch.infer.inferencer import utt_make_frames
from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as gl
from adaptive_voice_conversion_tpu_torch.kernels._build import build
from adaptive_voice_conversion_tpu_torch.models.ae import AE, count_params
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
    for line in built.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build] {line.strip()}")


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


def phase_kernel() -> dict:
    dev = torch.device("cuda")
    out = {}
    for case, n_frames in (("a", MAIN_FRAMES), ("b", 500)):
        spec = synthetic_spec(n_frames, SEED + (case == "b"))
        spec_b = spec[None] if case == "a" else _stack_segments(spec)
        mag = torch.from_numpy(np.abs(spec_b).astype(np.float32)).to(dev)
        init = torch.from_numpy(spec_b).to(dev)
        mag_max = float(mag.max())
        before = gl.griffin_lim_phases.launches
        k1 = gl.griffin_lim_phases(mag, SIG, n_iter=1, init_spec=init)
        p1 = gl.griffin_lim_phases_plain(mag, SIG, n_iter=1, init_spec=init)
        torch.cuda.synchronize()
        err1 = float((k1 - p1).abs().max())
        fro1 = float(torch.linalg.norm(k1 - p1) / torch.linalg.norm(p1))
        check(torch.isfinite(k1.real).all().item(), f"case {case}: kernel output not finite")
        check(err1 <= TOL_ONE_ITER * mag_max,
              f"case {case}: n_iter=1 max|diff| {err1} > {TOL_ONE_ITER} * {mag_max}")
        check(fro1 <= TOL_ONE_ITER_FRO,
              f"case {case}: n_iter=1 relative Frobenius {fro1} > {TOL_ONE_ITER_FRO}")
        kn = gl.griffin_lim_phases(mag, SIG, n_iter=N_KERNEL_ITERS)
        pn = gl.griffin_lim_phases_plain(mag, SIG, n_iter=N_KERNEL_ITERS)
        torch.cuda.synchronize()
        check(gl.griffin_lim_phases.launches == before + 2,
              f"case {case}: launch counter did not move by 2")
        wk = istft(kn, SIG.n_fft, SIG.hop_length, SIG.win_length).cpu().numpy()
        wp = istft(pn, SIG.n_fft, SIG.hop_length, SIG.win_length).cpu().numpy()
        mag_np = mag.cpu().numpy()
        sck = max(_sc(mag_np[i], wk[i]) for i in range(len(wk)))
        scp = max(_sc(mag_np[i], wp[i]) for i in range(len(wp)))
        check(np.isfinite(wk).all(), f"case {case}: kernel wave not finite")
        check(abs(sck - scp) <= TOL_SC,
              f"case {case}: SC kernel {sck:.5f} vs plain {scp:.5f} differ > {TOL_SC}")
        t_pad = -(-mag.shape[2] // 8) * 8
        log(f"[kernel] case {case}: T={n_frames}, {mag.shape[0]} block(s) of "
            f"t_pad {t_pad} = {mag.shape[0] * t_pad} rows; n_iter=1 max|diff| {err1:.3e} "
            f"= {err1 / mag_max:.3e} of max|mag| (tol {TOL_ONE_ITER}), relative "
            f"Frobenius {fro1:.3e} (tol {TOL_ONE_ITER_FRO}); "
            f"n_iter={N_KERNEL_ITERS} SC kernel {sck:.5f} plain {scp:.5f} "
            f"(tol {TOL_SC})")
        out[case] = {"max_abs_err": err1, "fro": fro1, "sc_kernel": sck, "sc_plain": scp}
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


def kernel_bound(frames: int, n_iter: int) -> dict:
    """Least time for griffin_lim_phases on one utterance of `frames`
    frames from zero phase: the larger of the bytes it must move (inputs
    read once, outputs written once) over the HBM rate and its operations
    over the peak rate of their type. Counted at the sizes the function
    needs: `frames` rows, n_freq complex bins, the window's nonzero
    support. The bf16 products and the f32 rest run on separate units, so
    the operations take the larger of their two times. The kernel's padded
    sizes (t_pad rows, 2*f_pad columns, s_pad samples) are reported beside
    it as executed work."""
    c = gl._device_consts(SIG.n_fft, SIG.win_length, SIG.hop_length, torch.device("cuda"))
    n_freq = 1 + SIG.n_fft // 2
    support = int(np.count_nonzero(hann_window(SIG.win_length, SIG.n_fft)))
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
    rows = -(-frames // 8) * 8
    executed = 2 * (2 * rows * 2 * c.f_pad * c.s_pad)
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bf16_gflop_per_iter": bf16_flops / n_iter / 1e9,
        "f32_mflop_per_iter": f32_flops / n_iter / 1e6,
        "support": support,
        "executed_gflop_per_iter": executed / 1e9,
        "bytes_mb": n_bytes / 1e6,
        # what one iteration would move if basis and state came from HBM
        "per_iter_hbm_mb": (2 * c.s_pad * 2 * c.f_pad * 2 + 4 * rows * c.f_pad * 4
                            + rows * c.s_pad * (4 + 2) * 2) / 1e6,
    }


def phase_kernel_times(card: str) -> dict:
    dev = torch.device("cuda")
    spec = synthetic_spec(MAIN_FRAMES, SEED)
    mag = torch.from_numpy(np.abs(spec)[None].astype(np.float32)).to(dev)
    n = N_KERNEL_ITERS
    ms = cuda_ms(lambda: gl.griffin_lim_phases(mag, SIG, n_iter=n), reps=10)
    plain_ms = cuda_ms(lambda: gl.griffin_lim_phases_plain(mag, SIG, n_iter=n), reps=3, warmup=1)
    # yardstick, timed only: the two bf16 products of every iteration as
    # torch.matmul calls on the same shapes
    c = gl._device_consts(SIG.n_fft, SIG.win_length, SIG.hop_length, dev)
    rows = -(-MAIN_FRAMES // 8) * 8  # the kernel's padded shapes
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
    bound = kernel_bound(MAIN_FRAMES, n)
    split = device_us_by_kernel(lambda: gl.griffin_lim_phases(mag, SIG, n_iter=n))
    for name, (us, count) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        if "gl_" in name:
            short = name.split("::")[-1].split("(")[0]
            log(f"[time] kernel launch {short}: {us / count:.2f} us x {count} "
                f"(torch.profiler; the loop's launches overlap, each span "
                f"includes its wait on the one before) ({card})")
    log(f"[time] kernel griffin_lim_phases rows {rows} x {n} iters: {ms:.4f} ms per "
        f"conversion, {ms / n * 1e3:.2f} us per iteration, {3 * n + 1} CUDA launches "
        f"in one wrapper launch ({card})")
    log(f"[time] plain version {plain_ms:.4f} ms; library yardstick (2 bf16 "
        f"torch.matmul per iteration x {n}, device time by torch.profiler) "
        f"{library_ms:.4f} ms ({card})")
    log(f"[time] bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}: "
        f"{bound['bf16_gflop_per_iter']:.3f} bf16 GFLOP per iteration at "
        f"{MAIN_FRAMES} frames x {2 * (1 + SIG.n_fft // 2)} x {bound['support']} "
        f"samples (the kernel executes {bound['executed_gflop_per_iter']:.3f} "
        f"at its padded {rows} x {2 * c.f_pad} x {c.s_pad}), "
        f"{bound['f32_mflop_per_iter']:.2f} f32 MFLOP per iteration, "
        f"{bound['bytes_mb']:.2f} MB in+out once; "
        f"~{bound['per_iter_hbm_mb']:.1f} MB per iteration if basis, state and "
        f"scratch all went to HBM ({card})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound}


def make_wav(path: Path, seconds: float, f0: float, seed: int) -> None:
    """A seeded voiced-like wav: harmonics with vibrato, a slow envelope
    that trim_silence keeps whole, and a little noise in every mel band."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SIG.sr)
    t = np.arange(n) / SIG.sr
    phase = 2 * np.pi * f0 * np.cumsum(1.0 + 0.03 * np.sin(2 * np.pi * 4.0 * t)) / SIG.sr
    y = sum(rng.uniform(0.3, 1.0) / h * np.sin(h * phase) for h in range(1, 16))
    y = 0.3 * y * (0.7 + 0.3 * np.sin(2 * np.pi * 0.8 * t)) + 0.005 * rng.standard_normal(n)
    save_wav(str(path), y.astype(np.float32), SIG.sr)


# Runs the CLI's entry point in a fresh process and reports the kernel's
# launch count, reset just before the run and read just after it.
CLI_RUNNER = (
    "import json, sys\n"
    "from adaptive_voice_conversion_tpu_torch.cli.inference import main\n"
    "from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as gl\n"
    "gl.griffin_lim_phases.launches = 0\n"
    "main(sys.argv[1:])\n"
    "print(json.dumps({'griffin_lim_phases': gl.griffin_lim_phases.launches}))\n"
)


def phase_main_path(card: str) -> dict:
    cfg_path = REPO / "examples" / "config.yaml"
    cfg = load_config(str(cfg_path))
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        src, tar, attr_p, ckpt, out = (
            d / "source.wav", d / "target.wav", d / "attr.pkl", d / "model.ckpt",
            d / "converted.wav",
        )
        make_wav(src, 4.0, 130.0, SEED)
        make_wav(tar, 4.0, 215.0, SEED + 1)
        mels = [get_spectrograms(str(p), cfg.signal)[0] for p in (src, tar)]
        check(mels[0].shape == (321, 512), f"source mel shape {mels[0].shape}")
        allm = np.concatenate(mels)
        attr = {"mean": allm.mean(axis=0), "std": allm.std(axis=0)}
        check(bool((attr["std"] > 0).all()), "attr std has zeros")
        with open(attr_p, "wb") as f:
            pickle.dump(attr, f)
        model = AE(cfg.model)
        init_parameters(model, torch.Generator().manual_seed(SEED))
        save_checkpoint(model, str(ckpt))
        log(f"[main] full examples/config.yaml model, {count_params(model)} "
            f"parameters, seeded weights; 4 s wavs -> mels {mels[0].shape}")

        argv = ["-a", attr_p, "-c", cfg_path, "-m", ckpt, "-s", src, "-t", tar,
                "-o", out, "--gl_method", "fused"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_RUNNER, *map(str, argv)],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI failed:\n{proc.stdout}\n{proc.stderr}")
        launches = json.loads(proc.stdout.strip().splitlines()[-1])["griffin_lim_phases"]
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


def main() -> None:
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    kern = phase_kernel()
    main_path = phase_main_path(card)
    times = phase_kernel_times(card)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "griffin_lim_phases",
        "route": "cuda",
        "source": "adaptive_voice_conversion_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "adaptive_voice_conversion_tpu/kernels/griffin_lim.py:159",
        "launches": main_path["launches"],
        "max_abs_err": kern["a"]["max_abs_err"],
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
