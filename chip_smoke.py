#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card: require CUDA, print nvidia-smi's name and power limit, turn
     TF32 off for the parity phases;
  2. the build: compile csrc/griffin_lim.cu and csrc/hifigan_junction.cu
     with nvcc for sm_90a, and hold the constants they export against the
     Python models';
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
     the kernel's launch count read around it, and again with --gl_method
     pallas (the JAX package's name: the same wav); the converted mel on the card
     against the same model on the CPU; fused against exact vocoder SC;
  5. batched serving at the same width: 4 source and 8 target wavs of
     mixed lengths through the convert_grid CLI with --gl_method fused in a
     subprocess (32 wavs, one kernel launch for the grid); in process, the
     grid's mels against one-at-a-time conversion and against convert_pairs,
     the ragged fused vocoder's SC against the masked exact one's, and the
     serving times;
  5b. the HiFi-GAN generator at its published widths after the same model,
     seeded weights: convert_grid of 4 x 4 mixed lengths against the plain
     model and the plain generator (vc_bench/reference/hifigan.py) pair by pair,
     with TF32 off (held) and on (printed); the sha256 of the served wavs of
     a convert_grid call of 8 x 16 and of a one-shot conversion, with TF32
     convolutions, and the junction kernel's launches in each of the two
     calls (one a junction); the generator's time at 128 rows x 480 frames
     and a convert_grid call of 8 x 16; the junction kernel
     (csrc/hifigan_junction.cu) alone at that call's stage-3 and stage-4
     shapes, J1 and J2 at both and J0 and J3's three blocks at stage 4,
     against its plain version bit for bit, its time beside its bound and
     the plain version's;
  6. the kernel's times at both shapes, each beside the card's name and
     power limit;
  7. training at the same width (batch 128 x 128 frames x 512 mels): (a)
     one training step on the card against the same step on the CPU, with
     and without spectral norm; (b) the training CLI in a subprocess on a
     seeded synthetic corpus, 40 steps with summaries, evals, audio samples
     and rolling checkpoints; (c) a resumed run against the first run's
     series, bounded by what two identical runs differ by; (d) the one-shot
     conversion CLI with --gl_method fused on the trained checkpoint, one
     kernel launch; (e) the step's times in f32 with TF32 off and on and in
     bf16, its split, the data stream's and a checkpoint's cost. 7b-7c pin
     ``input_mode: host``, so they keep testing the host stream;
  8. the training data modes at the same width, on the phase-7 corpus: (a)
     the device-resident corpus against the host's packed array bit for bit
     (f32 and bf16), the on-card gather against the host gather, bounded
     draws; (b) the multi-step (10 steps in one call, f32, TF32 off, cuDNN
     deterministic) against 10 host steps on the card fed the same batches
     and eps; (c) one
     multi-step call under torch.cuda.set_sync_debug_mode("error"); (d) the
     training CLI in device mode (40 steps, then a resume from step 20) and
     in chunked mode (5 chunks, chunk_repeats auto, then a resume that must
     replay it), and the one-shot CLI on the device-mode checkpoint, one
     kernel launch; (e) the multi-step's times in turns with host steps on
     a resident batch, beside 7e's, and a 1 GB
     corpus streamed in 256 MiB chunks: the link's rate and the step with
     and without a chunk in flight;
  9. distribution, on the phase-7 corpus and the phase-5 grid. The card host
     has one GPU, so NCCL runs at world size 1 and two ranks share the card
     over gloo: (a) the training CLI under torchrun with --multihost (NCCL,
     world size 1) in device mode, 40 steps, against phase 8d's device-mode
     series; (b) two gloo ranks on the card (TF32 off, cuDNN deterministic),
     one data-parallel step of 64 rows each against one process's step on
     the 128 rows (in f64, and in f32 against one process's steps on the
     same 64-row halves), and a 10-step device_sharded multi-step whose ranks'
     metric rows must be equal bit for bit; (c) the 4 x 8 grid served by two
     gloo ranks with --gl_method fused, one kernel launch per rank, mels
     against the one-process grid, each pair's SC against the masked exact
     vocoder's; (d) the all-reduce's and the step's times under NCCL at world
     size 1 and over gloo. Times of ranks that share one card, not scaling;
 10. tensor parallelism at the same width: (a) entry() on the card against
     the same function on the CPU; (b) dp2 x tp2, four gloo ranks sharing
     the card (TF32 off, cuDNN deterministic), one step on a global batch of
     16 rows against one process's step on them, in f64 with and without
     spectral norm and in f32, the ranks of each model group equal; (c)
     dryrun_multichip(1) under NCCL at world size 1 and
     dryrun_multichip(4, backend="gloo") on the card; (d) the scaling sweep
     at sizes 1 and 2, which stops at 2 on a one-GPU host; (e) the
     tensor-parallel step's times, its model-axis collectives and the share
     of the step the gloo collectives take. Ranks sharing one card, not
     scaling;
 11. data preparation at the published signal config and the same width:
     (a) a seeded VCTK tree (16 speakers x 12 utterances of 2.0-6.0 s at 48
     kHz, none a whole number of seconds) through the preprocess_pipeline
     CLI on the card, and again with --host, every mel of the two runs
     within 5e-4 (the last frames included), attr.pkl within 1e-5 relative,
     the indexes and file lists equal; the featurizer's times per bucket
     batch against the host's; (b) the training CLI for 20 steps at batch
     128 on the dataset it wrote, finite losses, its audio-s/s and the
     step's MFU by utils/roofline.py; (c) the one-shot CLI with
     --gl_method fused from that checkpoint, one held-out speaker's wav to
     another's, one kernel launch, and again with --cpu_vocoder (the numpy
     oracle, no launch), the two vocoders' SC on the converted magnitude.
 12. the recorded experiments and the probes at the same width, on the
     phase-7 corpus: (a) every opt_fused mode (False, True, bucketed,
     bucketed8) for 10 device-mode steps from the same weights and seed, f32
     with TF32 off and cuDNN deterministic, each against the per-leaf chain
     (losses, grad_norm, parameters), in f32 and with opt_state_dtype
     bfloat16, and each mode's ms and launches a step at TF32 on; (b) the
     training CLI with opt_fused: bucketed4 for 20 steps, a twin of 10 and a
     run resumed from step 10 (phase 7's resume gate), then the one-shot CLI
     from the checkpoint with --gl_method fused, one kernel launch; (c)
     conv_bank_in and dual_conv_bank against conv_bank and conv1d, and the
     encoders fed bank_out, at the full width; (d) tools/perf_probes.py's
     bank, residual, bank_split, parts and opt through its CLI, each in a
     subprocess (all started together, each run in its turn while the
     others wait), their lines printed, then profile, whose trace must be
     written and non-empty;
 13. the device-mode step as a CUDA graph (train/step.py ``StepGraph``) at
     the same width, TF32 on as cli.train runs it, in f32, with spectral
     norm, in bf16 and with opt_fused bucketed4 and bf16 moments: 3 calls
     of 10 steps replayed from one captured step
     against the same calls run eagerly from the same weights and seed,
     every step's four metrics and every parameter, buffer and optimiser
     moment equal bit for bit (cuDNN deterministic) or within 1e-4 relative
     (cuDNN's default algorithms); a run resumed from the state after the
     first graphed call against the continuous run, alike; each mode's ms
     a step;
 14. HiFi-GAN V1 training (train/vocoder.py) at the published widths, the
     generator against the multi-period and multi-scale discriminators,
     batch 16 x 8400 samples on 48 seeded voiced utterances: (a) 3 steps of
     the program against the plain reference (vc_bench/reference/
     hifigan_train.py) from the same weights and draws, with TF32 off
     (held) and on (printed): the loss terms, the first gradients, the
     change after 3 steps; (b) the step's ms replayed from its two CUDA
     graphs, by span (vtrain.disc, vtrain.gen), and its launches, TF32 on;
     (c) the served
     generator's wavs (no gradient, the junction kernel), sha256, to hold
     against another commit's.
The last three lines are the kernels JSON line, the card line, and
{"ok": true, "device": {...}}.

Run as ``chip_smoke.py --rank <case> <dir> [<rank> <world> <init>]`` it is
one rank of phase 9 or 10b, started by the script itself.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import yaml
from scipy.io import wavfile

from adaptive_voice_conversion_tpu_torch.core.config import (
    SignalConfig,
    config_from_dict,
    config_to_dict,
    load_config,
)
from adaptive_voice_conversion_tpu_torch.data.chunked import ChunkedDeviceStreamer
from adaptive_voice_conversion_tpu_torch.data.dataset import SegmentDataset, to_bf16_bits
from adaptive_voice_conversion_tpu_torch.data.device_sampler import (
    DeviceResidentDataset,
    draw_indices,
    gather_rows,
    sample_segments,
)
from adaptive_voice_conversion_tpu_torch.data.loader import batch_iterator, device_prefetch
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
    SEG_FRAMES,
    _segment_starts,
    griffin_lim,
    griffin_lim_masked,
    mel_to_mag,
    melspectrogram2wav,
)
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer, utt_make_frames
from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as gl
from adaptive_voice_conversion_tpu_torch.kernels import hifigan as hj
from adaptive_voice_conversion_tpu_torch.kernels._build import build
from adaptive_voice_conversion_tpu_torch.models.ae import AE, count_params
from adaptive_voice_conversion_tpu_torch.models.hifigan import Generator
from adaptive_voice_conversion_tpu_torch.models.masked import ae_inference_masked
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.models.weights import (
    load_checkpoint,
    save_checkpoint,
)
from adaptive_voice_conversion_tpu_torch.train import vocoder as tv
from adaptive_voice_conversion_tpu_torch.train.checkpoint import CheckpointManager
from adaptive_voice_conversion_tpu_torch.train.optim import (
    kl_lambda,
    make_optimizer,
    make_train_optimizer,
)
from adaptive_voice_conversion_tpu_torch.train.step import (
    make_device_data_train_step,
    make_train_step,
    step_seed,
)
from adaptive_voice_conversion_tpu_torch.utils import profiling
from vc_bench.drivers import train_hifigan
from vc_bench.reference import hifigan as ref_hifigan
from vc_bench.reference import hifigan_train as ref_train

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
# One training step on the card against the same step on the CPU (f32, TF32
# off; the same weights, batch and eps): the losses to rtol 1e-4, the
# gradients' global norm to rtol 1e-3. The first Adam step moves every entry
# by lr * g / (|g| + 1e-8), about lr = 5e-4 in the direction of its
# gradient's sign whatever the gradient's size, so it amplifies the rounding
# of an entry whose gradient is near zero up to 2 * lr: on the card 1.4e-3
# of the 9 million entries came out beyond atol 1e-5 (the gradients are
# peaked at zero), far more than the 1e-4 first allowed. What is held
# instead: the first moments (0.1 x the clipped gradient with its weight
# decay: the same information before that amplification) to 1e-3 of their
# norm over all tensors (not tensor by tensor: the bias of a convolution
# that an instance norm follows has a gradient of exactly zero, so its
# moment is rounding noise around wd * p, 4e-3 apart); the updated
# parameters to atol 1e-5 at the entries whose gradient exceeds 1e-4 in
# magnitude on the CPU (10,000 x Adam's eps; 38% of the entries), but for
# one in a million of them (with spectral norm, whose rank-one gradient term
# carries a correlated error, 1 of 7.3 million entries above 1e-5 flipped);
# and no entry further apart than 2 * lr. The share beyond atol is printed.
# With spectral norm the advanced weight_u to atol 1e-5.
TOL_STEP_LOSS = 1e-4
TOL_STEP_GRAD_NORM = 1e-3
TOL_STEP_PARAM = 1e-5
STEP_CLEAR_GRADIENT = 1e-4
TOL_STEP_CLEAR_SHARE = 1e-6
TOL_STEP_MOMENT = 1e-3
TOL_STEP_U = 1e-5
# Resume on the card: cuDNN's backward kernels may sum in another order from
# run to run, so the bound is 10x what two identical runs from scratch differ
# by, and never under 1e-3 (relative difference of the loss)
RESUME_FLOOR = 1e-3
TRAIN_ITERS = 40
# seconds of audio in one training batch of 128 segments x 128 frames
AUDIO_S_PER_STEP = 128 * 128 * SIG.hop_length / SIG.sr


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
    for name in ("griffin_lim", "hifigan_junction"):
        built = build(name)
        log(f"[build] {built.path.name} in {built.seconds:.2f} s")
        worst = [ln.strip() for ln in built.log.splitlines() if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
        regs = sorted({int(ln.split("Used ")[1].split(" registers")[0]) for ln in built.log.splitlines() if "Used " in ln and " registers" in ln})
        log(f"[build] ptxas: {sum('Used ' in ln for ln in built.log.splitlines())} kernels, "
            f"registers per thread {regs}, kernels that spill: {len(worst)}")
        for line in worst:
            log(f"[build] {line}")
    flags = (hj.RES, hj.ACC, hj.SCALE, hj.STORE_V, hj.STORE_A)
    check(hj.kernel_flags() == flags, f"hj_flags {hj.kernel_flags()} != kernels/hifigan.py's {flags}")
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
    return np.stack([spec[:, s : s + SEG_FRAMES] for s in _segment_starts(spec.shape[1])])


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


def make_wav(path: Path, seconds: float, f0: float, seed: int, sr: int = SIG.sr) -> None:
    """A seeded voiced-like wav at ``sr``: harmonics with vibrato, a slow
    envelope that trim_silence keeps whole, and a little noise in every mel
    band."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    phase = 2 * np.pi * f0 * np.cumsum(1.0 + 0.03 * np.sin(2 * np.pi * 4.0 * t)) / sr
    y = sum(rng.uniform(0.3, 1.0) / h * np.sin(h * phase) for h in range(1, 16))
    y = 0.3 * y * (0.7 + 0.3 * np.sin(2 * np.pi * 0.8 * t)) + 0.005 * rng.standard_normal(n)
    save_wav(str(path), y.astype(np.float32), sr)


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
        # "pallas", the JAX package's name for the fused schedule
        alias_out = d / "converted_pallas.wav"
        alias_argv = argv[:-3] + [alias_out, "--gl_method", "pallas"]
        alias_launches, _ = run_cli("inference", alias_argv)
        _, alias_wav = wavfile.read(alias_out)
        check(alias_launches == launches, f"--gl_method pallas launched the kernel {alias_launches} "
              f"times, fused {launches}")
        check(np.array_equal(alias_wav, wav), "--gl_method pallas wrote another wav than fused: "
              f"max|diff| {float(np.abs(alias_wav - wav).max()) if alias_wav.shape == wav.shape else alias_wav.shape}")
        log(f"[main] CLI one-shot conversion --gl_method pallas (the JAX package's name): kernel "
            f"launches {alias_launches}, the wav equals --gl_method fused's bit for bit")

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


def phase_serving(card: str) -> dict:
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
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 5b: the HiFi-GAN generator
# ---------------------------------------------------------------------------

# the grid of phase 5b: mixed lengths over the benchmark's 120-480 frames
HIFIGAN_SRC_FRAMES = (480, 311, 120, 397)
HIFIGAN_TAR_FRAMES = (200, 455, 130, 349)
# the generator in f32 on the card at two batch shapes, TF32 off, against
# the plain reference pair by pair (cuDNN picks its algorithms by shape, so
# the sums differ in order: readings ~1e-6)
TOL_HIFIGAN_F32 = 1e-4


def phase_hifigan(card: str) -> dict:
    """The HiFi-GAN generator at its published widths (512 channels in,
    scales 5, 5, 4, 3) after the examples/config.yaml model, seeded weights:
    convert_grid's masked path against the plain model and the plain
    generator pair by pair, with TF32 off and on; the generator's time at
    the benchmark's largest call (128 rows of 480 frames)."""
    raw = config_to_dict(load_config(str(REPO / "examples" / "config.yaml")))
    raw["vocoder"] = {"kind": "hifigan"}
    cfg = config_from_dict(raw)
    voc = config_to_dict(cfg)["vocoder"]
    dev = torch.device("cuda")
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(SEED + 50))
    gen_params = ref_hifigan.make_params(voc, SEED + 51, dev)
    gen = Generator(cfg.vocoder)
    gen.load_state_dict(gen_params, strict=True)
    rng = np.random.default_rng(SEED + 52)
    with tempfile.TemporaryDirectory() as tmp:
        attr_p = Path(tmp) / "attr.pkl"
        with open(attr_p, "wb") as f:
            pickle.dump({"mean": (0.45 + 0.1 * rng.random(512)).astype(np.float32),
                         "std": (0.12 + 0.05 * rng.random(512)).astype(np.float32)}, f)
        inf = Inferencer(cfg, model, str(attr_p), device=dev, vocoder=gen)
    mels = [rng.standard_normal((n, 512)).astype(np.float32)
            for n in HIFIGAN_SRC_FRAMES + HIFIGAN_TAR_FRAMES]
    srcs, tars = mels[: len(HIFIGAN_SRC_FRAMES)], mels[len(HIFIGAN_SRC_FRAMES):]
    hop = SIG.hop_length
    refs = []
    with torch.no_grad():  # TF32 is off (phase 1)
        for s_ in srcs:
            for t_ in tars:
                dec = model.inference(torch.from_numpy(s_)[None].to(dev), torch.from_numpy(t_)[None].to(dev))
                refs.append(ref_hifigan.generate(dec[0], gen_params, voc)[: hop * (len(s_) - 1)].cpu().numpy())
    gaps = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        wavs = inf.convert_grid(srcs, tars, trim=False, len_bucket=32)
        gaps[tf32] = [float(np.linalg.norm(w - r) / np.linalg.norm(r)) for w, r in zip(wavs, refs)]
        check(all(w.shape == r.shape for w, r in zip(wavs, refs)), "generator wav lengths differ")
    check(max(gaps[False]) <= TOL_HIFIGAN_F32,
          f"convert_grid with the generator vs the plain references, TF32 off: {max(gaps[False])} "
          f"> {TOL_HIFIGAN_F32}")
    log(f"[hifigan] {count_params(model)} + {sum(p.numel() for p in gen.parameters())} parameters, "
        f"seeded; convert_grid {len(srcs)} x {len(tars)} (sources {HIFIGAN_SRC_FRAMES}, targets "
        f"{HIFIGAN_TAR_FRAMES} frames, len_bucket 32) vs the plain model and generator pair by pair, "
        f"||w - w_ref|| / ||w_ref||: TF32 off max {max(gaps[False]):.3e} mean {np.mean(gaps[False]):.3e} "
        f"(tol {TOL_HIFIGAN_F32}); TF32 on max {max(gaps[True]):.3e} mean {np.mean(gaps[True]):.3e}")

    # the served wavs at the cell's precision (cuDNN's TF32 convolutions, f32
    # matmuls), hashed: equal hashes on two commits are equal wavs; and the
    # junction kernel's launches on each path, counted from 0 around its call
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    hashes, launches = served_wav_hashes(inf, srcs, tars)
    for path, n in launches.items():
        check(n == gen.junctions, f"junction launches in a {path} call {n} != the generator's "
              f"{gen.junctions} junctions")
    log(f"[hifigan] served wavs, TF32 convolutions, sha256: convert_grid 8 x 16 (trimmed) "
        f"{hashes['grid']}, one-shot {hashes['oneshot']}; junction launches a call: convert_grid "
        f"{launches['grid']}, one-shot {launches['oneshot']}, of {gen.junctions} junctions")

    # the generator alone at the benchmark's largest call, TF32 on
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    b, t = 128, 480
    mel = torch.randn(b, t, 512, device=dev)
    lengths = torch.tensor(np.linspace(120, 480, b).round().astype(np.int64), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        masked_ms = cuda_ms(lambda: gen.generate(mel, lengths), reps=3)
        plain_ms = cuda_ms(lambda: gen.generate(mel), reps=3)
        call_ms = host_ms(lambda: inf.convert_grid(srcs * 2, tars * 4, trim=False, len_bucket=32))
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[time] hifigan generator, {b} rows x {t} frames, TF32: masked {masked_ms:.2f} ms, "
        f"unmasked {plain_ms:.2f} ms (CUDA events, mean of 3); peak {peak / 1e9:.2f} GB; "
        f"convert_grid 8 x 16 of the same mels, trim=False: {call_ms:.1f} ms host clock ({card})")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    del inf, gen, mel
    torch.cuda.empty_cache()
    return {"gap_tf32_off": max(gaps[False]), "gap_tf32_on": max(gaps[True]), "masked_ms": masked_ms,
            "hashes": hashes, "launches": launches, "junction": junction_times(card)}


def served_wav_hashes(inf, srcs, tars) -> tuple:
    """sha256 (16 hex digits) of the served wavs of a convert_grid call of
    2 x the sources by 4 x the targets (8 x 16 in phase 5b), trimmed, and of
    a one-shot conversion of the first source to the second target; and the
    junction kernel's launches in each of the two calls alone."""
    def digest(wavs) -> str:
        h = hashlib.sha256()
        for w in wavs:
            h.update(str(w.shape).encode() + np.ascontiguousarray(w).tobytes())
        return h.hexdigest()[:16]

    hashes, launches = {}, {}
    calls = {"grid": lambda: inf.convert_grid(srcs * 2, tars * 4, trim=True, len_bucket=32),
             "oneshot": lambda: [inf.inference_one_utterance(srcs[0], tars[1])[0]]}
    for path, call in calls.items():
        hj.junction.launches = 0
        hashes[path] = digest(call())
        launches[path] = hj.junction.launches
    return hashes, launches


# the benchmark's HiFi-GAN call: 128 rows padded to 480 frames, and the
# two last stages of the generator there (channels, samples a frame)
JUNCTION_ROWS, JUNCTION_FRAMES = 128, 480
JUNCTION_STAGES = {"stage 3": (64, 100), "stage 4": (32, 300)}
# the residual blocks a stage's mean runs over (J3)
JUNCTION_BLOCKS = 3


def junction_times(card: str) -> dict:
    """The junction kernel alone at the benchmark call's stage-3 and stage-4
    shapes, masked at lengths spread over 120-480 frames, with the
    convolution's bias: J1 and J2 at both, and at stage 4 also J0 and J3's
    three blocks in turn (the first, the middle, and the last with the mean
    and the next LeakyReLU), each held against its plain version bit for
    bit, then its time (CUDA events, mean of 20) beside its bound (the bytes
    its launches move over 3.35 TB/s) and the plain version's time (mean of
    5). Returns the stage-4 J2 entry."""
    dev = torch.device("cuda")
    lengths = torch.tensor(np.linspace(120, JUNCTION_FRAMES, JUNCTION_ROWS).round().astype(np.int64),
                           device=dev)
    bits = lambda t: t.view(torch.int32)
    out = {}
    for stage, (ch, scale) in JUNCTION_STAGES.items():
        shape = (JUNCTION_ROWS, ch, JUNCTION_FRAMES * scale)
        g = torch.Generator(device=dev).manual_seed(SEED + 53)
        c, x, c2 = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        bias = torch.randn(ch, generator=g, device=dev)
        # block j of J3 reads the convolution's output cs[j] and the residual
        # xs[j]; the sum lives in cs[0]'s buffer, which no block reads besides
        cs, xs = (c, c2, x), (x, x, c2)

        def run(fn, mode, clone):
            take = (lambda t: t.clone()) if clone else (lambda t: t)
            if mode != hj.J3:
                kw = {"x": x} if mode == hj.J2 else {}
                r = fn(mode, take(c), bias, lengths, scale, 0.1, **kw)
                return r if isinstance(r, tuple) else (r,)
            total = None
            for j in range(JUNCTION_BLOCKS):
                total = fn(mode, take(cs[j]), bias, lengths, scale, 0.1, x=xs[j], total=total, block=j,
                           n_blocks=JUNCTION_BLOCKS)
            return (total,)

        modes = (hj.J1, hj.J2) if stage != "stage 4" else (hj.J0, hj.J1, hj.J2, hj.J3)
        for mode in modes:
            got, want = run(hj.junction, mode, True), run(hj.junction_plain, mode, True)
            check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
                  f"junction {mode} at {stage} {shape} is not its plain version bit for bit")
            del got, want
            with torch.no_grad():
                ms = cuda_ms(lambda: run(hj.junction, mode, False), reps=20)
                plain_ms = cuda_ms(lambda: run(hj.junction_plain, mode, False), reps=5)
            blocks = range(JUNCTION_BLOCKS) if mode == hj.J3 else (0,)
            moved = sum(hj.junction_bytes(mode, shape, j, JUNCTION_BLOCKS) for j in blocks)
            bound_ms = moved / PEAK_BYTES * 1e3
            out[(stage, mode)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
            what = f"{mode} (its {JUNCTION_BLOCKS} blocks in turn)" if mode == hj.J3 else mode
            log(f"[time] junction {what}, {stage} {shape} f32, with bias, masked: {ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({moved / 1e9:.2f} GB at 3.35 TB/s; {bound_ms / ms:.1%} of it), plain "
                f"{plain_ms:.3f} ms; equal to the plain version bit for bit ({card})")
        del c, x, c2, cs, xs
    return out[("stage 4", hj.J2)]


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------


def step_inputs(cfg, seed: int) -> tuple:
    """A seeded global batch x (B, T, n_mels) and eps (B, T', c_out), f32
    on the CPU."""
    dl, ce = cfg.data_loader, cfg.model.content_encoder
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.standard_normal((dl.batch_size, dl.segment_size, ce.c_in)).astype(np.float32)
    )
    t_code = dl.segment_size // int(np.prod(ce.subsample))
    eps = torch.from_numpy(
        rng.standard_normal((dl.batch_size, t_code, ce.c_out)).astype(np.float32)
    )
    return x, eps


def train_step_card_vs_cpu(cfg, seed: int, lam: float = 0.5) -> dict:
    """One training step from the same seeded weights, batch and eps on the
    card and on the CPU (f32; the caller turns TF32 off). Returns the two
    metric dicts and the differences of what the step changed."""
    cpu = AE(cfg.model)
    init_parameters(cpu, torch.Generator().manual_seed(seed))
    card = copy.deepcopy(cpu).to("cuda")
    x, eps = step_inputs(cfg, seed)
    out = {"lr": cfg.optimizer.lr}
    opts = {}
    for name, model, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        opt = make_optimizer(cfg.optimizer, model.parameters(), state_dtype=cfg.opt_state_dtype)
        m = make_train_step(cfg, model, opt)(x.to(dev), lam, eps=eps.to(dev))
        out[name] = {k: float(v) for k, v in m.items()}
        opts[name] = opt
    n_total = n_beyond = n_clear = n_clear_beyond = 0
    worst_param = worst_moment = sq_diff = sq_m = 0.0
    b1 = cfg.optimizer.beta1
    for pc, pg in zip(cpu.parameters(), card.parameters()):
        diff = (pg.detach().cpu() - pc.detach()).abs()
        mc = opts["cpu"].state[pc]["exp_avg"].float()
        mg = opts["card"].state[pg]["exp_avg"].float().cpu()
        # after one step the first moment is (1 - b1) x the gradient Adam saw
        clear = (mc / (1.0 - b1)).abs() > STEP_CLEAR_GRADIENT
        n_total += diff.numel()
        n_clear += int(clear.sum())
        n_beyond += int((diff > TOL_STEP_PARAM).sum())
        n_clear_beyond += int((diff[clear] > TOL_STEP_PARAM).sum())
        worst_param = max(worst_param, float(diff.max()))
        worst_moment = max(worst_moment, float(torch.linalg.norm(mg - mc) / torch.linalg.norm(mc)))
        sq_diff += float((mg - mc).square().sum())
        sq_m += float(mc.square().sum())
    out.update(
        n_params=n_total, share_beyond=n_beyond / n_total, worst_param=worst_param,
        share_clear=n_clear / n_total, clear_beyond=n_clear_beyond / max(n_clear, 1),
        moment_all=(sq_diff / sq_m) ** 0.5, worst_moment=worst_moment,
    )
    if cfg.model.decoder.sn:
        bc, bg = dict(cpu.named_buffers()), dict(card.named_buffers())
        out["worst_u"] = max(
            float((bg[k].cpu() - bc[k]).abs().max()) for k in bc if k.endswith("weight_u")
        )
    return out


def check_step_parity(r: dict, what: str) -> None:
    rel = lambda k: abs(r["card"][k] - r["cpu"][k]) / abs(r["cpu"][k])
    for k in ("loss", "loss_rec", "loss_kl"):
        check(np.isfinite(r["card"][k]), f"{what}: {k} on the card is not finite")
        check(rel(k) <= TOL_STEP_LOSS, f"{what}: {k} card {r['card'][k]} vs CPU {r['cpu'][k]}: "
              f"relative {rel(k):.3e} > {TOL_STEP_LOSS}")
    check(rel("grad_norm") <= TOL_STEP_GRAD_NORM,
          f"{what}: grad_norm card {r['card']['grad_norm']} vs CPU {r['cpu']['grad_norm']}")
    check(r["clear_beyond"] <= TOL_STEP_CLEAR_SHARE,
          f"{what}: {r['clear_beyond']:.3e} of the updated parameters whose gradient exceeds "
          f"{STEP_CLEAR_GRADIENT} differ by more than {TOL_STEP_PARAM} (allowed {TOL_STEP_CLEAR_SHARE})")
    far = 2 * r["lr"] + TOL_STEP_PARAM
    check(r["worst_param"] <= far, f"{what}: an updated parameter differs by {r['worst_param']:.3e} > {far}")
    check(r["moment_all"] <= TOL_STEP_MOMENT,
          f"{what}: the first moments differ by {r['moment_all']:.3e} of their norm > {TOL_STEP_MOMENT}")
    if "worst_u" in r:
        check(r["worst_u"] <= TOL_STEP_U, f"{what}: weight_u differs by {r['worst_u']:.3e} > {TOL_STEP_U}")


def phase_train_step_parity(cfg) -> None:
    """7a: the step on the card against the step on the CPU, full width."""
    for sn in (False, True):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, decoder=dataclasses.replace(cfg.model.decoder, sn=sn)))
        t0 = time.perf_counter()
        r = train_step_card_vs_cpu(c, SEED + (1 if sn else 0))
        what = f"train step sn={sn}"
        check_step_parity(r, what)
        rel = lambda k: abs(r["card"][k] - r["cpu"][k]) / abs(r["cpu"][k])
        log(f"[train] 7a {what}, batch {c.data_loader.batch_size} x {c.data_loader.segment_size} x "
            f"{c.model.content_encoder.c_in}, {r['n_params']} parameters, card vs CPU, TF32 off: "
            f"loss {r['card']['loss']:.6f} vs {r['cpu']['loss']:.6f} (relative {rel('loss'):.2e}), "
            f"loss_rec {rel('loss_rec'):.2e}, loss_kl {rel('loss_kl'):.2e} (tol {TOL_STEP_LOSS}); "
            f"pre-clip grad_norm {r['card']['grad_norm']:.5f} vs {r['cpu']['grad_norm']:.5f} "
            f"(relative {rel('grad_norm'):.2e}, tol {TOL_STEP_GRAD_NORM}); first moments "
            f"{r['moment_all']:.2e} apart relative to their norm over all tensors (tol "
            f"{TOL_STEP_MOMENT}; worst single tensor {r['worst_moment']:.2e}); updated parameters: "
            f"of the {r['share_clear']:.3f} of the entries whose gradient exceeds "
            f"{STEP_CLEAR_GRADIENT}, {r['clear_beyond']:.1e} lie beyond atol {TOL_STEP_PARAM} (allowed "
            f"{TOL_STEP_CLEAR_SHARE}); over all entries largest |diff| {r['worst_param']:.2e} (the "
            f"first Adam step moves an entry by lr x g / (|g| + 1e-8), which amplifies the rounding "
            f"of a near-zero gradient up to 2 x lr = {2 * r['lr']:.0e}) and the share beyond atol "
            f"is {r['share_beyond']:.2e}"
            + (f"; weight_u max|diff| {r['worst_u']:.2e} (tol {TOL_STEP_U})" if sn else "")
            + f"; {time.perf_counter() - t0:.1f} s")


def write_corpus(d: Path, n_mels: int = 512, seg: int = 128) -> dict:
    """A seeded synthetic corpus in the preprocess artifacts' format: 64
    training utterances of 200-400 frames with 60 indexed segments each
    (3840 entries, 30 batches of 128 an epoch), an in_test split of 3
    utterances with 50 entries each, and attr.pkl. The mels are smooth
    low-rank patterns plus a per-utterance offset and a little noise,
    z-normalised by the attr statistics: something a model can learn."""
    rng = np.random.default_rng(SEED + 70)
    basis = np.cumsum(rng.standard_normal((12, n_mels)), axis=1)
    basis = (basis - basis.mean(axis=1, keepdims=True)) / basis.std(axis=1, keepdims=True)

    def utterance(n: int) -> np.ndarray:
        walk = np.cumsum(rng.standard_normal((n + 20, 12)), axis=0)
        coeff = np.stack([np.convolve(walk[:, j], np.ones(21) / 21, "valid")[:n] for j in range(12)], 1)
        coeff = (coeff - coeff.mean(axis=0)) / (coeff.std(axis=0) + 1e-6)
        speaker = 0.5 * rng.standard_normal(12) @ basis
        return (coeff @ basis / np.sqrt(12) + speaker + 0.1 * rng.standard_normal((n, n_mels)))

    def split(name: str, n_utts: int, per_utt: int, index_name: str) -> dict:
        data, index = {}, []
        for i in range(n_utts):
            n = int(rng.integers(200, 401))
            data[f"{name}_{i:03d}"] = utterance(n)
            index += [[f"{name}_{i:03d}", int(t)] for t in rng.integers(0, n - seg, per_utt)]
        return data, index, index_name

    splits = [split("train", 64, 60, f"train_samples_{seg}.json"),
              split("in_test", 3, 50, f"in_test_samples_{seg}.json")]
    allm = np.concatenate(list(splits[0][0].values()))
    mean, std = allm.mean(axis=0), allm.std(axis=0)
    for (data, index, index_name), pkl in zip(splits, (f"train_{seg}.pkl", "in_test.pkl")):
        with open(d / pkl, "wb") as f:
            pickle.dump({u: ((m - mean) / std).astype(np.float32) for u, m in data.items()}, f)
        with open(d / index_name, "w") as f:
            json.dump(index, f)
    # what a denormalised mel must be for mel_to_mag: values in (0, 1]
    attr = {"mean": np.full(n_mels, 0.5, np.float32), "std": np.full(n_mels, 0.15, np.float32)}
    with open(d / "attr.pkl", "wb") as f:
        pickle.dump(attr, f)
    return {"frames": int(allm.shape[0]), "entries": len(splits[0][1]), "seg": seg}


def run_train_cli(d: Path, argv, timeout: int = 600) -> float:
    """The training CLI as a user starts it; returns its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "adaptive_voice_conversion_tpu_torch.cli.train", *map(str, argv)],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )
    check(proc.returncode == 0, f"cli.train failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return time.perf_counter() - t0


def read_series(logdir: Path, tag: str) -> dict:
    """{step: {metric: value}} of one tag from a run's metrics.jsonl."""
    out = {}
    with open(logdir / "metrics.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            vals = {k[len(tag) + 1:]: v for k, v in rec.items() if k.startswith(tag + "/")}
            if vals:
                out.setdefault(rec["step"], {}).update(vals)
    return out


def train_argv(d: Path, cfg_path: Path, name: str, iters: int, *extra) -> list:
    return ["-config", cfg_path, "-data_dir", d, "-train_set", "train_128",
            "-train_index_file", "train_samples_128.json", "-logdir", d / f"log_{name}",
            "-store_model_path", d / name, "-iters", iters, "-summary_steps", 5,
            "-save_steps", 20, *extra]


def largest_rel_diff(a: dict, b: dict, steps, key: str = "loss") -> float:
    return max(abs(a[s][key] - b[s][key]) / abs(a[s][key]) for s in steps)


def phase_train_cli(card: str, d: Path, cfg_path: Path) -> dict:
    """7b-7d: train through the CLI, resume, and serve from the checkpoint."""
    corpus = write_corpus(d)
    log(f"[train] corpus: 64 utterances, {corpus['frames']} frames x 512 mels, "
        f"{corpus['entries']} indexed segments of {corpus['seg']} frames "
        f"({corpus['entries'] // 128} batches of 128 an epoch); in_test: 3 utterances, 150 segments")

    # 7b: the CLI trains
    eval_flags = ("-eval_set", "in_test", "-eval_steps", 20)
    cli_s = run_train_cli(d, train_argv(d, cfg_path, "model", TRAIN_ITERS, *eval_flags))
    train = read_series(d / "log_model", "init/ae_train")
    evals = read_series(d / "log_model", "init/ae_eval_in_test")
    audio = read_series(d / "log_model", "init/conversion_in_test")
    want_steps = list(range(0, TRAIN_ITERS, 5))
    check(sorted(train) == want_steps, f"train summaries at steps {sorted(train)}, expected {want_steps}")
    for s_, row in train.items():
        check(set(row) == {"loss", "loss_rec", "loss_kl", "grad_norm", "audio_sec_per_sec"},
              f"train summary keys at step {s_}: {sorted(row)}")
        check(all(np.isfinite(v) for v in row.values()), f"train summary at step {s_} not finite: {row}")
    first, last = train[want_steps[0]]["loss_rec"], train[want_steps[-1]]["loss_rec"]
    check(last < first, f"loss_rec did not fall: {first} at step 0, {last} at step {want_steps[-1]}")
    check(sorted(evals) == [19, 39], f"eval series at steps {sorted(evals)}, expected [19, 39]")
    check(all(np.isfinite(v) for row in evals.values() for v in row.values()), "eval series not finite")
    check(sorted(audio) == [19, 39] and all(r["audio_n_samples"] > 1000 for r in audio.values()),
          f"audio records {audio}, expected one per eval")
    check((d / "model.config.yaml").exists(), "model.config.yaml was not written")
    ckpts = sorted(q.name for q in (d / "model.ckpts").iterdir())
    check(ckpts == ["step_20.pt", "step_40.pt"], f"checkpoints {ckpts}, expected steps 20 and 40 only")
    for name in ckpts:
        state = torch.load(d / "model.ckpts" / name, map_location="cpu", weights_only=True)
        check(set(state) == {"model", "optimizer", "extra"} and state["extra"]["iteration"] == int(name[5:-3]),
              f"{name} is torn or of another format")
    log(f"[train] 7b cli.train -iters {TRAIN_ITERS} at the full examples/config.yaml width on cuda "
        f"(PyTorch's defaults: cuDNN convolutions in TF32): exit 0, loss_rec {first:.4f} at step 0 -> "
        f"{last:.4f} at step {want_steps[-1]}, eval loss_rec {evals[19]['loss_rec']:.4f} -> "
        f"{evals[39]['loss_rec']:.4f}, audio samples of {audio[19]['audio_n_samples']} samples, "
        f"checkpoints {ckpts}, {cli_s:.1f} s wall clock for the whole process; its own "
        f"audio_sec_per_sec at the last summary {train[want_steps[-1]]['audio_sec_per_sec']:.0f} "
        f"(includes the first steps' warm-up, an eval and a save) ({card})")

    # 7c: what two identical runs differ by, then the resumed run
    twin_s = run_train_cli(d, train_argv(d, cfg_path, "twin", 30))
    twin = read_series(d / "log_twin", "init/ae_train")
    common = [s_ for s_ in want_steps if s_ in twin]
    check(common == list(range(0, 30, 5)), f"twin run's summaries at {sorted(twin)}")
    noise = largest_rel_diff(train, twin, common)
    (d / "from20.ckpts").mkdir()
    shutil.copy(d / "model.ckpts" / "step_20.pt", d / "from20.ckpts" / "step_20.pt")
    res_s = run_train_cli(d, train_argv(d, cfg_path, "resumed", 10, "--load_model",
                                        "-load_model_path", d / "from20"))
    resumed = read_series(d / "log_resumed", "init/ae_train")
    check(sorted(resumed) == [20, 25], f"resumed run's summaries at {sorted(resumed)}, expected [20, 25]")
    gap = largest_rel_diff(train, resumed, [20, 25])
    bound = max(10 * noise, RESUME_FLOOR)
    check(gap <= bound, f"resumed run's loss differs from the first run's by {gap:.3e} > {bound:.3e}")
    check(sorted(q.name for q in (d / "resumed.ckpts").iterdir()) == ["step_30.pt"],
          "the resumed run did not save step 30")
    log(f"[train] 7c resume from step 20 for 10 steps against the first run at steps 20 and 25 "
        f"(the summaries both have): largest relative difference of loss {gap:.3e}; two identical "
        f"runs from scratch differ by {noise:.3e} over steps {common[0]}-{common[-1]}; bound "
        f"max(10 x that, {RESUME_FLOOR}) = {bound:.3e}; {twin_s:.1f} s and {res_s:.1f} s wall clock ({card})")

    # 7d: serve from the step-40 checkpoint through the one-shot CLI
    src, tar, out = d / "source.wav", d / "target.wav", d / "converted.wav"
    make_wav(src, 4.0, 130.0, SEED)
    make_wav(tar, 4.0, 215.0, SEED + 1)
    argv = ["-a", d / "attr.pkl", "-c", cfg_path, "-m", d / "model", "-s", src, "-t", tar,
            "-o", out, "--gl_method", "fused"]
    launches, serve_s = run_cli("inference", argv)
    check(launches == 1, f"serving from the checkpoint launched the kernel {launches} times, expected 1")
    sr, wav = wavfile.read(out)
    check(sr == SIG.sr and wav.ndim == 1 and len(wav) > 0, f"served wav sr {sr}, shape {wav.shape}")
    check(bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0, "served wav not finite or silent")
    inf = Inferencer.from_train_checkpoint(load_config(str(cfg_path)), str(d / "model"),
                                           str(d / "attr.pkl"), gl_method="fused")
    check(next(inf.model.parameters()).is_cuda and not inf.model.training,
          "from_train_checkpoint did not put an eval-mode model on the card")
    log(f"[train] 7d train -> serve: cli.inference -m <store_model_path> --gl_method fused on the "
        f"step-{TRAIN_ITERS} checkpoint: {len(wav)} samples, peak {float(np.abs(wav).max()):.4f}, "
        f"griffin_lim_phases launches {launches}, {serve_s:.1f} s wall clock ({card})")
    return {"serve_launches": launches, "resume_bound": bound}


def profile_phases(fns) -> list:
    """[(device us, kernel launches, the three kernels with most device
    time)] of each callable, run in order, each inside a torch.profiler
    trace of its own (device-side events only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    for fn in fns:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # kernels and copies only: the span the profiler shows on the device
        # for a host-side annotation (Optimizer.step#...) is not device work
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer.step#")]
        evts.sort(key=lambda e: -e.self_device_time_total)
        top = ", ".join(
            f"{e.key.replace('void ', '').split('(')[0].split('<')[0][-48:]} "
            f"{e.self_device_time_total / 1e3:.2f} ms x {e.count}" for e in evts[:3]
        )
        out.append((sum(float(e.self_device_time_total) for e in evts),
                    sum(int(e.count) for e in evts), top))
    return out


def phase_train_times(card: str, cfg, d: Path) -> dict:
    """7e: records, not gates. Returns the resident and streamed step ms
    (f32, TF32 on)."""
    dev = torch.device("cuda")
    dl = cfg.data_loader
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(dl.batch_size, dl.segment_size, 512, device=dev, generator=gen)
    variants = (
        ("f32, TF32 off", cfg, False),
        ("f32, TF32 on (convolutions and matmuls)", cfg, True),
        ("compute_dtype=bfloat16, opt_state_dtype=bfloat16",
         dataclasses.replace(cfg, compute_dtype="bfloat16", opt_state_dtype="bfloat16"), True),
    )
    step_ms = {}
    for label, c, tf32 in variants:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        model = AE(c.model)
        init_parameters(model, torch.Generator().manual_seed(SEED))
        model.to(dev)
        opt = make_optimizer(c.optimizer, model.parameters(), state_dtype=c.opt_state_dtype)
        step = make_train_step(c, model, opt)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(x, 0.01, generator=gen), reps=20, warmup=5)
        peak = torch.cuda.max_memory_allocated() / 1e6
        step_ms[label] = ms
        log(f"[time] train step {label}: {ms:.3f} ms per step (CUDA events, mean of 20 after 5 "
            f"warm-up steps) = {AUDIO_S_PER_STEP / ms * 1e3:.0f} audio-seconds per second "
            f"({AUDIO_S_PER_STEP} s of audio a step); peak device memory {peak:.0f} MB ({card})")

        # the step's three parts, each in a profiler trace of its own
        from adaptive_voice_conversion_tpu_torch.train.step import loss_terms
        state = {}

        def forward():
            opt.zero_grad(set_to_none=True)
            rec, kl, _ = loss_terms(model, c, x, generator=gen)
            state["loss"] = c.loss.lambda_rec * rec + 0.01 * kl

        parts = profile_phases((forward, lambda: state["loss"].backward(), opt.step))
        busy_ms = sum(part[0] for part in parts) / 1e3
        log(f"[time] train step {label}: device busy {busy_ms:.3f} ms of {ms:.3f} ms, idle share "
            f"{max(0.0, 1 - busy_ms / ms):.3f}; forward {parts[0][0] / 1e3:.3f} ms in {parts[0][1]} "
            f"launches, backward {parts[1][0] / 1e3:.3f} ms in {parts[1][1]}, optimiser "
            f"{parts[2][0] / 1e3:.3f} ms in {parts[2][1]}; {sum(part[1] for part in parts)} launches a "
            f"step (torch.profiler kernel time) ({card})")
        for name, part in zip(("forward", "backward", "optimiser"), parts):
            log(f"[time] train step {label}: {name}'s kernels with most device time: {part[2]} ({card})")
        if label.startswith("f32, TF32 on"):
            stream_model, stream_opt, stream_step, stream_cfg = model, opt, step, c
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # the host's part: gather one batch, pin it, copy it; then the step fed
    # by the prefetching stream against the step on a resident batch
    ds = SegmentDataset(str(d / "train_128.pkl"), str(d / "train_samples_128.json"), dl.segment_size)
    idx = np.random.default_rng(SEED).permutation(len(ds))[: dl.batch_size]
    gathers, copies = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        b = ds.gather(idx)
        t1 = time.perf_counter()
        torch.from_numpy(b).pin_memory().to(dev, non_blocking=True)
        torch.cuda.synchronize()
        gathers.append((t1 - t0) * 1e3)
        copies.append((time.perf_counter() - t1) * 1e3)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    batches = device_prefetch(batch_iterator(ds, dl.batch_size, seed=SEED), dev)
    for _ in range(5):
        stream_step(next(batches), 0.01, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        stream_step(next(batches), 0.01, generator=gen)
    torch.cuda.synchronize()
    streamed = (time.perf_counter() - t0) * 1e3 / 20
    batches.close()
    resident = step_ms["f32, TF32 on (convolutions and matmuls)"]
    log(f"[time] train data stream: host gather of one batch ({b.nbytes / 1e6:.1f} MB) "
        f"{np.median(gathers):.2f} ms, pin and copy to the card {np.median(copies):.2f} ms (host "
        f"clock, median of 5); the step fed by device_prefetch {streamed:.3f} ms per step (host "
        f"clock, 20 steps) against {resident:.3f} ms on a resident batch (f32, TF32 on): the "
        f"prefetch {'hides' if streamed <= 1.05 * resident else 'does not hide'} the host's part "
        f"({card})")

    # a checkpoint: the blocking snapshot, then the background write
    mngr = CheckpointManager(str(d / "timing.ckpts"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mngr.save(1, stream_model.state_dict(), stream_opt.state_dict(), {"iteration": 1, "seed": SEED})
    snap = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        stream_step(x, 0.01, generator=gen)
    torch.cuda.synchronize()
    beside = (time.perf_counter() - t0) * 1e3 / 5
    t0 = time.perf_counter()
    mngr.wait()
    rest = (time.perf_counter() - t0) * 1e3
    size = (d / "timing.ckpts" / "step_1.pt").stat().st_size / 1e6
    log(f"[time] train checkpoint: save() holds the loop {snap:.1f} ms (state copied to the host: "
        f"model, optimiser moments), the file ({size:.1f} MB) is written on a background thread; 5 "
        f"steps beside the write took {beside:.3f} ms each (host clock) against {resident:.3f} ms "
        f"alone, and wait() then took {rest:.1f} ms ({card})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"resident_ms": resident, "streamed_ms": streamed}


# ---------------------------------------------------------------------------
# Phase 8: the training data modes
# ---------------------------------------------------------------------------

# phase 8d's chunked run: 8,000,000 bytes of f32 rows of 512 mels = 3,906 rows
# a chunk, so the 19,453-frame corpus is 5 chunks
CHUNK_BYTES_CLI = 8_000_000
# phase 8e's large corpus: 500,000 frames x 512 mels f32 (1.024 GB) in
# 256 MiB chunks
BIG_FRAMES = 500_000
BIG_CHUNK_BYTES = 256 * 2**20


def phase_residency(card: str, ds: SegmentDataset, d: Path) -> None:
    """8a: the device-resident corpus bit for bit, the on-card gather
    against the host gather, bounded draws."""
    dev = torch.device("cuda")
    bf16_ds = SegmentDataset(str(d / "train_128.pkl"), str(d / "train_samples_128.json"),
                             ds.segment_size, storage_dtype="bfloat16")
    cases = (("f32 storage, f32 on the card", ds, "float32", ds.packed),
             ("f32 storage, bf16 on the card", ds, "bfloat16", to_bf16_bits(ds.packed)),
             ("bf16 storage, bf16 on the card", bf16_ds, "bfloat16", bf16_ds.packed))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, src, dtype, want in cases:
        res = DeviceResidentDataset(src, dev, dtype=dtype)
        got = res.packed.cpu()
        got = got.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" else got.numpy()
        check(np.array_equal(got, want), f"8a {label}: the resident corpus differs from the host's")
        check(np.array_equal(res.starts.cpu().numpy(), src.starts), f"8a {label}: starts differ")
        sel = draw_indices(len(src), 128, gen)
        x = gather_rows(res.packed, res.starts, sel, src.segment_size).cpu()
        x = x.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" else x.numpy()
        host = src.gather(sel.cpu().numpy())
        host = to_bf16_bits(host) if dtype == "bfloat16" and host.dtype == np.float32 else host
        check(np.array_equal(x, host), f"8a {label}: gather_rows on the card differs from the host gather")
    n_valid = len(ds) // 3
    draws = draw_indices(len(ds), 10_000, gen, torch.tensor(n_valid, device=dev)).cpu().numpy()
    check(draws.min() >= 0 and draws.max() < n_valid,
          f"8a: draws bounded by n_valid {n_valid} reach [{draws.min()}, {draws.max()}]")
    log(f"[data] 8a DeviceResidentDataset on the card equals the host's packed array bit for bit "
        f"({ds.packed.shape[0]} x {ds.n_mels}: f32, f32 rounded to bf16, bf16 storage); gather_rows "
        f"of 128 segments on the card equals SegmentDataset.gather (the native memcpy gather) for "
        f"the same positions; 10,000 draws bounded by n_valid {n_valid} of {len(ds)} stay in "
        f"[{draws.min()}, {draws.max()}], {len(np.unique(draws))} distinct")


def fresh_model(cfg, dev):
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.to(dev)
    return model, make_optimizer(cfg.optimizer, model.parameters(), state_dtype=cfg.opt_state_dtype)


def phase_multi_step(card: str, cfg, ds: SegmentDataset) -> tuple:
    """8b and 8c, f32 with TF32 off: the multi-step against host steps fed
    the same batches and eps, then one call with host syncs made errors.

    cuDNN is held to its deterministic algorithms for 8b: at TF32 off its
    default backward algorithms sum in another order from run to run, and
    from the second step on Adam turns every near-zero gradient into lr x
    its sign, so two runs of the same steps part (on an H100 without it the
    losses were 6.8e-3 apart at the third step)."""
    dev = torch.device("cuda")
    K = 10
    res = DeviceResidentDataset(ds, dev, dtype="float32")
    model, opt = fresh_model(cfg, dev)
    host_model = copy.deepcopy(model)
    host_opt = make_optimizer(cfg.optimizer, host_model.parameters(), state_dtype=cfg.opt_state_dtype)
    multi = make_device_data_train_step(cfg, model, opt, inner_steps=K)
    step = make_train_step(cfg, host_model, host_opt)
    dl, ce = cfg.data_loader, cfg.model.content_encoder
    t_code = dl.segment_size // int(np.prod(ce.subsample))
    gen = torch.Generator(device=dev)
    rows = []
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        ms = multi(res.packed, res.starts, SEED, 0).cpu().numpy()
        multi_s = time.perf_counter() - t0
        for i in range(K):
            # the draws the multi-step made: the positions, then eps as the
            # model draws it, (B, c_out, T') before its transpose
            gen.manual_seed(step_seed(SEED, i))
            sel = draw_indices(len(ds), dl.batch_size, gen)
            eps = torch.randn((dl.batch_size, ce.c_out, t_code), generator=gen, device=dev).transpose(1, 2)
            x = torch.from_numpy(ds.gather(sel.cpu().numpy())).to(dev)
            m = step(x, kl_lambda(i, cfg.loss.lambda_kl, cfg.annealing_iters), eps=eps)
            rows.append([float(m[k]) for k in ("loss", "loss_rec", "loss_kl", "grad_norm")])
    finally:
        torch.backends.cudnn.deterministic = False
    host = np.array(rows)
    rel = np.abs(ms - host) / np.abs(host)
    worst_loss, worst_gn = float(rel[:, :3].max()), float(rel[:, 3].max())
    log(f"[data] 8b relative difference per step, loss / grad_norm: "
        + ", ".join(f"{a:.1e}/{b:.1e}" for a, b in zip(rel[:, :3].max(axis=1), rel[:, 3])))
    check(bool(np.isfinite(ms).all()), "8b: the multi-step's metrics are not finite")
    check(worst_loss <= TOL_STEP_LOSS,
          f"8b: the multi-step's losses differ from the host steps' by {worst_loss:.3e} > {TOL_STEP_LOSS}")
    check(worst_gn <= TOL_STEP_GRAD_NORM,
          f"8b: the multi-step's grad_norm differs from the host steps' by {worst_gn:.3e} > {TOL_STEP_GRAD_NORM}")
    log(f"[data] 8b make_device_data_train_step inner_steps={K} on the card (f32, TF32 off, cuDNN "
        f"deterministic, batch {dl.batch_size} x {dl.segment_size} x {ce.c_in} drawn on the card from "
        f"the {len(ds)}-segment corpus) against {K} host steps on the card fed the host gather of the "
        f"same positions and the same eps: largest relative difference of the losses {worst_loss:.3e} "
        f"(tol {TOL_STEP_LOSS}), of grad_norm {worst_gn:.3e} (tol {TOL_STEP_GRAD_NORM}); loss_rec "
        f"{ms[0, 1]:.4f} -> {ms[-1, 1]:.4f}; the call took {multi_s:.2f} s")

    # 8c: no host sync inside one call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = multi(res.packed, res.starts, SEED, K)
    except RuntimeError as exc:
        fail(f"8c: a multi-step call synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "8c: the multi-step's metrics are not finite")
    log(f"[data] 8c one multi-step call of {K} steps under torch.cuda.set_sync_debug_mode('error'): "
        "no host synchronisation")
    return model, opt, res


def run_clis(runs) -> list:
    """Start every (label, argv) training CLI at once (they share the card),
    wait for all; returns (stdout, wall seconds) of each."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "adaptive_voice_conversion_tpu_torch.cli.train", *map(str, argv)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for _, argv in runs]
    out = []
    try:
        for (label, _), proc in zip(runs, procs):
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"cli.train {label} failed:\n{stdout[-3000:]}\n{stderr[-3000:]}")
            out.append((stdout, time.perf_counter() - t0))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return out


def phase_mode_clis(card: str, d: Path, ds: SegmentDataset, resume_bound: float) -> dict:
    """8d: the training CLI in device and chunked mode, resumed, and the
    one-shot CLI on the device-mode checkpoint."""
    dev_cfg = config_copy(d, "config_device.yaml", input_mode="device")
    chk_cfg = config_copy(d, "config_chunked.yaml", input_mode="chunked",
                          chunk_bytes=CHUNK_BYTES_CLI, chunk_repeats="auto")
    eval_flags = ("-eval_set", "in_test", "-eval_steps", 20)
    (_, dev_s), (chk_out, chk_s) = run_clis([
        ("device", train_argv(d, dev_cfg, "dev", TRAIN_ITERS, *eval_flags)),
        ("chunked", train_argv(d, chk_cfg, "chk", 20, "-save_steps", 10)),
    ])
    train = read_series(d / "log_dev", "init/ae_train")
    evals = read_series(d / "log_dev", "init/ae_eval_in_test")
    check(sorted(train) == [9, 19, 29, 39], f"8d device mode: summaries at {sorted(train)}, expected [9, 19, 29, 39]")
    check(all(np.isfinite(v) for row in train.values() for v in row.values()), "8d device mode: summaries not finite")
    check(sorted(evals) == [19, 39], f"8d device mode: evals at {sorted(evals)}, expected [19, 39]")
    ckpts = sorted(q.name for q in (d / "dev.ckpts").iterdir())
    check(ckpts == ["step_20.pt", "step_40.pt"], f"8d device mode: checkpoints {ckpts}")
    check(train[39]["loss_rec"] < train[9]["loss_rec"],
          f"8d device mode: loss_rec did not fall: {train[9]['loss_rec']} -> {train[39]['loss_rec']}")
    chk_train = read_series(d / "log_chk", "init/ae_train")
    check(sorted(chk_train) == [9, 19], f"8d chunked mode: summaries at {sorted(chk_train)}, expected [9, 19]")
    resolved = [ln for ln in chk_out.splitlines() if ln.startswith("chunk_repeats=auto ->")]
    check(len(resolved) == 1, f"8d chunked mode: no chunk_repeats resolution printed:\n{chk_out[-2000:]}")
    repeats = int(resolved[0].split("->")[1].split()[0])
    extra = torch.load(d / "chk.ckpts" / "step_20.pt", map_location="cpu", weights_only=True)["extra"]
    check(extra.get("chunk_repeats") == repeats, f"8d chunked mode: checkpoint extra {extra}, resolved {repeats}")
    plan = ChunkedDeviceStreamer(ds, CHUNK_BYTES_CLI, 128, inner_steps=10, seed=SEED)
    check(plan.n_chunks == 5, f"8d chunked mode: {plan.n_chunks} chunks of {plan.R} rows, expected 5")

    (d / "dev20.ckpts").mkdir()
    shutil.copy(d / "dev.ckpts" / "step_20.pt", d / "dev20.ckpts" / "step_20.pt")
    src, tar, out = d / "source.wav", d / "target.wav", d / "converted_dev.wav"
    serve_argv = ["-a", d / "attr.pkl", "-c", dev_cfg, "-m", d / "dev", "-s", src, "-t", tar,
                  "-o", out, "--gl_method", "fused"]
    with ThreadPoolExecutor(max_workers=1) as pool:
        serving = pool.submit(run_cli, "inference", serve_argv)
        (_, res_s), (chk2_out, chk2_s) = run_clis([
            ("device resumed", train_argv(d, dev_cfg, "dev_res", 20, "--load_model",
                                          "-load_model_path", d / "dev20")),
            ("chunked resumed", train_argv(d, chk_cfg, "chk_res", 10, "--load_model",
                                           "-load_model_path", d / "chk", "-save_steps", 10)),
        ])
        launches, serve_s = serving.result()
    resumed = read_series(d / "log_dev_res", "init/ae_train")
    check(sorted(resumed) == [29, 39], f"8d device mode resumed: summaries at {sorted(resumed)}")
    gap = largest_rel_diff(train, resumed, [29, 39])
    check(gap <= resume_bound, f"8d device mode resumed: loss differs by {gap:.3e} > {resume_bound:.3e}")
    check(not any(ln.startswith("chunk_repeats=auto ->") for ln in chk2_out.splitlines()),
          "8d chunked mode resumed: chunk_repeats was measured again, not replayed")
    extra2 = torch.load(d / "chk_res.ckpts" / "step_30.pt", map_location="cpu", weights_only=True)["extra"]
    check(extra2.get("chunk_repeats") == repeats, f"8d chunked resumed: checkpoint extra {extra2}")
    check(launches == 1, f"8d serving the device-mode checkpoint launched the kernel {launches} times, expected 1")
    sr, wav = wavfile.read(out)
    check(sr == SIG.sr and wav.ndim == 1 and len(wav) > 0 and bool(np.isfinite(wav).all()),
          f"8d served wav sr {sr}, shape {wav.shape} or not finite")
    log(f"[data] 8d cli.train input_mode device, {TRAIN_ITERS} steps: summaries at {sorted(train)}, "
        f"loss_rec {train[9]['loss_rec']:.4f} -> {train[39]['loss_rec']:.4f}, evals at {sorted(evals)}, "
        f"checkpoints {ckpts}; resumed from step 20: largest relative difference of loss at 29, 39 "
        f"{gap:.3e} (bound {resume_bound:.3e}, 7c's); {dev_s:.1f} s and {res_s:.1f} s wall clock "
        f"(run beside the chunked runs) ({card})")
    log(f"[data] 8d cli.train input_mode chunked, chunk_bytes {CHUNK_BYTES_CLI}: {plan.n_chunks} chunks "
        f"of R = {plan.R} rows, dropped_segments {plan.dropped_segments} of {len(ds)} "
        f"(straddling a chunk edge), epoch {plan.epoch_steps} steps; chunk_repeats auto resolved to "
        f"{repeats} ({resolved[0]}), kept in the checkpoint and replayed by the resumed run without "
        f"measuring; summaries at {sorted(chk_train)}; {chk_s:.1f} s and {chk2_s:.1f} s wall clock ({card})")
    log(f"[data] 8d train (device mode) -> serve: cli.inference -m <store_model_path> --gl_method fused "
        f"on the step-{TRAIN_ITERS} checkpoint: {len(wav)} samples, griffin_lim_phases launches "
        f"{launches}, {serve_s:.1f} s wall clock ({card})")
    return {"device_serve_launches": launches, "chunk_repeats": repeats}


def stream_ms(fn) -> float:
    """Host-clock ms of fn() to the end of the compute stream's work (a
    chunk copy on the side stream is not waited for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.current_stream().synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_mode_times(card: str, cfg, ds: SegmentDataset, model, opt, res, seven: dict) -> None:
    """8e: records, not gates, at TF32 on (as cli.train runs)."""
    dev = torch.device("cuda")
    K = 10
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        multi = make_device_data_train_step(cfg, model, opt, inner_steps=K)
        call = lambda: multi(res.packed, res.starts, SEED, 0)
        # the host step on one resident batch, timed the same way in turns
        gen = torch.Generator(device=dev).manual_seed(SEED)
        sel = draw_indices(len(ds), cfg.data_loader.batch_size, gen)
        x = gather_rows(res.packed, res.starts, sel, ds.segment_size)
        host_step = make_train_step(cfg, model, opt)
        resident = lambda: [host_step(x, 0.01, generator=gen) for _ in range(K)]
        call()
        resident()
        torch.cuda.reset_peak_memory_stats()
        runs, res_runs = [], []
        for _ in range(3):
            runs.append(stream_ms(call) / K)
            res_runs.append(stream_ms(resident) / K)
        peak = torch.cuda.max_memory_allocated() / 1e6
        per_step = float(np.median(runs))
        busy_us, launches, top = profile_phases([call])[0]
        busy = busy_us / 1e3 / K
        log(f"[time] data multi-step (device mode, {K} steps a call, f32, TF32 on): "
            f"{', '.join(f'{r:.3f}' for r in runs)} ms per step, in turns with {K} host steps on one "
            f"resident batch: {', '.join(f'{r:.3f}' for r in res_runs)} ms per step (host clock to "
            f"the end of each call; medians {per_step:.3f} and {np.median(res_runs):.3f}, "
            f"{per_step / np.median(res_runs):.3f}x) = {AUDIO_S_PER_STEP / per_step * 1e3:.0f} "
            f"audio-seconds per second; 7e's step {seven['resident_ms']:.3f} ms on a resident batch "
            f"(CUDA events) and {seven['streamed_ms']:.3f} ms fed by the host stream; device busy "
            f"{busy:.3f} ms a step, idle share {max(0.0, 1 - busy / per_step):.3f}, "
            f"{launches / K:.0f} launches a step (torch.profiler kernel time over one call); peak "
            f"device memory {peak:.0f} MB ({card})")
        log(f"[time] data multi-step: kernels with most device time in one call: {top} ({card})")

        # a corpus over 1 GB in 256 MiB chunks: the phase-7 corpus repeated
        big = np.resize(ds.packed, (BIG_FRAMES, ds.n_mels))
        big_ds = SimpleNamespace(packed=big, starts=np.arange(0, BIG_FRAMES - 128, 64),
                                 segment_size=ds.segment_size)
        st = ChunkedDeviceStreamer(big_ds, BIG_CHUNK_BYTES, 128, inner_steps=K, seed=SEED, device=dev)
        nbytes = st.chunk_nbytes()
        puts = []
        for c in range(2):  # the first allocates pinned and device memory
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk = st.put_chunk(c)
            t_call = time.perf_counter() - t0
            chunk.ready.synchronize()
            puts.append((t_call * 1e3, (time.perf_counter() - t0) * 1e3))
        pinned = chunk.host[0]
        link_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), reps=5, warmup=1)
        chunk = chunk.acquire()
        padded = make_device_data_train_step(cfg, model, opt, inner_steps=K, padded_starts=True)
        step_call = lambda: padded(chunk.packed, chunk.starts, chunk.n_starts, SEED, 0)
        step_call()
        alone, beside = [], []
        with ThreadPoolExecutor(max_workers=1) as pool:
            for rep in range(3):
                alone.append(stream_ms(step_call) / K)
                nxt = pool.submit(st.put_chunk, 2 + rep % 2)
                beside.append(stream_ms(step_call) / K)
                nxt.result().ready.synchronize()
        log(f"[time] data chunked: a corpus of {BIG_FRAMES} x {ds.n_mels} f32 ({big.nbytes / 1e9:.3f} GB: "
            f"the phase-7 corpus repeated by np.resize, a segment start every 64 rows) in "
            f"{st.n_chunks} chunks of {st.R} rows ({nbytes / 2**20:.0f} MiB); put_chunk returns in "
            f"{puts[1][0]:.1f} ms (the copy into pinned memory) and the chunk is on the card "
            f"{puts[1][1]:.1f} ms after the call = {nbytes / puts[1][1] / 1e6:.2f} GB/s end to end "
            f"(first chunk {puts[0][1]:.1f} ms, with the allocations); the pinned copy alone "
            f"{link_ms:.3f} ms = {nbytes / link_ms / 1e6:.2f} GB/s (CUDA events, mean of 5) ({card})")
        log(f"[time] data chunked: multi-step on a resident chunk, no chunk in flight "
            f"{', '.join(f'{v:.3f}' for v in alone)} ms per step; with the next chunk's put_chunk on a "
            f"thread and its copy on the side stream {', '.join(f'{v:.3f}' for v in beside)} ms per "
            f"step (host clock to the end of the compute stream, {K} steps a call; median "
            f"{np.median(beside) / np.median(alone):.3f}x) ({card})")
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_data_modes(card: str, cfg, d: Path, seven: dict) -> dict:
    """Phase 8 on the phase-7 corpus in ``d``."""
    t0 = time.perf_counter()
    ds = SegmentDataset(str(d / "train_128.pkl"), str(d / "train_samples_128.json"),
                        cfg.data_loader.segment_size)
    phase_residency(card, ds, d)
    model, opt, res = phase_multi_step(card, cfg, ds)
    out = phase_mode_clis(card, d, ds, seven["resume_bound"])
    phase_mode_times(card, cfg, ds, model, opt, res, seven)
    log(f"[data] phase 8 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 9: distribution
# ---------------------------------------------------------------------------

# 9b: two ranks' data-parallel step against one process's step on the same
# global batch (f32, TF32 off, cuDNN deterministic): the losses and
# grad_norm to rtol 1e-5 and the all-reduced gradient to a relative
# Frobenius 1e-5 over all tensors, the JAX package's bound for its sharded
# step (tests/test_distributed.py:58-65). Gradients, not the parameters after
# Adam: its first step moves an entry by about lr x sign(g) whatever |g|, so
# it magnifies the rounding of near-zero gradients (7a). In f32 the card
# computes a 64-row batch in another order than a 128-row one (cuDNN picks its
# algorithms by the shape; PyTorch's own convolutions and reductions tile by
# it too), and at this width that alone put the gradients 2.5e-5 (cuDNN)
# and 3.1e-5 (cuDNN off) apart on an H100 (80GB HBM3, 700 W), data axis or
# not. So the step runs twice: in f64, where that rounding is ~1e-13, the
# ranks are held against one process's step on the 128 rows; in f32,
# against the mean of one process's steps on each rank's 64 rows.
TOL_DIST = 1e-5
DIST_WORLD = 2


def rank_env() -> dict:
    """The ranks' environment: collectives on the loopback interface (the
    card's host has no other network)."""
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    return env


def spawn_ranks(case: str, work: Path, timeout: int = 600, world: int = DIST_WORLD) -> list:
    """``world`` gloo ranks of this script, all on cuda:0; returns their
    outputs in rank order."""
    init = f"file://{work / f'rendezvous_{case}'}"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--rank", case, str(work), str(r),
         str(world), init],
        cwd=REPO, env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"rank {r} of {case} exited {p.returncode}:\n{text[-3000:]}")
    return [torch.load(work / f"out_{case}_{r}.pt", weights_only=False) for r in range(world)]


def torchrun(argv, timeout: int = 600) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc_per_node 1``
    with these arguments (NCCL at world size 1: the card host has one GPU);
    returns (stdout, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         *map(str, argv)],
        cwd=REPO, env=rank_env(), capture_output=True, text=True, timeout=timeout,
    )
    check(proc.returncode == 0, f"torchrun {argv[:2]} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


STEP_DTYPES = {"f64": torch.float64, "f32": torch.float32}


def one_step(cfg, dev, x, eps, dtype: str, mesh=None) -> dict:
    """One training step from the seeded weights on rows ``x`` with their
    ``eps``, the model, the rows and ``eps`` in ``STEP_DTYPES[dtype]`` (the
    caller turns TF32 off). Returns the metrics, the gradient as one flat
    f64 CPU tensor (all-reduced under a mesh) and the step's host-clock
    time."""
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.to(dev, STEP_DTYPES[dtype])
    opt = make_optimizer(cfg.optimizer, model.parameters(), state_dtype=cfg.opt_state_dtype)
    step = make_train_step(cfg, model, opt, mesh)
    x, eps = x.to(dev, STEP_DTYPES[dtype]), eps.to(dev, STEP_DTYPES[dtype])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(x, 0.5, eps=eps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"metrics": {k: float(v) for k, v in m.items()}, "ms": ms,
            "grad": torch.cat([p.grad.reshape(-1) for p in model.parameters()]).double().cpu()}


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def rank_step(spec: dict, mesh) -> dict:
    """9b on one rank: the data-parallel step on its 64 rows, the gloo
    all-reduce's time, then 10 device_sharded steps."""
    from adaptive_voice_conversion_tpu_torch.core.mesh import all_reduce_mean, row_window
    from adaptive_voice_conversion_tpu_torch.data.sharded import ShardedDeviceDataset

    cfg = load_config(str(REPO / "examples" / "config.yaml"))
    dev = torch.device("cuda:0")
    torch.backends.cudnn.deterministic = True
    x, eps = step_inputs(cfg, SEED + 90)
    lo, hi, _ = row_window(mesh, x.shape[0] // mesh.n_data)
    steps = {dt: one_step(cfg, dev, x[lo:hi], eps[lo:hi], dt, mesh) for dt in STEP_DTYPES}
    flat = steps["f32"]["grad"].float().to(dev)
    reduce_ms = []
    for _ in range(5):
        buf = flat.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_mean(mesh, buf)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    ds = SegmentDataset(spec["train_pkl"], spec["train_index"], cfg.data_loader.segment_size)
    shard = ShardedDeviceDataset(ds, mesh, dev, dtype="float32")
    model, opt = fresh_model(cfg, dev)
    multi = make_device_data_train_step(cfg, model, opt, inner_steps=10, sharded_data=True, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = multi(shard.packed, shard.starts, SEED, 0).cpu().numpy()
    multi_s = time.perf_counter() - t0
    return {"steps": steps, "reduce_ms": reduce_ms, "rows": rows, "multi_s": multi_s,
            "shard": (shard.packed.shape[0], shard.starts.shape[0], shard.dropped_segments)}


def grid_mels(cfg, spec: dict, inf) -> tuple:
    """The phase-5 grid's normalised source and target mels."""
    mels = [get_spectrograms(p, cfg.signal)[0] for p in spec["srcs"] + spec["tars"]]
    norm = [inf.normalize(m).astype(np.float32) for m in mels]
    return norm[: len(spec["srcs"])], norm[len(spec["srcs"]):]


def rank_serve(spec: dict, mesh) -> dict:
    """9c on one rank: the grid over the mesh, the kernel's launches counted
    from 0 around it, and its time."""
    cfg = load_config(str(REPO / "examples" / "config.yaml"))
    inf = Inferencer.from_torch_checkpoint(cfg, spec["ckpt"], spec["attr"], device="cuda:0",
                                           gl_method="fused", mesh=mesh)
    src_m, tar_m = grid_mels(cfg, spec, inf)
    gl.griffin_lim_phases.launches = 0
    wavs, mels = inf.convert_grid(src_m, tar_m, trim=False, return_mels=True)
    launches = gl.griffin_lim_phases.launches
    grid_ms = host_ms(lambda: inf.convert_grid(src_m, tar_m))  # every rank makes the same calls
    return {"launches": launches, "wavs": wavs, "mels": mels, "grid_ms": grid_ms}


def rank_nccl(spec: dict, mesh) -> dict:
    """9d under torchrun (NCCL, world size 1): the all-reduce of the
    gradient's flat buffer, and the step with the mesh and without it in
    turns, TF32 on as cli.train runs."""
    from adaptive_voice_conversion_tpu_torch.core.mesh import all_reduce_mean

    cfg = load_config(str(REPO / "examples" / "config.yaml"))
    dev = torch.device("cuda", torch.cuda.current_device())
    n = sum(p.numel() for p in AE(cfg.model).parameters()) + 3
    buf = torch.randn(n, device=dev)
    reduce_ms = cuda_ms(lambda: all_reduce_mean(mesh, buf), reps=20)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    x = step_inputs(cfg, SEED + 90)[0].to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    steps = {}
    for name, m in (("mesh", mesh), ("none", None)):
        model, opt = fresh_model(cfg, dev)
        steps[name] = make_train_step(cfg, model, opt, m)
    times = {"mesh": [], "none": []}
    for name in ("mesh", "none", "none", "mesh"):
        times[name].append(cuda_ms(lambda: steps[name](x, 0.01, generator=gen), reps=10, warmup=3))
    return {"reduce_ms": reduce_ms, "n": n, "backend": torch.distributed.get_backend(),
            "step_ms": times}


def rank_tp(spec: dict, mesh) -> dict:
    """10b on one rank of the (dp2, tp2) mesh: one tensor-parallel step per
    variant on this rank's rows, its gathered gradient and its model-axis
    collectives; then the f32 step's second call timed, and the data-axis
    all-reduce of this rank's gradient buffer."""
    from adaptive_voice_conversion_tpu_torch.core.mesh import all_reduce_mean, make_mesh, row_window
    from adaptive_voice_conversion_tpu_torch.parallel.tp import (
        gather_tp,
        make_tp_train_step,
        shard_params_tp,
    )

    base = load_config(str(REPO / "examples" / "config.yaml"))
    dev = torch.device("cuda:0")
    torch.backends.cudnn.deterministic = True
    tp_mesh = make_mesh(n_data=TP_DATA, n_model=TP_MODEL)
    x, eps = (t[:TP_ROWS] for t in step_inputs(base, SEED + 100))
    lo, hi, _ = row_window(tp_mesh, TP_ROWS // TP_DATA)
    out = {"index": (tp_mesh.data_index, tp_mesh.model_index)}
    for name, dtype, sn in TP_VARIANTS:
        cfg = with_sn(base, sn)
        model = AE(cfg.model)
        init_parameters(model, torch.Generator().manual_seed(SEED))
        model.to(dev, STEP_DTYPES[dtype])
        shard_params_tp(model, tp_mesh)
        opt = make_optimizer(cfg.optimizer, model.parameters(), state_dtype=cfg.opt_state_dtype)
        step = make_tp_train_step(cfg, model, opt, tp_mesh)
        xs, es = (t[lo:hi].to(dev, STEP_DTYPES[dtype]) for t in (x, eps))
        m = step(xs, 0.5, eps=es)
        grads = gather_tp(model, {n: p.grad for n, p in model.named_parameters()})
        row = {"metrics": {k: float(v) for k, v in m.items()},
               "grad": torch.cat([g.reshape(-1) for g in grads.values()]).double().cpu()}
        if name == "f32":
            axis = model.tp_axis
            axis.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(xs, 0.5, eps=es)
            torch.cuda.synchronize()
            row["ms"] = (time.perf_counter() - t0) * 1e3
            row["calls"], row["axis_ms"] = dict(axis.calls), axis.seconds * 1e3
            flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()]).float()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_mean(tp_mesh, flat)
            torch.cuda.synchronize()
            row["data_ms"] = (time.perf_counter() - t0) * 1e3
        out[name] = row
    return out


RANK_CASES = {"step": rank_step, "serve": rank_serve, "nccl": rank_nccl, "tp": rank_tp}


def rank_main(argv) -> None:
    """One rank of phase 9 or 10b: ``<case> <dir>`` under torchrun (NCCL), or
    ``<case> <dir> <rank> <world> <init>`` for a gloo rank on cuda:0."""
    from adaptive_voice_conversion_tpu_torch.core.mesh import init_multihost, make_mesh

    case, work = argv[0], Path(argv[1])
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    if len(argv) > 2:
        init_multihost(device="cuda:0", backend="gloo", init_method=argv[4],
                       world_size=int(argv[3]), rank=int(argv[2]))
    else:
        init_multihost(device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mesh = make_mesh()
        spec = json.loads((work / "spec.json").read_text())
        out = RANK_CASES[case](spec, mesh)
        torch.save(out, work / f"out_{case}_{mesh.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def phase_dist_cli(card: str, d: Path) -> dict:
    """9a: cli.train under torchrun, NCCL at world size 1, against 8d."""
    dev_cfg = d / "config_device.yaml"
    eval_flags = ("-eval_set", "in_test", "-eval_steps", 20)
    out, cli_s = torchrun(["-m", "adaptive_voice_conversion_tpu_torch.cli.train",
                           *train_argv(d, dev_cfg, "dist1", TRAIN_ITERS, *eval_flags), "--multihost"])
    mesh_line = [ln for ln in out.splitlines() if ln.startswith("[mesh]")]
    check(mesh_line == ["[mesh] nccl: 1 ranks, data x model = 1 x 1"],
          f"9a: the CLI's process group: {mesh_line}")
    got = read_series(d / "log_dist1", "init/ae_train")
    want = read_series(d / "log_dev", "init/ae_train")
    check(sorted(got) == sorted(want) == [9, 19, 29, 39], f"9a: summaries at {sorted(got)}, 8d's at {sorted(want)}")
    return {"got": got, "want": want, "cli_s": cli_s,
            "ckpts": sorted(q.name for q in (d / "dist1.ckpts").iterdir()),
            "evals": sorted(read_series(d / "log_dist1", "init/ae_eval_in_test"))}


def phase_dist_step(card: str, cfg, d: Path, work: Path) -> dict:
    """9b: two gloo ranks' step against one process's, then the sharded
    multi-step's ranks against each other."""
    work.mkdir()
    (work / "spec.json").write_text(json.dumps({
        "train_pkl": str(d / "train_128.pkl"), "train_index": str(d / "train_samples_128.json")}))
    torch.cuda.empty_cache()
    ranks = spawn_ranks("step", work)
    dev = torch.device("cuda")
    torch.backends.cudnn.deterministic = True
    try:
        x, eps = step_inputs(cfg, SEED + 90)
        one = {dt: one_step(cfg, dev, x, eps, dt) for dt in STEP_DTYPES}
        # each rank's rows alone, in f32: the order the card sums them in
        b = x.shape[0] // DIST_WORLD
        halves = [one_step(cfg, dev, x[k * b:(k + 1) * b], eps[k * b:(k + 1) * b], "f32")
                  for k in range(DIST_WORLD)]
    finally:
        torch.backends.cudnn.deterministic = False
    split = sum(h["grad"] for h in halves) / DIST_WORLD
    worst = {"loss": 0.0, "grad_norm": 0.0, "f64": 0.0, "f32": 0.0, "f32_vs_whole": 0.0}
    for r, out in enumerate(ranks):
        for dt in STEP_DTYPES:
            got, want = out["steps"][dt]["metrics"], one[dt]["metrics"]
            for k in ("loss", "grad_norm"):
                rel = abs(got[k] - want[k]) / abs(want[k])
                check(rel <= TOL_DIST, f"9b rank {r} ({dt}): {k} {got[k]} vs one process "
                      f"{want[k]}: relative {rel:.3e} > {TOL_DIST}")
                worst[k] = max(worst[k], rel)
        for dt, want, what in (
            ("f64", one["f64"]["grad"], "in f64, against one process's step on the 128 rows"),
            ("f32", split, "in f32, against the mean of one process's steps on each rank's 64 rows"),
        ):
            fro = rel_fro(out["steps"][dt]["grad"], want)
            check(fro <= TOL_DIST, f"9b rank {r}: the all-reduced gradient {what}: relative "
                  f"Frobenius {fro:.3e} > {TOL_DIST}")
            worst[dt] = max(worst[dt], fro)
        worst["f32_vs_whole"] = max(worst["f32_vs_whole"],
                                    rel_fro(out["steps"]["f32"]["grad"], one["f32"]["grad"]))
    worst["split_vs_whole"] = rel_fro(split, one["f32"]["grad"])
    one_ms = {dt: s["ms"] for dt, s in one.items()}
    one = one["f32"]["metrics"]
    rows = [out["rows"] for out in ranks]
    check(bool(np.isfinite(rows[0]).all()), "9b: the sharded multi-step's metrics are not finite")
    check(all(np.array_equal(rows[0], r_) for r_ in rows[1:]),
          "9b: the sharded multi-step's ranks report different metric rows")
    check(ranks[0]["shard"][1] > 0 and ranks[0]["shard"][2] == ranks[1]["shard"][2],
          f"9b: shards {[o['shard'] for o in ranks]}")
    return {"ranks": ranks, "one": one, "one_ms": one_ms, "worst": worst}


def phase_dist_serve(card: str, cfg, work: Path) -> dict:
    """9c: the phase-5 grid served by two gloo ranks against one process."""
    work.mkdir()
    ns, nt = len(GRID_SRC_FRAMES), len(GRID_TAR_FRAMES)
    srcs = [work / f"src{i}.wav" for i in range(ns)]
    tars = [work / f"tar{j}.wav" for j in range(nt)]
    for k, (path, n) in enumerate(zip(srcs + tars, GRID_SRC_FRAMES + GRID_TAR_FRAMES)):
        make_wav(path, SIG.hop_length * (n - 1) / SIG.sr, 110.0 + 17.0 * k, SEED + 20 + k)
    mels = [get_spectrograms(str(p), cfg.signal)[0] for p in srcs + tars]
    _, attr_p, ckpt, _ = write_model_and_attr(work, cfg, mels)
    spec = {"srcs": list(map(str, srcs)), "tars": list(map(str, tars)), "ckpt": str(ckpt),
            "attr": str(attr_p)}
    (work / "spec.json").write_text(json.dumps(spec))
    torch.cuda.empty_cache()
    ranks = spawn_ranks("serve", work)
    for r, out in enumerate(ranks):
        check(out["launches"] == 1, f"9c rank {r} launched the kernel {out['launches']} times, expected 1")
        check(len(out["wavs"]) == len(out["mels"]) == ns * nt, f"9c rank {r} returned {len(out['wavs'])} pairs")
    inf = Inferencer.from_torch_checkpoint(cfg, str(ckpt), str(attr_p), device="cuda", gl_method="fused")
    src_m, tar_m = grid_mels(cfg, spec, inf)
    _, one_mels = inf.convert_grid(src_m, tar_m, trim=False, return_mels=True)
    exact = inf.convert_grid(src_m, tar_m, gl_method="exact", trim=False)
    one_ms = host_ms(lambda: inf.convert_grid(src_m, tar_m))
    mel_err, sc_gap = 0.0, -1.0
    for k in range(ns * nt):
        got = ranks[0]["mels"][k]
        check(got.shape == one_mels[k].shape and all(np.array_equal(got, o["mels"][k]) for o in ranks[1:]),
              f"9c pair {k}: ranks' mels differ or shape {got.shape} != {one_mels[k].shape}")
        # compared as the model returns them (normalised), phase 5's scale
        mel_err = max(mel_err, float(np.abs(inf.normalize(got) - inf.normalize(one_mels[k])).max()))
        mag = mel_to_mag(torch.from_numpy(np.asarray(got, np.float32)), SIG).numpy()
        sc_gap = max(sc_gap, _sc(mag, ranks[0]["wavs"][k]) - _sc(mag, exact[k]))
    check(mel_err <= TOL_GRID_MEL, f"9c: mels over 2 ranks vs one process max|diff| {mel_err} > {TOL_GRID_MEL}")
    check(sc_gap < 0.05, f"9c: a pair's fused SC exceeds the masked exact SC by {sc_gap} >= 0.05")
    return {"ranks": ranks, "mel_err": mel_err, "sc_gap": sc_gap, "one_ms": one_ms}


def phase_distribution(card: str, cfg, d: Path, resume_bound: float) -> dict:
    """Phase 9 on the phase-7 corpus in ``d`` (8d's device-mode run in it)."""
    t0 = time.perf_counter()
    a = phase_dist_cli(card, d)
    gap = largest_rel_diff(a["want"], a["got"], [9, 19, 29, 39])
    check(gap <= resume_bound, f"9a: the torchrun run's loss differs from 8d's by {gap:.3e} > {resume_bound:.3e}")
    check(a["ckpts"] == ["step_20.pt", "step_40.pt"] and a["evals"] == [19, 39],
          f"9a: checkpoints {a['ckpts']}, evals at {a['evals']}")
    log(f"[dist] 9a torchrun --standalone --nproc_per_node 1 -m ...cli.train --multihost, input_mode "
        f"device, {TRAIN_ITERS} steps: process group nccl, world size 1, mesh 1 x 1; summaries at "
        f"[9, 19, 29, 39], loss_rec {a['got'][9]['loss_rec']:.4f} -> {a['got'][39]['loss_rec']:.4f}; "
        f"largest relative difference of loss against 8d's device-mode run {gap:.3e} (bound "
        f"{resume_bound:.3e}, 7c's); checkpoints {a['ckpts']}, evals at {a['evals']}; "
        f"{a['cli_s']:.1f} s wall clock ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        b = phase_dist_step(card, cfg, d, work / "step")
        c = phase_dist_serve(card, cfg, work / "serve")
        (work / "spec.json").write_text("{}")
        _, nccl_s = torchrun([REPO / "chip_smoke.py", "--rank", "nccl", work])
        n = torch.load(work / "out_nccl_0.pt", weights_only=False)
    r0, w = b["ranks"][0], b["worst"]
    n_grad = r0["steps"]["f32"]["grad"].numel()
    log(f"[dist] 9b two gloo ranks sharing the card (cuda:0, TF32 off, cuDNN deterministic), one "
        f"data-parallel step of 64 rows each against one process's step on the 128 rows, in f64 and "
        f"in f32: loss (f32) {r0['steps']['f32']['metrics']['loss']:.6f} vs {b['one']['loss']:.6f}, "
        f"largest relative difference of loss {w['loss']:.2e}, of grad_norm {w['grad_norm']:.2e} "
        f"(tol {TOL_DIST}); the all-reduced gradient ({n_grad} entries), relative Frobenius: in f64 "
        f"against one process's 128 rows {w['f64']:.2e}, in f32 against the mean of one process's "
        f"two 64-row steps {w['f32']:.2e} (tol {TOL_DIST} each)")
    log(f"[dist] 9b in f32 the card sums 64 rows in another order than 128: one process's 128-row "
        f"gradient and the mean of its two 64-row gradients are {w['split_vs_whole']:.2e} apart "
        f"(relative Frobenius), and the ranks' {w['f32_vs_whole']:.2e} from the 128 rows")
    log(f"[dist] 9b device_sharded multi-step, 10 steps, 2 ranks: shards of {r0['shard'][0]} rows and "
        f"{r0['shard'][1]} starts each ({r0['shard'][2]} segments dropped to balance them); the ranks' "
        f"(10, 4) metric rows equal bit for bit; loss_rec {r0['rows'][0, 1]:.4f} -> {r0['rows'][-1, 1]:.4f}")
    log(f"[dist] 9c the 4 x 8 grid served by two gloo ranks on the card, --gl_method fused: "
        f"griffin_lim_phases launches per rank {[o['launches'] for o in c['ranks']]} (16 pairs each, "
        f"16 x 128 = 2048 kernel rows); every rank returned all 32 pairs; mels against the one-process "
        f"grid max|diff| {c['mel_err']:.3e} (tol {TOL_GRID_MEL}); largest per-pair fused SC minus "
        f"masked exact SC {c['sc_gap']:.5f} (must be < 0.05)")
    log(f"[time] dist, two ranks sharing one card (not scaling): the step on 64 rows "
        f"{', '.join(f'{o['steps']['f32']['ms']:.1f}' for o in b['ranks'])} ms per rank in f32 "
        f"and {', '.join(f'{o['steps']['f64']['ms']:.1f}' for o in b['ranks'])} ms in f64, "
        f"against one process on 128 rows {b['one_ms']['f32']:.1f} and {b['one_ms']['f64']:.1f} ms "
        f"(TF32 off, cuDNN deterministic, first step, host clock); "
        f"the gloo all-reduce of the {n_grad}-float gradient staged through the host "
        f"{np.median(r0['reduce_ms']):.1f} ms (median of 5, rank 0); the sharded 10-step call "
        f"{r0['multi_s']:.2f} s; the grid {', '.join(f'{o['grid_ms']:.1f}' for o in c['ranks'])} ms "
        f"per rank against {c['one_ms']:.1f} ms in one process (host clock, median of 3) ({card})")
    log(f"[time] dist, NCCL at world size 1 (torchrun, {nccl_s:.1f} s wall): all_reduce_mean of the "
        f"{n['n']}-float buffer {n['reduce_ms']:.4f} ms (CUDA events, mean of 20); the step at TF32 on "
        f"with the mesh {', '.join(f'{v:.2f}' for v in n['step_ms']['mesh'])} ms and without it "
        f"{', '.join(f'{v:.2f}' for v in n['step_ms']['none'])} ms (CUDA events, mean of 10, in turns "
        f"mesh, none, none, mesh) ({card})")
    log(f"[dist] phase 9 took {time.perf_counter() - t0:.1f} s")
    return {"dist_serve_launches": c["ranks"][0]["launches"]}


# ---------------------------------------------------------------------------
# Phase 10: tensor parallelism, the dry run, the sweep
# ---------------------------------------------------------------------------

# 10b: dp2 x tp2, four gloo ranks on the card, one step on a global batch of
# 16 rows against one process's step on the 16 rows (TF32 off, cuDNN
# deterministic). Tensor parallelism splits the channel contractions, and the
# card sums a split contraction in another order than the whole (9b), so the
# gate is in f64: loss and grad_norm rtol 1e-6, the gathered gradient
# relative Frobenius 1e-6, with and without spectral norm. In f32 the JAX
# package's bounds for its tensor-parallel step (tests/test_distributed.py:
# 146-153): loss rtol 1e-5, grad_norm rtol 1e-4.
TP_DATA, TP_MODEL, TP_ROWS = 2, 2, 16
TP_VARIANTS = (("f64", "f64", False), ("f64_sn", "f64", True), ("f32", "f32", False))
TOL_TP_F64 = 1e-6
TOL_TP_F32 = {"loss": 1e-5, "grad_norm": 1e-4}


def with_sn(cfg, sn: bool):
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, decoder=dataclasses.replace(m.decoder, sn=sn)))


def phase_entry(card: str) -> None:
    """10a: entry() on the card against the same function on the CPU."""
    from adaptive_voice_conversion_tpu_torch.entry import entry

    fn, (model, x, gen) = entry()
    check(x.is_cuda and next(model.parameters()).is_cuda, "10a: entry() is not on the card")
    with torch.no_grad():
        dec = fn(model, x, gen).cpu()
    # the VAE's draw: the card generator's first, at the content code's (B, C, T)
    eps = torch.randn((8, 128, 16), generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda").cpu()
    cpu = AE(model.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        want = cpu(x.cpu(), eps=eps.transpose(1, 2))[3]
    err = float(((dec - want).abs() / (1 + want.abs())).max())
    check(dec.shape == (8, 128, 512) and err <= 1e-4,
          f"10a: entry() on the card vs the CPU: shape {tuple(dec.shape)}, max |diff| / (1 + |cpu|) {err:.3e} > 1e-4")
    log(f"[tp] 10a entry(): dec {tuple(dec.shape)} {dec.dtype} on the card against the same fn on the "
        f"CPU (TF32 off): max |diff| / (1 + |cpu|) {err:.3e} (tol 1e-4)")


def phase_tp_step(card: str, work: Path) -> dict:
    """10b: four gloo ranks' tensor-parallel step against one process's."""
    work.mkdir()
    (work / "spec.json").write_text("{}")
    torch.cuda.empty_cache()
    ranks = spawn_ranks("tp", work, world=TP_DATA * TP_MODEL)
    base = load_config(str(REPO / "examples" / "config.yaml"))
    dev = torch.device("cuda")
    x, eps = (t[:TP_ROWS] for t in step_inputs(base, SEED + 100))
    torch.backends.cudnn.deterministic = True
    try:
        one = {name: one_step(with_sn(base, sn), dev, x, eps, dtype) for name, dtype, sn in TP_VARIANTS}
        # the f32 step's second call, timed as the ranks time theirs
        model, opt = fresh_model(base, dev)
        step = make_train_step(base, model, opt)
        xs, es = x.to(dev), eps.to(dev)
        step(xs, 0.5, eps=es)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(xs, 0.5, eps=es)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cudnn.deterministic = False
    worst = {}
    for name, dtype, sn in TP_VARIANTS:
        w = worst[name] = {"loss": 0.0, "grad_norm": 0.0, "grad": 0.0}
        for r, out in enumerate(ranks):
            got, want = out[name]["metrics"], one[name]["metrics"]
            for k in ("loss", "grad_norm"):
                rel = abs(got[k] - want[k]) / abs(want[k])
                tol = TOL_TP_F64 if dtype == "f64" else TOL_TP_F32[k]
                check(rel <= tol, f"10b rank {r} ({name}): {k} {got[k]} vs one process {want[k]}: "
                      f"relative {rel:.3e} > {tol}")
                w[k] = max(w[k], rel)
            fro = rel_fro(out[name]["grad"], one[name]["grad"])
            if dtype == "f64":
                check(fro <= TOL_TP_F64, f"10b rank {r} ({name}): the gathered gradient against one "
                      f"process's, relative Frobenius {fro:.3e} > {TOL_TP_F64}")
            w["grad"] = max(w["grad"], fro)
    for a in range(0, TP_DATA * TP_MODEL, TP_MODEL):  # the model groups
        for b in range(a + 1, a + TP_MODEL):
            for name, _, _ in TP_VARIANTS:
                check(ranks[a][name]["metrics"] == ranks[b][name]["metrics"],
                      f"10b: ranks {a} and {b} of one model group report different metrics ({name})")
    return {"ranks": ranks, "worst": worst, "one_ms": one_ms, "one": one}


def phase_tensor_parallel(card: str) -> None:
    """Phase 10: entry(), the dp2 x tp2 step, the two dry runs, the sweep."""
    from adaptive_voice_conversion_tpu_torch.entry import dryrun_multichip
    from adaptive_voice_conversion_tpu_torch.parallel.scaling import scaling_sweep

    t0 = time.perf_counter()
    phase_entry(card)
    with tempfile.TemporaryDirectory() as tmp:
        b = phase_tp_step(card, Path(tmp) / "tp")
    w = b["worst"]
    log(f"[tp] 10b dp2 x tp2: four gloo ranks sharing the card (cuda:0, TF32 off, cuDNN deterministic), "
        f"one step on their 8 rows each of a global batch of {TP_ROWS} x 128 x 512 against one "
        f"process's step on the {TP_ROWS} rows; largest relative difference of loss / grad_norm / "
        f"relative Frobenius of the gathered gradient: f64 {w['f64']['loss']:.2e} / "
        f"{w['f64']['grad_norm']:.2e} / {w['f64']['grad']:.2e}, f64 with sn {w['f64_sn']['loss']:.2e} / "
        f"{w['f64_sn']['grad_norm']:.2e} / {w['f64_sn']['grad']:.2e} (tol {TOL_TP_F64} each); f32 "
        f"{w['f32']['loss']:.2e} / {w['f32']['grad_norm']:.2e} / {w['f32']['grad']:.2e} (tol loss "
        f"{TOL_TP_F32['loss']}, grad_norm {TOL_TP_F32['grad_norm']}; the gradient not gated in f32); "
        f"the ranks of each model group report equal metrics")
    t_c = time.perf_counter()
    nccl = dryrun_multichip(1)
    gloo = dryrun_multichip(4, backend="gloo")
    for what, out in (("dryrun_multichip(1)", nccl), ("dryrun_multichip(4, backend='gloo')", gloo)):
        losses = [out["tiny"]["loss"], out["full"]["loss"], float(out["multi"][-1][0])]
        check(all(np.isfinite(losses)), f"10c {what}: losses {losses}")
    check(nccl["mesh"] == (1, 1) and gloo["mesh"] == (2, 2), f"10c meshes {nccl['mesh']}, {gloo['mesh']}")
    log(f"[tp] 10c dryrun_multichip(1) under NCCL at world size 1 and dryrun_multichip(4, "
        f"backend='gloo') on four ranks sharing the card: finite losses; "
        f"{time.perf_counter() - t_c:.1f} s wall clock for both")
    rows = scaling_sweep(load_config(str(REPO / "examples" / "config.yaml")), [1, 2])
    check(len(rows) == 1 and rows[0]["devices"] == 1 and rows[0]["global_batch"] == 128,
          f"10d: sweep rows {rows}")
    log(f"[tp] 10d scaling_sweep sizes [1, 2] on the card: {json.dumps(rows[0])}; the sweep stopped "
        f"at 2 ranks: this host has {torch.cuda.device_count()} GPU and the sweep puts one rank on each "
        f"({card})")
    f32 = [r["f32"] for r in b["ranks"]]
    calls = f32[0]["calls"]
    share = [(o["axis_ms"] + o["data_ms"]) / o["ms"] for o in f32]
    log(f"[time] tp, four ranks sharing one card, not scaling: the dp2 x tp2 step (f32, TF32 off, cuDNN "
        f"deterministic, second call, host clock) {', '.join(f'{o['ms']:.1f}' for o in f32)} ms per rank "
        f"on 8 rows each, against one process on the {TP_ROWS} rows {b['one_ms']:.1f} ms; model-axis "
        f"collectives per step per rank: forward {calls['forward']}, backward {calls['backward']}, "
        f"update {calls['update']}; their time {', '.join(f'{o['axis_ms']:.1f}' for o in f32)} ms and "
        f"the data-axis all-reduce's {', '.join(f'{o['data_ms']:.1f}' for o in f32)} ms per rank: the "
        f"gloo collectives, staged through the host, take {min(share):.1%}-{max(share):.1%} of the step "
        f"({card})")
    log(f"[tp] phase 10 took {time.perf_counter() - t0:.1f} s")


# Phase 11's corpus: VCTK's layout and rate (48 kHz, resampled to 24 kHz on
# load), 16 speakers x 12 utterances of 2.0-6.0 s, none a whole number of
# seconds, so every wave ends inside a featurizer bucket
PREP_SPEAKERS, PREP_UTTS, PREP_SR = 16, 12, 48000
# the published 10,000,000 training draws cut to 200,000: the draw is a
# host-side Python loop and its JSON grows with it
PREP_TRAIN_SAMPLES = 200_000
PREP_ITERS = 20
# the card's batched featurizer against the --host numpy run: tests/
# test_kernels.py's bound for the JAX package's two paths, on every frame
# (mels on the [0, 1] scale); attr.pkl relative
TOL_PREP_MEL = 5e-4
TOL_PREP_ATTR = 1e-5


def write_vctk_corpus(root: Path) -> float:
    """wav48/p<spk>/p<spk>_<utt>.wav and speaker-info.txt; returns the
    seconds of audio."""
    rng = np.random.default_rng(SEED + 110)
    lines = ["ID  AGE  GENDER  ACCENTS  REGION"]
    jobs = []
    for s in range(PREP_SPEAKERS):
        spk = 225 + s
        lines.append(f"{spk}  23  {'FM'[s % 2]}  English  Somewhere")
        (root / "wav48" / f"p{spk}").mkdir(parents=True)
        for u in range(1, PREP_UTTS + 1):
            sec = round(float(rng.uniform(2.0, 6.0)), 3)
            sec += 0.001 if sec == int(sec) else 0.0
            path = root / "wav48" / f"p{spk}" / f"p{spk}_{u:03d}.wav"
            jobs.append((path, sec, 85.0 + 9.0 * s + 3.0 * u, SEED + 1000 * s + u))
    (root / "speaker-info.txt").write_text("\n".join(lines) + "\n")
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda j: make_wav(*j, sr=PREP_SR), jobs))
    return sum(j[1] for j in jobs)


def load_split(d: Path, name: str):
    with open(d / name, "rb") as f:
        return pickle.load(f)


def compare_datasets(card_dir: Path, host_dir: Path) -> dict:
    """The card run's files against the --host run's: every mel (each run's
    pickle denormalized with its own attr) within TOL_PREP_MEL on every
    frame, attr within TOL_PREP_ATTR relative, the indexes and file lists
    equal. Returns the largest mel difference and where it is."""
    names = sorted(q.name for q in host_dir.iterdir())
    check(names == sorted(q.name for q in card_dir.iterdir()), f"11 file sets differ: {names}")
    attr_c, attr_h = load_split(card_dir, "attr.pkl"), load_split(host_dir, "attr.pkl")
    attr_err = max(float(np.abs(attr_c[k] / attr_h[k] - 1).max()) for k in ("mean", "std"))
    check(attr_err <= TOL_PREP_ATTR, f"11 attr.pkl relative difference {attr_err:.3e} > {TOL_PREP_ATTR}")
    worst = {"err": -1.0}
    frames = 0
    for name in names:
        if name == "attr.pkl":
            continue
        if not name.endswith(".pkl"):
            same = (card_dir / name).read_bytes() == (host_dir / name).read_bytes()
            check(same, f"11 {name} differs between the card and the host run")
            continue
        card, host = load_split(card_dir, name), load_split(host_dir, name)
        check(list(card) == list(host), f"11 {name}: utterances differ or are in another order")
        for k, h in host.items():
            check(card[k].shape == h.shape and card[k].dtype == np.float32, f"11 {name}:{k} shape/dtype")
            diff = np.abs((card[k] * attr_c["std"] + attr_c["mean"]) - (h * attr_h["std"] + attr_h["mean"]))
            frame = int(np.argmax(diff.max(axis=1)))
            frames += len(h) if name in ("train.pkl", "in_test.pkl", "out_test.pkl") else 0
            if diff[frame].max() > worst["err"]:
                worst = {"err": float(diff[frame].max()), "split": name, "utt": k, "frame": frame, "of": len(h)}
    check(worst["err"] <= TOL_PREP_MEL, f"11 mel difference {worst} > {TOL_PREP_MEL}")
    return dict(worst, attr_err=attr_err, frames=frames, files=len(names))


def time_featurizer(card: str, paths: list, seconds: float) -> dict:
    """In process: the host load (read, resample 48 -> 24 kHz, trim,
    pre-emphasis) of every wav, the card's bucket batches (CUDA events
    around the featurizer on the uploaded batch, host clock around the
    whole call with its copies), and the host numpy featurizer on the same
    waves."""
    from adaptive_voice_conversion_tpu_torch.dsp.features import mel_from_wave, mel_from_wave_batched
    from adaptive_voice_conversion_tpu_torch.tools.etl import (
        bucket_batches,
        featurize_batch,
        load_wave,
        pad_batch,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    waves = [(os.path.basename(p), load_wave(p, SIG)) for p in paths]
    load_s = time.perf_counter() - t0
    batches = bucket_batches(waves, SIG, 16)
    pad_len, chunk = batches[0]
    featurize_batch(chunk, pad_len, SIG, dev)  # warm-up: cuFFT plans, the mel basis
    rows = []
    for pad_len, chunk in batches:
        x = torch.from_numpy(pad_batch(chunk, pad_len, SIG)).to(dev)
        ms = cuda_ms(lambda: mel_from_wave_batched(x, SIG, centered=False), reps=3, warmup=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        featurize_batch(chunk, pad_len, SIG, dev)
        rows.append((pad_len // SIG.sr, len(chunk), ms, (time.perf_counter() - t1) * 1e3))
    card_s = sum(r[3] for r in rows) / 1e3
    t0 = time.perf_counter()
    for _, y in waves:
        mel_from_wave(y, SIG)
    host_s = time.perf_counter() - t0
    n = len(waves)
    dev_ms = sum(r[2] for r in rows)
    for bucket in sorted({r[0] for r in rows}):
        sel = [r for r in rows if r[0] == bucket]
        log(f"[time] prep featurize bucket {bucket} s: {len(sel)} batches of "
            f"{'/'.join(str(r[1]) for r in sel)} waves, device {', '.join(f'{r[2]:.3f}' for r in sel)} ms "
            f"(CUDA events, mean of 3), the whole call with copies {', '.join(f'{r[3]:.2f}' for r in sel)} "
            f"ms (host clock) ({card})")
    log(f"[time] prep featurize {n} utterances, {seconds:.1f} s of audio: card device time "
        f"{dev_ms:.2f} ms ({dev_ms / n:.4f} ms per utterance, CUDA events); card path = host load "
        f"{load_s:.2f} s + {len(rows)} batch calls {card_s:.3f} s = {n / (load_s + card_s):.1f} "
        f"utterances/s, {seconds / (load_s + card_s):.0f} audio-s/s; host numpy path = the same load + "
        f"featurize {host_s:.2f} s = {n / (load_s + host_s):.1f} utterances/s, "
        f"{seconds / (load_s + host_s):.0f} audio-s/s; the host's loading (read, resample_poly 48 -> "
        f"24 kHz, trim, pre-emphasis) is {load_s / (load_s + card_s):.1%} of the card path; featurizing "
        f"alone: card {n / card_s:.0f} utterances/s against host {n / host_s:.1f} ({card})")
    return {"load_s": load_s, "card_s": card_s, "host_s": host_s, "device_ms": dev_ms}


def phase_preprocess(card: str) -> dict:
    """Phase 11: wavs -> dataset on the card -> 20 training steps -> a
    one-shot conversion of an unseen speaker, all through the CLIs."""
    from adaptive_voice_conversion_tpu_torch.dsp.vocoder import griffin_lim_np, mel_to_mag_np
    from adaptive_voice_conversion_tpu_torch.utils.roofline import mfu_and_roofline

    t_start = time.perf_counter()
    cfg_path = REPO / "examples" / "config.yaml"
    cfg = load_config(str(cfg_path))
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        seconds = write_vctk_corpus(d / "corpus")
        log(f"[prep] corpus: {PREP_SPEAKERS} speakers x {PREP_UTTS} utterances at {PREP_SR} Hz, "
            f"{seconds:.1f} s of audio, written in {time.perf_counter() - t0:.1f} s")

        # 11a: the dataset, on the card and on the host
        prep = ["-m", "adaptive_voice_conversion_tpu_torch.tools.preprocess_pipeline", "vctk",
                "--raw_data_dir", d / "corpus", "--n_out_speakers", 2, "--test_prop", 0.1,
                "--n_utts_attr", 64, "--segment_size", 128, "--seed", SEED,
                "--training_samples", PREP_TRAIN_SAMPLES]
        wall = {}
        for name, extra in (("card", []), ("host", ["--host"])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, *map(str, prep), "--data_dir", str(d / name), *extra],
                                  cwd=REPO, capture_output=True, text=True, timeout=600)
            wall[name] = time.perf_counter() - t0
            check(proc.returncode == 0, f"11 preprocess_pipeline ({name}) failed:\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-3000:]}")
        cmp = compare_datasets(d / "card", d / "host")
        train = load_split(d / "card", "train.pkl")
        with open(d / "card" / "train_samples_128.json") as f:
            n_index = len(json.load(f))
        check(n_index == PREP_TRAIN_SAMPLES, f"11 index has {n_index} entries")
        log(f"[prep] 11a preprocess_pipeline vctk on the card: {len(train)} train utterances, "
            f"{cmp['frames']} frames in train/in_test/out_test ({cmp['frames'] * 512 * 4 / 1e6:.1f} MB of "
            f"f32 mels), {cmp['files']} files; against the --host run: largest mel difference "
            f"{cmp['err']:.3e} (tol {TOL_PREP_MEL}) at {cmp['split']}:{cmp['utt']} frame {cmp['frame']} of "
            f"{cmp['of']}, attr.pkl {cmp['attr_err']:.2e} relative (tol {TOL_PREP_ATTR}), the indexes "
            f"({n_index} training draws) and file lists equal; wall clock {wall['card']:.1f} s on the card, "
            f"{wall['host']:.1f} s with --host, each a whole process ({card})")
        paths = sorted(str(q) for q in (d / "corpus" / "wav48").glob("*/*.wav"))
        feat = time_featurizer(card, paths, seconds)

        # 11b: train on the produced dataset
        cli_s = run_train_cli(d / "card", train_argv(d / "card", cfg_path, "model", PREP_ITERS))
        series = read_series(d / "card" / "log_model", "init/ae_train")
        check(sorted(series) == [9, 19], f"11b summaries at {sorted(series)}, expected [9, 19]")
        check(all(np.isfinite(v) for row in series.values() for v in row.values()),
              f"11b losses not finite: {series}")
        # audio_sec_per_sec is cumulative from the run's start: the second
        # call's own rate is what the two rows leave between them
        rate = series[19]["audio_sec_per_sec"]
        elapsed = {s_: (s_ + 1) * AUDIO_S_PER_STEP / series[s_]["audio_sec_per_sec"] for s_ in (9, 19)}
        step_s = (elapsed[19] - elapsed[9]) / 10
        roof = mfu_and_roofline(cfg, step_s, torch.cuda.get_device_name(0))
        check("mfu" in roof, f"11b no peak rates for {torch.cuda.get_device_name(0)}")
        log(f"[prep] 11b cli.train -iters {PREP_ITERS} on the produced train_128.pkl / "
            f"train_samples_128.json at batch 128 x 128 x 512 (input_mode auto -> device, cuDNN "
            f"convolutions in TF32 as the CLI runs them): loss {series[9]['loss']:.4f} at step 9 -> "
            f"{series[19]['loss']:.4f} at 19, loss_rec {series[9]['loss_rec']:.4f} -> "
            f"{series[19]['loss_rec']:.4f}, all finite; {cli_s:.1f} s wall clock for the process ({card})")
        log(f"[time] prep train: audio_sec_per_sec {rate:.1f} at step 19 (metrics.jsonl, steps 0-19 "
            f"with the first call's warm-up), {AUDIO_S_PER_STEP / step_s:.1f} over the second call's steps "
            f"10-19 (from the two rows) = {step_s * 1e3:.2f} ms a step; mfu_and_roofline of that step: {roof['flops_total'] / 1e9:.1f} GFLOP and "
            f"{roof['hbm_bytes_est'] / 1e9:.3f} GB a step, {roof['achieved_tflops']:.2f} TFLOP/s, MFU "
            f"{roof['mfu']:.4f} against {roof['device']}'s dense bf16 peak, HBM utilization "
            f"{roof['hbm_utilization']:.4f}, {roof['roofline_bound']}-bound, speed of light "
            f"{roof['speed_of_light_ms']:.3f} ms a step ({card})")

        # 11c: serve an unseen speaker from the training checkpoint
        out_test = (d / "card" / "out_test_files.txt").read_text().split()
        spks = sorted({Path(q).parent.name for q in out_test})
        check(len(spks) == 2, f"11c out_test speakers {spks}")
        src = next(q for q in out_test if Path(q).parent.name == spks[0])
        tar = next(q for q in out_test if Path(q).parent.name == spks[1])
        check(not any(k.split("_")[0] in spks for k in train), f"11c speakers {spks} seen in training")
        argv = ["-a", d / "card" / "attr.pkl", "-c", cfg_path, "-m", d / "card" / "model", "-s", src,
                "-t", tar, "-o", d / "fused.wav", "--gl_method", "fused"]
        launches, serve_s = run_cli("inference", argv)
        check(launches == 1, f"11c the one-shot CLI launched griffin_lim_phases {launches} times, expected 1")
        src_mel = get_spectrograms(src, SIG)[0]
        n_max = SIG.hop_length * (-(-len(src_mel) // 8) * 8 - 1)
        sr, wav = wavfile.read(d / "fused.wav")
        check(sr == SIG.sr and wav.ndim == 1 and 0 < len(wav) <= n_max and bool(np.isfinite(wav).all()),
              f"11c served wav sr {sr}, shape {wav.shape} (at most {n_max}), finite {np.isfinite(wav).all()}")
        cpu_argv = argv[:-3] + [d / "oracle.wav", "--gl_method", "fused", "--cpu_vocoder"]
        cpu_launches, cpu_s = run_cli("inference", cpu_argv)
        check(cpu_launches == 0, f"11c --cpu_vocoder launched the kernel {cpu_launches} times")
        _, wav_np = wavfile.read(d / "oracle.wav")
        check(wav_np.ndim == 1 and 0 < len(wav_np) <= n_max and bool(np.isfinite(wav_np).all()),
              f"11c --cpu_vocoder wav shape {wav_np.shape}")
        # the two vocoders on the converted magnitude, before trim
        inf = Inferencer.from_train_checkpoint(cfg, str(d / "card" / "model"), str(d / "card" / "attr.pkl"))
        tar_mel = get_spectrograms(tar, SIG)[0]
        dec = inf.denormalize(inf.convert_mel(inf.normalize(src_mel), inf.normalize(tar_mel)))
        mag = mel_to_mag_np(dec, SIG)
        with torch.no_grad():
            w_fused = griffin_lim(torch.from_numpy(mag.astype(np.float32)).cuda(), SIG, method="fused")
        sc_f, sc_np = _sc(mag, w_fused.cpu().numpy()), _sc(mag, griffin_lim_np(mag, SIG))
        check(sc_f < sc_np + 0.05, f"11c fused SC {sc_f} not < numpy oracle SC {sc_np} + 0.05")
        log(f"[prep] 11c cli.inference -m <store_model_path> --gl_method fused, source {Path(src).name} "
            f"and target {Path(tar).name}, two held-out speakers (the target unseen in training): "
            f"griffin_lim_phases launches {launches}, {len(wav)} samples (at most {n_max}), finite, "
            f"{serve_s:.1f} s wall clock; --cpu_vocoder: launches {cpu_launches}, {len(wav_np)} samples, "
            f"{cpu_s:.1f} s wall clock; vocoder SC on the converted magnitude: fused (card) {sc_f:.5f}, "
            f"numpy oracle ({SIG.n_iter} exact iterations, host) {sc_np:.5f}, gap {sc_f - sc_np:+.5f} "
            f"({card})")
    log(f"[prep] phase 11 took {time.perf_counter() - t_start:.1f} s")
    return {"serve_launches": launches, **feat}


# ---------------------------------------------------------------------------
# Phase 12: the recorded experiments and the probes
# ---------------------------------------------------------------------------

OPT_MODES = (False, True, "bucketed", "bucketed8")
# 12a, each opt_fused mode against the per-leaf chain from the same weights
# over the same device-mode steps (f32, TF32 off, cuDNN deterministic). The
# modes differ only in the global norm's reduction order, so with the clip
# active the clip's scale differs by an f32 rounding:
# - the first step: the same gradients in every mode, so the losses equal
#   and grad_norm within 1e-5; the update moves by lr x that rounding, so
#   every parameter within 1e-6 of the per-leaf one (~8 f32 units at the
#   parameters' size: the rounding of p + u);
# - ten steps: once the norm's rounding differs, the gradients differ by
#   roundings and Adam turns the rounding of a near-zero gradient into lr x
#   its sign (7a), so the trajectories part: on an H100 (80GB HBM3, 700 W)
#   the flat and 4-bucket runs came out 6.3e-3 apart in loss_kl and 6.1e-3
#   in the parameters (relative to their movement) after 10 steps, where
#   the per-leaf chain with its clip threshold moved by 2^-22 (one rounding
#   of the clip's scale at every step) came out 0.35 and 0.19 apart. Held
#   to that twin: no further from the per-leaf chain than it is.
TOL_OPT_FIRST = 1e-5
TOL_OPT_FIRST_PARAM = 1e-6
OPT_TWIN_CLIP = 1 + 2.0 ** -22
# 12c, at the full width, f32 with TF32 off: the concat-free and the dual
# bank against conv_bank then conv1d: 1e-5 of the largest output (the JAX
# test's 1e-5 at its small sizes; a 1536-term f32 sum in another order);
# bank_out against the encoders' own bank the same bound
TOL_BANK_REL = 1e-5
PROBE_ARGS = {"bank": [], "residual": [], "bank_split": [], "parts": [], "opt": ["--calls", "3"]}
OPT_ITERS = 20


# One probe's process: the imports and the CUDA context first, then it
# waits for its turn (a file the script creates) and runs the probe's CLI as
# ``python -m`` would. The start-up of every probe overlaps, and while one
# probe is timed the others sleep.
PROBE_RUNNER = (
    "import pathlib, runpy, sys, time\n"
    "import torch\n"
    "import adaptive_voice_conversion_tpu_torch.tools.perf_probes\n"
    "torch.cuda.init()\n"
    "gate, argv = pathlib.Path(sys.argv[1]), sys.argv[2:]\n"
    "(gate / ('ready_' + argv[0])).touch()\n"
    "while not (gate / ('turn_' + argv[0])).exists():\n"
    "    time.sleep(0.05)\n"
    "sys.argv = ['perf_probes', *argv]\n"
    "runpy.run_module('adaptive_voice_conversion_tpu_torch.tools.perf_probes', run_name='__main__')\n"
)


def run_probes(gate: Path, probes: dict) -> dict:
    """{name: stdout} of every probe through its CLI, each in a process of
    its own (PROBE_RUNNER), run one after another in ``probes``' order."""
    gate.mkdir()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", PROBE_RUNNER, str(gate), name, *map(str, extra)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for name, extra in probes.items()}
    out = {}
    try:
        t0 = time.perf_counter()
        while not all((gate / f"ready_{n}").exists() or p.poll() is not None for n, p in procs.items()):
            check(time.perf_counter() - t0 < 600, "the probes' processes did not start within 600 s")
            time.sleep(0.1)
        log(f"[probe] the {len(procs)} processes started in {time.perf_counter() - t0:.1f} s, side by side")
        for name, proc in procs.items():
            t0 = time.perf_counter()
            (gate / f"turn_{name}").touch()
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"perf_probes {name} failed:\n{stdout[-3000:]}\n{stderr[-3000:]}")
            for line in stdout.splitlines():
                log(f"[probe] {name} | {line}")
            log(f"[probe] {name} | took {time.perf_counter() - t0:.1f} s from its turn")
            out[name] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return out


def flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).double() for p in model.parameters()])


def opt_run(c, res, K: int) -> dict:
    """One mode's first step, then K - 1 more (device mode, f32, TF32 off,
    cuDNN deterministic): the metric rows, the parameters after the first
    and the last step, and the multi-step to time."""
    from adaptive_voice_conversion_tpu_torch.train.optim import make_train_optimizer

    model = AE(c.model)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.to(torch.device("cuda"))
    p0 = flat_params(model)
    opt = make_train_optimizer(c, model.parameters())
    first = make_device_data_train_step(c, model, opt, inner_steps=1)
    rest = make_device_data_train_step(c, model, opt, inner_steps=K - 1)
    torch.backends.cudnn.deterministic = True
    try:
        ms1 = first(res.packed, res.starts, SEED, 0)
        p1 = flat_params(model)
        ms = torch.cat([ms1, rest(res.packed, res.starts, SEED, 1)]).cpu().numpy()
    finally:
        torch.backends.cudnn.deterministic = False
    check(bool(np.isfinite(ms).all()), f"12a opt_fused={c.opt_fused!r} {c.opt_state_dtype}: not finite")
    p = flat_params(model)
    return {"ms": ms, "p1": p1, "p": p, "moved": float((p - p0).norm()), "opt": opt,
            "multi": make_device_data_train_step(c, model, opt, inner_steps=K),
            "multi2": make_device_data_train_step(c, model, opt, inner_steps=2)}


def opt_apart(r: dict, base: dict) -> dict:
    rel = np.abs(r["ms"] - base["ms"]) / np.abs(base["ms"])
    return {"first": float(rel[0].max()), "first_p": float((r["p1"] - base["p1"]).abs().max()),
            "loss": float(rel[:, :3].max()), "grad_norm": float(rel[:, 3].max()),
            "p": float((r["p"] - base["p"]).norm()) / base["moved"]}


def launches_and_busy(fn) -> tuple:
    """(kernel launches, device busy us) of one run of fn(), from a
    torch.profiler trace of the card's activity alone (no host ops, so the
    trace stays small)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return sum(int(e.count) for e in evts), sum(float(e.self_device_time_total) for e in evts)


def phase_opt_parity(card: str, cfg, res) -> dict:
    """12a: every opt_fused mode in device mode against the per-leaf chain,
    in f32 and with opt_state_dtype bfloat16. Returns {state dtype: {mode:
    run}} for the times."""
    K = 10
    out = {}
    for sd in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, opt_state_dtype=sd)
        runs = out[sd] = {False: opt_run(c, res, K)}
        base = runs[False]
        twin_cfg = dataclasses.replace(c, optimizer=dataclasses.replace(
            c.optimizer, grad_norm=c.optimizer.grad_norm * OPT_TWIN_CLIP))
        twin = opt_apart(opt_run(twin_cfg, res, K), base)
        log(f"[exp] 12a the per-leaf chain with its clip threshold x (1 + 2^-22), opt_state_dtype={sd}, "
            f"against the per-leaf chain over {K} device-mode steps (f32, TF32 off, cuDNN deterministic): "
            f"first step: metrics {twin['first']:.3e}, parameters {twin['first_p']:.3e}; over the {K} "
            f"steps: losses {twin['loss']:.3e}, grad_norm {twin['grad_norm']:.3e}, parameters "
            f"{twin['p']:.3e} of the per-leaf run's movement {base['moved']:.4f} ({card})")
        for mode in OPT_MODES[1:]:
            r = runs[mode] = opt_run(dataclasses.replace(c, opt_fused=mode), res, K)
            a = opt_apart(r, base)
            bounds = {k: max(twin[k], TOL_OPT_FIRST) for k in ("loss", "grad_norm", "p")}
            check(a["first"] <= TOL_OPT_FIRST and a["first_p"] <= TOL_OPT_FIRST_PARAM,
                  f"12a opt_fused={mode!r} {sd}: first step's metrics {a['first']:.3e} (tol "
                  f"{TOL_OPT_FIRST}), parameters {a['first_p']:.3e} (tol {TOL_OPT_FIRST_PARAM})")
            check(all(a[k] <= bounds[k] for k in bounds),
                  f"12a opt_fused={mode!r} {sd} over {K} steps: {a} against {bounds}")
            log(f"[exp] 12a opt_fused={mode!r} ({len(r['opt'].fill)} buckets), opt_state_dtype={sd}, "
                f"against the per-leaf chain: first step's metrics {a['first']:.3e} (tol "
                f"{TOL_OPT_FIRST}), parameters after it max|diff| {a['first_p']:.3e} (tol "
                f"{TOL_OPT_FIRST_PARAM}); over {K} steps losses {a['loss']:.3e}, grad_norm "
                f"{a['grad_norm']:.3e}, parameters {a['p']:.3e} of their movement (bounds: the twin's, "
                f"at least {TOL_OPT_FIRST}); loss_rec {r['ms'][0, 1]:.4f} -> {r['ms'][-1, 1]:.4f} ({card})")
    return out


def phase_opt_times(card: str, runs: dict, res) -> None:
    """12a's times: each mode's multi-step at TF32 on (as cli.train runs),
    the modes in turns so that the host's load falls on each alike."""
    K = 10
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for sd, by_mode in runs.items():
            calls = {m: (lambda r=r: r["multi"](res.packed, res.starts, SEED, K)) for m, r in by_mode.items()}
            for call in calls.values():
                call()
            step_ms = {m: [] for m in calls}
            for _ in range(3):
                for m, call in calls.items():
                    step_ms[m].append(stream_ms(call) / K)
            for m, r in by_mode.items():
                # one trace of a 2-step call each: a trace of 10-step calls
                # takes seconds to read, and one trace of every mode's
                # calls lost events
                launches, busy_us = (v / 2 * K for v in launches_and_busy(
                    lambda: r["multi2"](res.packed, res.starts, SEED, K)))
                log(f"[time] exp opt_fused={m!r} opt_state_dtype={sd} (multi-step, {K} steps a call, "
                    f"f32, TF32 on, the modes in turns): {', '.join(f'{v:.3f}' for v in step_ms[m])} ms "
                    f"per step (host clock to the end of each call; median {np.median(step_ms[m]):.3f}, "
                    f"{np.median(step_ms[m]) / np.median(step_ms[False]):.3f}x the per-leaf chain's), "
                    f"{launches / K:.0f} launches a step, device busy {busy_us / 1e3 / K:.3f} ms a step "
                    f"(torch.profiler's device activity over a 2-step call) ({card})")
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_opt_cli(card: str, d: Path) -> int:
    """12b: cli.train with opt_fused bucketed4 (host stream), a twin, a run
    resumed from step 10, and the one-shot CLI from the checkpoint."""
    cfg_path = config_copy(d, "config_bucketed4.yaml", input_mode="host", opt_fused="bucketed4")
    (_, first_s), (_, twin_s) = run_clis([
        ("bucketed4", train_argv(d, cfg_path, "b4", OPT_ITERS, "-save_steps", 10)),
        ("bucketed4 twin", train_argv(d, cfg_path, "b4_twin", 10)),
    ])
    first = read_series(d / "log_b4", "init/ae_train")
    twin = read_series(d / "log_b4_twin", "init/ae_train")
    check(sorted(first) == [0, 5, 10, 15] and sorted(twin) == [0, 5],
          f"12b summaries at {sorted(first)} and {sorted(twin)}")
    state = torch.load(d / "b4.ckpts" / "step_10.pt", map_location="cpu", weights_only=True)["optimizer"]
    check(state.get("opt_fused") == "bucketed4" and sorted(state["state"]) == [f"bucket{k}" for k in range(4)],
          f"12b the checkpoint's optimiser state is not bucketed4's: {sorted(state)} {sorted(state['state'])}")
    noise = largest_rel_diff(first, twin, [0, 5])
    (d / "b4_10.ckpts").mkdir()
    shutil.copy(d / "b4.ckpts" / "step_10.pt", d / "b4_10.ckpts" / "step_10.pt")
    src, tar, out = d / "source.wav", d / "target.wav", d / "converted_b4.wav"
    make_wav(src, 4.0, 130.0, SEED)
    make_wav(tar, 4.0, 215.0, SEED + 1)
    serve_argv = ["-a", d / "attr.pkl", "-c", cfg_path, "-m", d / "b4", "-s", src, "-t", tar,
                  "-o", out, "--gl_method", "fused"]
    with ThreadPoolExecutor(max_workers=1) as pool:
        serving = pool.submit(run_cli, "inference", serve_argv)
        ((_, res_s),) = run_clis([("bucketed4 resumed", train_argv(
            d, cfg_path, "b4_res", 10, "--load_model", "-load_model_path", d / "b4_10"))])
        launches, serve_s = serving.result()
    resumed = read_series(d / "log_b4_res", "init/ae_train")
    check(sorted(resumed) == [10, 15], f"12b resumed run's summaries at {sorted(resumed)}")
    gap = largest_rel_diff(first, resumed, [10, 15])
    bound = max(10 * noise, RESUME_FLOOR)
    check(gap <= bound, f"12b resumed run's loss differs from the first run's by {gap:.3e} > {bound:.3e}")
    check(launches == 1, f"12b serving the bucketed4 checkpoint launched the kernel {launches} times")
    sr, wav = wavfile.read(out)
    check(sr == SIG.sr and wav.ndim == 1 and len(wav) > 0 and bool(np.isfinite(wav).all()),
          f"12b served wav sr {sr}, shape {wav.shape} or not finite")
    log(f"[exp] 12b cli.train opt_fused: bucketed4 (input_mode host), {OPT_ITERS} steps: loss_rec "
        f"{first[0]['loss_rec']:.4f} -> {first[15]['loss_rec']:.4f}, the checkpoint's state 4 flat "
        f"buckets; resumed from step 10 against the first run at steps 10 and 15: largest relative "
        f"difference of loss {gap:.3e}; a twin run from scratch differs by {noise:.3e} at steps 0 and 5; "
        f"bound max(10 x that, {RESUME_FLOOR}) = {bound:.3e}; {first_s:.1f}, {twin_s:.1f} and "
        f"{res_s:.1f} s wall clock (the first two side by side) ({card})")
    log(f"[exp] 12b train (opt_fused bucketed4) -> serve: cli.inference --gl_method fused on the "
        f"step-{OPT_ITERS} checkpoint: {len(wav)} samples, griffin_lim_phases launches {launches}, "
        f"{serve_s:.1f} s wall clock ({card})")
    return launches


def phase_banks(card: str, cfg) -> None:
    """12c: conv_bank_in and dual_conv_bank at the full width on the card,
    and the encoders fed the dual bank's outputs as bank_out."""
    from adaptive_voice_conversion_tpu_torch.ops.conv import conv1d, conv_bank, conv_bank_in, dual_conv_bank

    dev = torch.device("cuda")
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.to(dev).eval()
    spk, cnt = model.speaker_encoder, model.content_encoder
    dl = cfg.data_loader
    x = torch.randn(dl.batch_size, spk.cfg.c_in, dl.segment_size, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    bank = lambda enc: ([c.weight for c in enc.conv_bank], [c.bias for c in enc.conv_bank])
    rel = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())
    with torch.no_grad():
        concat = conv1d(conv_bank(x, *bank(spk), spk.kernel_sizes, spk.act),
                        spk.in_conv_layer.weight, spk.in_conv_layer.bias)
        split = conv_bank_in(x, *bank(spk), spk.kernel_sizes, spk.act,
                             spk.in_conv_layer.weight, spk.in_conv_layer.bias)
        out_s, out_c = dual_conv_bank(x, (bank(spk), bank(cnt)), spk.kernel_sizes, (spk.act, cnt.act))
        two = (conv_bank(x, *bank(spk), spk.kernel_sizes, spk.act),
               conv_bank(x, *bank(cnt), cnt.kernel_sizes, cnt.act))
        d_in = rel(split, concat)
        d_dual = max(rel(out_s, two[0]), rel(out_c, two[1]))
        d_emb = rel(spk(x, bank_out=out_s), spk(x))
        d_mu = rel(cnt(x, bank_out=out_c)[0], cnt(x)[0])
        t_in = cuda_ms(lambda: conv_bank_in(x, *bank(spk), spk.kernel_sizes, spk.act,
                                            spk.in_conv_layer.weight, spk.in_conv_layer.bias), reps=10)
        t_cat = cuda_ms(lambda: conv1d(conv_bank(x, *bank(spk), spk.kernel_sizes, spk.act),
                                       spk.in_conv_layer.weight, spk.in_conv_layer.bias), reps=10)
        t_dual = cuda_ms(lambda: dual_conv_bank(x, (bank(spk), bank(cnt)), spk.kernel_sizes,
                                                (spk.act, cnt.act)), reps=10)
        t_two = cuda_ms(lambda: (conv_bank(x, *bank(spk), spk.kernel_sizes, spk.act),
                                 conv_bank(x, *bank(cnt), cnt.kernel_sizes, cnt.act)), reps=10)
    for what, v in (("conv_bank_in against conv_bank -> conv1d", d_in),
                    ("dual_conv_bank against two conv_bank calls", d_dual),
                    ("the speaker encoder with bank_out against its own bank", d_emb),
                    ("the content encoder's mu with bank_out against its own bank", d_mu)):
        check(v <= TOL_BANK_REL, f"12c {what}: {v:.3e} of the largest output > {TOL_BANK_REL}")
    log(f"[exp] 12c at the full width (batch {dl.batch_size} x {spk.cfg.c_in} x {dl.segment_size}, "
        f"f32, TF32 off): largest difference relative to the largest output: conv_bank_in against "
        f"conv_bank -> conv1d {d_in:.3e}, dual_conv_bank against two conv_bank calls {d_dual:.3e}, "
        f"the encoders fed bank_out against their own banks {d_emb:.3e} (embedding) and {d_mu:.3e} "
        f"(mu); tol {TOL_BANK_REL} ({card})")
    log(f"[time] exp banks (f32, TF32 off, forward, CUDA events, mean of 10): conv_bank_in "
        f"{t_in:.3f} ms against conv_bank -> conv1d {t_cat:.3f} ms; dual_conv_bank {t_dual:.3f} ms "
        f"against two conv_bank calls {t_two:.3f} ms ({card})")


def phase_probes(card: str, d: Path) -> None:
    """12d: every probe through its CLI; profile must write a trace."""
    outs = run_probes(d / "probe_gate", {**PROBE_ARGS, "profile": ["--calls", "1", "--out_dir", d / "profile"]})
    for name, out in outs.items():
        check("devices: cuda" in out, f"probe {name} did not name the card")
    check("trace captured in" in outs["profile"] and "FAILED" not in outs["profile"],
          f"probe profile wrote no trace:\n{outs['profile']}")
    files = [q for q in (d / "profile").rglob("*") if q.is_file()]
    check(bool(files) and all(q.stat().st_size > 0 for q in files),
          f"probe profile's trace files {[(q.name, q.stat().st_size) for q in files]}")


def timed_part(label: str, fn):
    """fn(), its wall seconds logged under ``label``."""
    t = time.perf_counter()
    out = fn()
    log(f"{label} took {time.perf_counter() - t:.1f} s")
    return out


def phase_experiments(card: str) -> dict:
    """Phase 12 on a fresh copy of the phase-7 corpus."""
    t0 = time.perf_counter()
    cfg = load_config(str(REPO / "examples" / "config.yaml"))
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        write_corpus(d)
        ds = SegmentDataset(str(d / "train_128.pkl"), str(d / "train_samples_128.json"),
                            cfg.data_loader.segment_size)
        res = DeviceResidentDataset(ds, torch.device("cuda"), dtype="float32")
        timed = lambda label, fn: timed_part(f"[exp] {label}", fn)
        # 12b's processes run beside 12a's parity runs, which are
        # deterministic; nothing else shares the card while anything is timed
        with ThreadPoolExecutor(max_workers=1) as pool:
            cli = pool.submit(timed, "12b", lambda: phase_opt_cli(card, d))
            runs = timed("12a parity (beside 12b)", lambda: phase_opt_parity(card, cfg, res))
            launches = cli.result()
        timed("12a times", lambda: phase_opt_times(card, runs, res))
        del runs
        timed("12c", lambda: phase_banks(card, cfg))
        timed("12d", lambda: phase_probes(card, d))
    log(f"[exp] phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"serve_launches": launches}


def config_copy(d: Path, name: str, **changes) -> Path:
    """examples/config.yaml with these top-level fields changed, in ``d``."""
    cfg = dataclasses.replace(load_config(str(REPO / "examples" / "config.yaml")), **changes)
    path = d / name
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f)
    return path


TOL_GRAPH = 1e-4


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in f64 (0 where both are 0)."""
    a, b = a.double(), b.double()
    d, n = float((a - b).norm()), float(b.norm())
    return d / n if n else d


def eager_multi_step(cfg, model, opt, inner: int):
    """The multi-step's eager loop (train/step.py), step by step: each step
    seeds the generator, draws its batch and runs the step with the KL
    weight as a float and the optimiser's own bias corrections."""
    step = make_train_step(cfg, model, opt)
    gen = torch.Generator(device=next(model.parameters()).device)
    dl = cfg.data_loader

    def call(packed, starts, seed, it0):
        rows = []
        for it in range(it0, it0 + inner):
            gen.manual_seed(step_seed(seed, it))
            x = sample_segments(packed, starts, dl.segment_size, dl.batch_size, gen)
            m = step(x, kl_lambda(it, cfg.loss.lambda_kl, cfg.annealing_iters), generator=gen)
            rows.append(torch.stack([m["loss"], m["loss_rec"], m["loss_kl"], m["grad_norm"]]))
        return torch.stack(rows)

    return call


def graph_vs_eager(cfg, seed: int, calls: int = 3, inner: int = 10, n_frames: int = 60_000) -> dict:
    """``calls`` multi-step calls of ``inner`` steps with the step replayed
    as a CUDA graph against the same calls run eagerly (``eager_multi_step``)
    from the same weights, corpus and seed, on the card at the backend flags
    in force; and a run resumed from the graphed run's state after its
    second call (the first graphed one) against the graphed run's third.
    Returns each comparison's largest relative gap: the metrics per entry,
    the tensors per tensor (Frobenius), and whether each is bit for bit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_mels = cfg.model.content_encoder.c_in
    packed = torch.randn(n_frames, n_mels, generator=gen, device=dev)
    starts = torch.arange(0, n_frames - cfg.data_loader.segment_size, 3, device=dev)

    def fresh(state=None):
        model = AE(cfg.model)
        init_parameters(model, torch.Generator().manual_seed(seed))
        model.to(dev)
        opt = make_train_optimizer(cfg, model.parameters())
        if state is not None:
            model.load_state_dict(state[0])
            opt.load_state_dict(state[1])
        return model, opt

    def tensors(model, opt) -> dict:
        out = {f"model.{k}": v for k, v in model.state_dict().items()}
        for i, st in enumerate(opt.state_dict()["state"].values()):
            out.update({f"opt.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
        return out

    def compare(a: torch.Tensor, b: torch.Tensor, ta: dict, tb: dict) -> dict:
        rel = ((a.double() - b.double()).abs() / b.double().abs()).max().item()
        gaps = {k: _rel_gap(ta[k], tb[k]) for k in tb}
        worst = max(gaps, key=gaps.get)
        exact = torch.equal(a, b) and all(torch.equal(ta[k], tb[k]) for k in tb)
        return {"metrics": rel, "tensors": gaps[worst], "worst": worst, "exact": exact}

    runs = {}
    for mode in ("graph", "eager"):
        model, opt = fresh()
        if mode == "graph":
            multi = make_device_data_train_step(cfg, model, opt, inner_steps=inner)
        else:
            multi = eager_multi_step(cfg, model, opt, inner)
        outs, times = [], []
        for k in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(multi(packed, starts, seed, k * inner))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
            if k == 1:
                saved = copy.deepcopy((model.state_dict(), opt.state_dict()))
        runs[mode] = {"out": torch.stack(outs), "tensors": tensors(model, opt), "saved": saved,
                      "ms": times, "steps": opt.step_count(),
                      "replayed": mode == "graph" and multi.step_graph.graph is not None}
    g, e = runs["graph"], runs["eager"]
    model, opt = fresh(g["saved"])
    resumed = make_device_data_train_step(cfg, model, opt, inner_steps=inner)
    r_out = resumed(packed, starts, seed, (calls - 1) * inner)
    return {
        "graph": compare(g["out"], e["out"], g["tensors"], e["tensors"]),
        "resume": compare(r_out, g["out"][-1], tensors(model, opt), g["tensors"]),
        "finite": bool(torch.isfinite(g["out"]).all()),
        "replayed": g["replayed"],
        "steps": (g["steps"], e["steps"], calls * inner),
        "ms": {"graph": g["ms"], "eager": e["ms"]},
    }


def check_graph_vs_eager(r: dict, what: str, exact: bool) -> None:
    check(r["finite"], f"{what}: the graphed steps' metrics are not finite")
    check(r["replayed"], f"{what}: the graphed run did not replay a graph")
    check(len(set(r["steps"])) == 1, f"{what}: optimiser step counts {r['steps']} differ")
    for key in ("graph", "resume"):
        c = r[key]
        if exact:
            check(c["exact"], f"{what}: {key} not bit for bit: metrics {c['metrics']:.3e}, "
                  f"tensors {c['tensors']:.3e} ({c['worst']})")
        check(max(c["metrics"], c["tensors"]) <= TOL_GRAPH,
              f"{what}: {key} gap metrics {c['metrics']:.3e}, tensors {c['tensors']:.3e} "
              f"({c['worst']}) > {TOL_GRAPH}")


def graph_variants(cfg) -> dict:
    """The configurations that share the graphed step: f32, spectral norm,
    bf16 compute, and the flat optimiser with bf16 moments."""
    sn = dataclasses.replace(cfg.model, decoder=dataclasses.replace(cfg.model.decoder, sn=True))
    return {
        "f32": cfg,
        "sn": dataclasses.replace(cfg, model=sn),
        "bf16": dataclasses.replace(cfg, compute_dtype="bfloat16"),
        "bucketed4": dataclasses.replace(cfg, opt_fused="bucketed4", opt_state_dtype="bfloat16"),
    }


def phase_train_graph(card: str) -> None:
    """13: the step replayed as a CUDA graph against eager steps."""
    cfg = load_config(str(REPO / "examples" / "config.yaml"))
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, c in graph_variants(cfg).items():
            for deterministic in (True, False):
                torch.backends.cudnn.deterministic = deterministic
                t0 = time.perf_counter()
                r = graph_vs_eager(c, SEED + 13)
                what = f"13 graph {name} cudnn.deterministic={deterministic}"
                check_graph_vs_eager(r, what, exact=deterministic)
                ms = {k: ", ".join(f"{v:.2f}" for v in r["ms"][k]) for k in r["ms"]}
                log(f"[train] {what}: 3 calls x 10 steps, batch {c.data_loader.batch_size} x "
                    f"{c.data_loader.segment_size} x {c.model.content_encoder.c_in}, TF32 on: graphed "
                    f"vs eager bit for bit {r['graph']['exact']} (metrics {r['graph']['metrics']:.3e}, "
                    f"tensors {r['graph']['tensors']:.3e}, worst {r['graph']['worst']}); resumed after "
                    f"the first graphed call vs continuous bit for bit {r['resume']['exact']}; ms a "
                    f"step by call, graphed [{ms['graph']}] (the first eager, the second with the "
                    f"capture), eager [{ms['eager']}]; {time.perf_counter() - t0:.1f} s ({card})")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved


# phase 14: the training job's utterances, and its bounds with TF32 off
VOC_TRAIN_UTTS, VOC_TRAIN_SECONDS = 48, (1.0, 3.0)
TOL_VOC_TRAIN = {"loss_gap": 1e-4, "grad_gap": 1e-2, "grad_dist": 1e-3, "change_gap": 1e-2}


def generator_hashes() -> dict:
    """sha256 (16 hex digits) of the published generator's wavs, seeded
    weights, TF32 convolutions, no gradient (the junction kernel's path):
    8 rows of 120-480 frames masked, and the same mels unmasked."""
    cfg = config_from_dict({"vocoder": {"kind": "hifigan"}})
    voc = config_to_dict(cfg)["vocoder"]
    dev = torch.device("cuda")
    gen = Generator(cfg.vocoder).to(dev)
    gen.load_state_dict(ref_hifigan.make_params(voc, SEED + 140, dev), strict=True)
    gen.eval()
    mel = torch.randn(8, 480, 512, generator=torch.Generator(device=dev).manual_seed(SEED + 141), device=dev)
    lengths = torch.tensor(np.linspace(120, 480, 8).round().astype(np.int64), device=dev)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            wavs = {"masked": gen.generate(mel, lengths), "unmasked": gen.generate(mel)}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return {k: hashlib.sha256(w.cpu().numpy().tobytes()).hexdigest()[:16] for k, w in wavs.items()}


def phase_train_vocoder(card: str) -> dict:
    """14: the GAN step against the plain reference, its times, the served
    generator's hashes."""
    raw = config_to_dict(config_from_dict({"vocoder": {"kind": "hifigan"}, "vocoder_train": {}}))
    cfg = config_from_dict(raw)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 142)
    waves = []
    for i in range(VOC_TRAIN_UTTS):
        n = int(rng.uniform(*VOC_TRAIN_SECONDS) * SIG.sr)
        t = np.arange(n) / SIG.sr
        f0 = 90 + 170 * rng.random()
        y = sum(np.sin(2 * np.pi * k * f0 * t * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / k for k in range(1, 12))
        waves.append((0.2 * y / np.abs(y).max() + 0.003 * rng.standard_normal(n)).astype(np.float32))
    rng = np.random.default_rng(SEED + 143)
    attr = {"mean": (0.45 + 0.1 * rng.random(512)).astype(np.float32),
            "std": (0.12 + 0.05 * rng.random(512)).astype(np.float32)}
    corpus = tv.WaveCorpus(waves, cfg.signal, cfg.vocoder_train.segment_samples, dev, 10**10)
    gen0 = ref_train.make_gen_params(raw["vocoder"], SEED + 144, dev)
    disc0 = ref_train.make_disc_params(raw["vocoder_train"], SEED + 145, dev)

    theirs = ref_train.reference_steps(raw, gen0, disc0, corpus.packed, corpus.starts, attr, SEED, 3)
    gaps = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        gaps[tf32] = ref_train.compare_steps(
            train_hifigan.program_steps(cfg, *train_hifigan.build(cfg, gen0, disc0, dev), gen0, disc0, corpus,
                                        attr, SEED, 3), theirs)
    torch.backends.cudnn.allow_tf32 = False
    for key, tol in TOL_VOC_TRAIN.items():
        check(gaps[False][key] <= tol, f"14a GAN steps vs the plain reference, TF32 off: {key} "
              f"{gaps[False][key]:.3e} > {tol}")
    log(f"[vtrain] 14a 3 GAN steps vs the plain reference (batch 16 x 8400, {corpus.n_utterances} "
        f"utterances): TF32 off " + ", ".join(f"{k} {v:.3e}" for k, v in gaps[False].items())
        + "; TF32 on " + ", ".join(f"{k} {v:.3e}" for k, v in gaps[True].items()))

    torch.backends.cudnn.allow_tf32 = True
    try:
        generator, disc, opt_g, opt_d = train_hifigan.build(cfg, gen0, disc0, dev)
        multi = tv.make_vocoder_train_step(cfg, generator, disc, opt_g, opt_d, attr, 10, 1000)
        multi(corpus.packed, corpus.starts, SEED, 0)  # cuDNN's plans, AdamW's state
        multi(corpus.packed, corpus.starts, SEED, 10)  # the capture
        check(multi.graphs is not None and multi.graphs.graphs is not None,
              "14b the GAN step was not captured in CUDA graphs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(corpus.packed, corpus.starts, SEED, 20)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 100
        profiling.SPAN_LOG.spans.clear()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            multi(corpus.packed, corpus.starts, SEED, 30)
            torch.cuda.synchronize()
        launches = sum(1 for e in prof.events() if e.device_type.name == "CUDA"
                       and not getattr(e, "is_user_annotation", False) and not e.name.startswith("## ")) / 10
        by_span = {}
        for name, a, b in profiling.SPAN_LOG.spans:
            by_span[name] = by_span.get(name, 0.0) + (b - a) / 1e6 / 10
    finally:
        torch.backends.cudnn.allow_tf32 = False
    log(f"[time] vtrain 14b a GAN step, TF32 on, graphed: {step_ms:.1f} ms host clock (a call of 10); "
        f"under the profiler by span " + ", ".join(f"{k} {v:.1f} ms" for k, v in by_span.items())
        + f"; {launches:.0f} device operations a step ({card})")
    hashes = generator_hashes()
    log(f"[hifigan] 14c the published generator's wavs, no gradient, TF32 convolutions, sha256: "
        f"masked {hashes['masked']}, unmasked {hashes['unmasked']}")
    del multi, generator, disc, opt_g, opt_d
    torch.cuda.empty_cache()
    return {"gaps": gaps, "step_ms": step_ms, "hashes": hashes}


def phase_training(card: str) -> dict:
    cfg = load_config(str(REPO / "examples" / "config.yaml"))
    phase_train_step_parity(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        # the config leaves input_mode at auto, which is device mode for this
        # corpus: 7b-7c test the host stream
        out = phase_train_cli(card, d, config_copy(d, "config_host.yaml", input_mode="host"))
        out.update(phase_train_times(card, cfg, d))
        out.update(phase_data_modes(card, cfg, d, out))
        out.update(phase_distribution(card, cfg, d, out["resume_bound"]))
    return out


def main() -> None:
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    kern = phase_kernel()
    main_path = phase_main_path(card)
    serving = phase_serving(card)
    hifigan = phase_hifigan(card)
    times = phase_kernel_times(card)
    training = phase_training(card)
    phase_tensor_parallel(card)
    prep = phase_preprocess(card)
    experiments = phase_experiments(card)
    phase_train_graph(card)
    phase_train_vocoder(card)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "griffin_lim_phases",
        "route": "cuda",
        "source": "adaptive_voice_conversion_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "adaptive_voice_conversion_tpu/kernels/griffin_lim.py:159",
        "launches": main_path["launches"],
        "launches_by_path": {
            "one-shot CLI": main_path["launches"],
            "convert_grid CLI": serving["launches"],
            "train -> serve CLI": training["serve_launches"],
            "train (device mode) -> serve CLI": training["device_serve_launches"],
            "convert_grid over 2 ranks (per rank)": training["dist_serve_launches"],
            "preprocess -> train -> serve CLI": prep["serve_launches"],
            "train (opt_fused bucketed4) -> serve CLI": experiments["serve_launches"],
        },
        "max_abs_err": kern["a"]["max_abs_err"],
        "ms": times["main"]["ms"],
        "plain_ms": times["main"]["plain_ms"],
        "bound_ms": times["main"]["bound_ms"],
        "bound_by": times["main"]["bound_by"],
        "library_ms": times["main"]["library_ms"],
    }, {
        "name": "junction",
        "route": "cuda",
        "source": "adaptive_voice_conversion_tpu_torch/csrc/hifigan_junction.cu",
        "replaces": None,
        "launches": hifigan["launches"]["grid"],
        "launches_by_path": {
            "convert_grid 8 x 16 with the HiFi-GAN generator (a call)": hifigan["launches"]["grid"],
            "one-shot conversion with the HiFi-GAN generator (a call)": hifigan["launches"]["oneshot"],
        },
        "ms": hifigan["junction"]["ms"],
        "plain_ms": hifigan["junction"]["plain_ms"],
        "bound_ms": hifigan["junction"]["bound_ms"],
        "bound_by": "bytes",
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
