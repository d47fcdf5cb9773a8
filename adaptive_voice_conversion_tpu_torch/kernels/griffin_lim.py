"""Fused Griffin-Lim phase iterations: CUDA kernel wrapper, plain version,
and the hybrid schedule around them.

Replaces the Pallas TPU kernel ``_kernel`` launched by
``griffin_lim_phases_pallas`` (adaptive_voice_conversion_tpu/kernels/
griffin_lim.py:159-321). The iteration runs in frame space and never
builds a waveform:

    syn  = bf16([re*ck | im*ck]) x cs^T          (f32 accumulation)
    acc  = sum_{|d| <= n_taps} shift(syn, rows d, cols -d*hop)
    [re2 | im2] = bf16(acc * g) x cs             (f32 accumulation)
    (re, im) = mag * (re2, im2) / max(|(re2, im2)|, 1e-8)

with cs = [w*cos | -w*sin] over the 1280-sample window support, stored
once in bf16. Frames are rows (padded to t_pad, a multiple of 8, per
utterance) and frequencies are columns (padded to f_pad = 1152).

- ``griffin_lim_phases`` is the wrapper: on a CUDA tensor it launches the
  kernel (csrc/griffin_lim.cu, built on first use) or raises; on a CPU
  tensor it runs ``griffin_lim_phases_plain``. ``griffin_lim_phases.launches``
  counts its kernel launches.
- ``griffin_lim_phases_plain`` is the same arithmetic in torch ops, with
  ``.to(torch.bfloat16).float()`` at the kernel's two rounding points.
- The 384-frame segmentation, the warm start, the reflect extension and
  the exact polish are ported exactly, so outputs match the JAX package for
  every length.

What bounds the kernel on the H100, and its design: see the note at the
top of csrc/griffin_lim.cu. Three pure functions model what the CUDA file
does, so that the CPU tests reach it and the card can be held to it:
``operand_offset`` (where an element sits in a bf16 operand image),
``launch_plan`` (the tiles and the K split ``gl_run`` takes at a row
count) and ``iteration_bytes`` (what one iteration moves under a plan).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import SignalConfig
from ..dsp.stft import hann_window, istft
from ..dsp.vocoder import _exact_iterations
from ._build import load_library

FREQ_PAD = 128  # frequency axis padded to a multiple of this (1025 -> 1152)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@lru_cache(maxsize=4)
def _gl_constants(n_fft: int, win_length: int, hop_length: int):
    """Numpy constants for the fused iteration (same as the JAX package's).

    Returns (cos_m, sin_m, ck_scale, g_scale, off, n_taps):
      cos_m/sin_m : (s_pad, f_pad) DFT bases over the window support
      ck_scale    : (f_pad,) irfft coefficient scaling c_k/N (0 on pad cols)
      g_scale     : (s_pad,) hop-periodic interior 1/wss gain
      off         : first supported sample within the n_fft frame
      n_taps      : neighbor radius d_max with |d*hop| < s_pad
    """
    n_freq = 1 + n_fft // 2
    f_pad = _round_up(n_freq, FREQ_PAD)
    w = hann_window(win_length, n_fft)
    support = np.nonzero(w != 0.0)[0]
    s_lo = int(support[0]) if support.size else 0
    s_hi = int(support[-1]) + 1 if support.size else n_fft
    s_pad = _round_up(s_hi - s_lo, 128)
    off = max(0, min(s_lo, n_fft - s_pad))

    n = np.arange(off, off + s_pad)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w_sup = w[off : off + s_pad, None]  # window folded into both directions
    cos_m = (w_sup * np.cos(ang)).astype(np.float32)
    sin_m = (-w_sup * np.sin(ang)).astype(np.float32)  # rfft e^{-i.}
    cos_m = np.pad(cos_m, ((0, 0), (0, f_pad - n_freq)))
    sin_m = np.pad(sin_m, ((0, 0), (0, f_pad - n_freq)))

    ck = np.full(n_freq, 2.0 / n_fft)
    ck[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        ck[-1] = 1.0 / n_fft
    ck_scale = np.pad(ck, (0, f_pad - n_freq)).astype(np.float32)

    # hop-periodic interior window-sum-squares: tile enough frames that the
    # middle hop-period sees every overlapping window, then read it off
    reps = 2 * (n_fft // hop_length) + 4
    total = n_fft + hop_length * (reps - 1)
    wss = np.zeros(total)
    for t in range(reps):
        wss[t * hop_length : t * hop_length + n_fft] += w**2
    mid = total // 2
    phase0 = mid - (mid % hop_length)
    wss_per = wss[phase0 : phase0 + hop_length]
    sample_pos = np.arange(off, off + s_pad)
    g_scale = (1.0 / wss_per[sample_pos % hop_length]).astype(np.float32)

    n_taps = (s_pad - 1) // hop_length
    return cos_m, sin_m, ck_scale, g_scale, off, n_taps


@dataclass(frozen=True)
class _Consts:
    cs: torch.Tensor  # (s_pad, 2*f_pad) bf16, [w*cos | -w*sin]
    ck: torch.Tensor  # (f_pad,) f32
    g: torch.Tensor  # (s_pad,) f32
    n_taps: int

    @property
    def s_pad(self) -> int:
        return self.cs.shape[0]

    @property
    def f_pad(self) -> int:
        return self.cs.shape[1] // 2


@lru_cache(maxsize=4)
def _device_consts(
    n_fft: int, win_length: int, hop_length: int, device: torch.device
) -> _Consts:
    cos_m, sin_m, ck, g, _, n_taps = _gl_constants(n_fft, win_length, hop_length)
    cs = torch.from_numpy(np.concatenate([cos_m, sin_m], axis=1))
    return _Consts(
        cs=cs.to(torch.bfloat16).to(device),
        ck=torch.from_numpy(ck).to(device),
        g=torch.from_numpy(g).to(device),
        n_taps=n_taps,
    )


def _padded_frames(t: int) -> int:
    """Frame rows of one block: t rounded up to a multiple of 8."""
    return _round_up(max(t, 8), 8)


def _to_frames(mag: torch.Tensor, init_spec: Optional[torch.Tensor], f_pad: int):
    """mag (B, n_freq, T) -> (mag, re0, im0) each (B*t_pad, f_pad) f32."""
    b, n_freq, t = mag.shape
    t_pad = _padded_frames(t)
    pads = (0, f_pad - n_freq, 0, t_pad - t)
    m = F.pad(mag.float().transpose(-1, -2), pads)
    if init_spec is None:
        re0, im0 = m, torch.zeros_like(m)
    else:
        i0 = init_spec.transpose(-1, -2)
        re0 = F.pad(i0.real.float(), pads)
        im0 = F.pad(i0.imag.float(), pads)
    flat = lambda x: x.reshape(b * t_pad, f_pad).contiguous()
    return flat(m), flat(re0), flat(im0), t_pad


def _from_frames(re, im, b: int, t_pad: int, n_freq: int, t: int) -> torch.Tensor:
    spec = torch.complex(re, im).reshape(b, t_pad, -1).transpose(-1, -2)
    return spec[:, :n_freq, :t]


def _band(syn: torch.Tensor, t_pad: int, hop: int, n_taps: int) -> torch.Tensor:
    """Banded overlap-add of (M, s_pad) synthesis frames, masked at every
    t_pad block (the band never crosses utterances), summed in the kernel's
    order: for d = 1..n_taps, the frame d below, then the frame d above."""
    s_pad = syn.shape[1]
    syn3 = syn.reshape(-1, t_pad, s_pad)
    acc = syn3
    for d in range(1, n_taps + 1):
        sh = d * hop
        plus = torch.zeros_like(syn3)
        plus[:, : t_pad - d, sh:] = syn3[:, d:, : s_pad - sh]
        acc = acc + plus
        minus = torch.zeros_like(syn3)
        minus[:, d:, : s_pad - sh] = syn3[:, : t_pad - d, sh:]
        acc = acc + minus
    return acc.reshape(-1, s_pad)


def _iterate_plain(m, re, im, c: _Consts, t_pad: int, hop: int, n_iter: int):
    cs = c.cs.float()  # bf16 values, exact in f32: products are exact
    f_pad = c.f_pad
    bf = lambda x: x.to(torch.bfloat16).float()
    for _ in range(n_iter):
        syn = bf(torch.cat([re * c.ck, im * c.ck], dim=1)) @ cs.T
        re_im2 = bf(_band(syn, t_pad, hop, c.n_taps) * c.g) @ cs
        re2, im2 = re_im2[:, :f_pad], re_im2[:, f_pad:]
        denom = torch.clamp(torch.sqrt(re2 * re2 + im2 * im2), min=1e-8)
        re = m * re2 / denom
        im = m * im2 / denom
    return re, im


def griffin_lim_phases_plain(
    mag: torch.Tensor,
    cfg: SignalConfig = SignalConfig(),
    n_iter: int = 100,
    init_spec: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mag (B, n_freq, T) f32 -> complex (B, n_freq, T), in torch ops.

    ``init_spec`` seeds the iteration with prior phases; None starts from
    zero phase (re=mag, im=0). Runs on the tensor's device."""
    c = _device_consts(cfg.n_fft, cfg.win_length, cfg.hop_length, mag.device)
    b, n_freq, t = mag.shape
    m, re, im, t_pad = _to_frames(mag, init_spec, c.f_pad)
    re, im = _iterate_plain(m, re, im, c, t_pad, cfg.hop_length, n_iter)
    return _from_frames(re, im, b, t_pad, n_freq, t)


# The constants of csrc/griffin_lim.cu that the models below repeat
# (gl_constants and gl_tile_rows export the file's own; chip_smoke.py holds
# the two together on the card).
IMAGE_K = 64  # columns of one k tile of an operand image: 128 bytes of bf16
IMAGE_ROW_PAD = 256  # an A image holds its rows rounded up to a multiple of this
NUM_SMS = 132  # the launch plan is tuned for the H100 SXM
# the plan's cost model, in 128-byte operand rows: a block's start, the
# epilogues per tile column of a 128-row tile, a part of K per 128 rows
PLAN_START, PLAN_EPI_SYN, PLAN_EPI_ANA, PLAN_SPLIT = 500, 8, 16, 80


def operand_offset(row: int, k: int, rows: int) -> int:
    """Element offset of (row, k) in a bf16 operand image of ``rows`` rows.

    The image is stored k tile by k tile (IMAGE_K columns each); a k tile is
    a (rows, 64) row-major matrix of 128-byte rows, and inside a row the
    16-byte piece ``(k % 64) // 8`` sits at piece index ``piece ^ (row % 8)``:
    wgmma's 128-byte swizzle, so that any 8-aligned run of rows of one k tile
    is one contiguous copy into shared memory."""
    piece = ((k >> 3) & 7) ^ (row & 7)
    return ((k // IMAGE_K) * rows + row) * IMAGE_K + (piece << 3) + (k & 7)


@dataclass(frozen=True)
class LaunchPlan:
    """How gl_run launches the two products at a row count: the block tile
    (rows x columns) of each, and the parts of the syn product's K (partial
    sums in device memory, added by the band pass)."""

    syn_bm: int
    syn_bn: int
    syn_split: int
    ana_bm: int
    ana_bn: int


_SYN_TILES = ((128, 128), (128, 160), (128, 256), (256, 160))
_ANA_TILES = ((64, 128), (128, 128), (128, 192), (128, 256), (256, 144))
_SPLITS = (1, 2, 3, 4, 6)


def _gemm_cost(rows, n_cols, k_tiles, bm, bn, split, epi) -> int:
    """The plan's cost model, in units of one 128-byte operand row pulled
    into an SM (what bounds a block's k-step): rounds of blocks on the SMs x
    (a block's k-steps x the rows of a stage + its epilogue + its start),
    plus what the band pays for reading partial sums."""
    blocks = -(-rows // bm) * (n_cols // bn) * split
    rounds = -(-blocks // NUM_SMS)
    cost = rounds * ((k_tiles // split) * (bm + bn) + epi * bn * bm // 128 + PLAN_START)
    return cost + (PLAN_SPLIT * -(-rows // 128) * split if split > 1 else 0)


def launch_plan(rows: int, f_pad: int = 1152, s_pad: int = 1280) -> LaunchPlan:
    """The plan gl_run takes at ``rows`` rows (the same search, in the same
    order, as make_plan in csrc/griffin_lim.cu): the cheapest tile of each
    product, K of the syn product split only where the tiles alone cannot
    fill the SMs."""
    best, syn = None, None
    for bm, bn in _SYN_TILES:
        if s_pad % bn:
            continue
        for split in _SPLITS:
            blocks = -(-rows // bm) * (s_pad // bn)
            if (2 * f_pad // IMAGE_K) % split:
                continue
            if split > 1 and (blocks >= NUM_SMS or blocks * split > NUM_SMS):
                continue
            cost = _gemm_cost(rows, s_pad, 2 * f_pad // IMAGE_K, bm, bn, split, PLAN_EPI_SYN)
            if best is None or cost < best:
                best, syn = cost, (bm, bn, split)
    best, ana = None, None
    for bm, bn in _ANA_TILES:
        if f_pad % (bn // 2):
            continue
        cost = _gemm_cost(rows, 2 * f_pad, s_pad // IMAGE_K, bm, bn, 1, PLAN_EPI_ANA)
        if best is None or cost < best:
            best, ana = cost, (bm, bn)
    if syn is None or ana is None:
        raise ValueError(f"no block tile fits f_pad {f_pad}, s_pad {s_pad}")
    return LaunchPlan(*syn, *ana)


def scratch_bytes(rows: int, plan: LaunchPlan, f_pad: int = 1152, s_pad: int = 1280) -> dict:
    """Device memory the wrapper allocates beside the inputs for one call."""
    a_rows = _round_up(rows, IMAGE_ROW_PAD)
    return {
        "re_im": 2 * rows * f_pad * 4,
        "a_syn": a_rows * 2 * f_pad * 2,
        "a_ana": a_rows * s_pad * 2,
        "syn": plan.syn_split * rows * s_pad * 4,
    }


def iteration_bytes(
    rows: int, plan: LaunchPlan, f_pad: int = 1152, s_pad: int = 1280, last: bool = False
) -> dict:
    """Device-memory bytes one iteration writes and reads under ``plan``,
    each array counted once per launch that touches it (what a launch reads
    again comes from L2). ``last``: the iteration that stores the f32 state."""
    syn = plan.syn_split * rows * s_pad * 4
    a_syn, a_ana = rows * 2 * f_pad * 2, rows * s_pad * 2
    basis = s_pad * 2 * f_pad * 2
    out = {
        "syn_gemm_read": a_syn + basis,
        "syn_gemm_write": syn,
        "band_read": syn + s_pad * 4,
        "band_write": a_ana,
        "ana_gemm_read": a_ana + basis + rows * f_pad * 4 + f_pad * 4,
        "ana_gemm_write": a_syn + (2 * rows * f_pad * 4 if last else 0),
    }
    out["total"] = sum(out.values())
    return out


@lru_cache(maxsize=None)
def _gl_lib() -> ctypes.CDLL:
    lib = load_library("griffin_lim")
    lib.gl_run.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.gl_run.restype = ctypes.c_int
    lib.gl_tile_bases.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.gl_tile_bases.restype = ctypes.c_int
    lib.gl_tile_rows.argtypes = []
    lib.gl_tile_rows.restype = ctypes.c_int
    lib.gl_max_rows.argtypes = [ctypes.c_int] * 2
    lib.gl_max_rows.restype = ctypes.c_int
    lib.gl_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.gl_plan.restype = ctypes.c_int
    lib.gl_set_launch_overlap.argtypes = [ctypes.c_int]
    lib.gl_set_launch_overlap.restype = None
    for query in (lib.gl_last_plan, lib.gl_constants):
        query.argtypes = [ctypes.POINTER(ctypes.c_int)]
        query.restype = None
    return lib


def kernel_plan(rows: int, f_pad: int, s_pad: int) -> LaunchPlan:
    """The plan csrc/griffin_lim.cu itself makes at ``rows`` rows."""
    out = (ctypes.c_int * 5)()
    if _gl_lib().gl_plan(rows, f_pad, s_pad, out) != 0:
        raise ValueError(f"griffin_lim kernel: no block tile fits f_pad {f_pad}, s_pad {s_pad}")
    return LaunchPlan(*out)


def set_launch_overlap(on: bool) -> None:
    """For measurements: False makes the loop's launches plain launches, each
    starting when the one before has ended, so that a profiler's span of a
    launch is its own time. The default (True) is programmatic dependent
    launch, under which the spans overlap."""
    _gl_lib().gl_set_launch_overlap(int(on))


def kernel_last_plan() -> LaunchPlan:
    """The plan the kernel's last launch sequence took."""
    out = (ctypes.c_int * 5)()
    _gl_lib().gl_last_plan(out)
    return LaunchPlan(*out)


@lru_cache(maxsize=4)
def _kernel_bases(n_fft: int, win_length: int, hop_length: int, device: torch.device):
    """The kernel's two B operands, made once per device from the plain
    basis cs by gl_tile_bases: the operand images (``operand_offset``) of cs
    (rows = samples) and of cs^T (rows = the 2*f_pad columns of cs)."""
    c = _device_consts(n_fft, win_length, hop_length, device)
    syn_b, ana_b = torch.empty_like(c.cs), torch.empty_like(c.cs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        rc = _gl_lib().gl_tile_bases(
            c.cs.data_ptr(), syn_b.data_ptr(), ana_b.data_ptr(), c.f_pad, c.s_pad,
            stream.cuda_stream,
        )
        stream.synchronize()  # the cached bases are whole before any stream reads them
    if rc != 0:
        raise RuntimeError(f"griffin_lim basis tiling failed: CUDA error {rc}")
    return syn_b, ana_b


def griffin_lim_phases(
    mag: torch.Tensor,
    cfg: SignalConfig = SignalConfig(),
    n_iter: int = 100,
    init_spec: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused kernel: mag (B, n_freq, T) f32 -> complex (B, n_freq, T).

    The B utterances (or segments) are stacked along the rows of one launch
    sequence. Frames of zero magnitude (the pad frames of a ragged batch)
    come out exactly zero. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel or raises, also on more rows than the
    kernel's 32-bit element indices address."""
    if mag.device.type == "cpu":
        return griffin_lim_phases_plain(mag, cfg, n_iter, init_spec)
    if mag.device.type != "cuda":
        raise ValueError(f"griffin_lim_phases: unsupported device {mag.device}")
    if mag.dim() != 3:
        raise ValueError(f"mag must be (B, n_freq, T), got {tuple(mag.shape)}")
    if init_spec is not None and (
        init_spec.shape != mag.shape or init_spec.device != mag.device
    ):
        raise ValueError("init_spec must match mag's shape and device")
    c = _device_consts(cfg.n_fft, cfg.win_length, cfg.hop_length, mag.device)
    b, n_freq, t = mag.shape
    lib = _gl_lib()
    rows = b * _padded_frames(t)
    max_rows = lib.gl_max_rows(c.f_pad, c.s_pad)
    if rows > max_rows:
        raise ValueError(
            f"griffin_lim_phases: {b} blocks of {_padded_frames(t)} frame rows = "
            f"{rows} rows, more than the {max_rows} the kernel's 32-bit element "
            "indices address; split the batch"
        )
    m, re0, im0, t_pad = _to_frames(mag, init_spec, c.f_pad)
    if n_iter == 0:
        return _from_frames(re0, im0, b, t_pad, n_freq, t)
    syn_b, ana_b = _kernel_bases(cfg.n_fft, cfg.win_length, cfg.hop_length, mag.device)
    with torch.cuda.device(mag.device):
        re = torch.empty_like(m)
        im = torch.empty_like(m)
        # bf16 operand images, whole row tiles; rows past `rows` must read as zero
        a_rows = _round_up(rows, lib.gl_tile_rows())
        a_syn = torch.zeros(a_rows * 2 * c.f_pad, dtype=torch.bfloat16, device=mag.device)
        a_ana = torch.zeros(a_rows * c.s_pad, dtype=torch.bfloat16, device=mag.device)
        split = kernel_plan(rows, c.f_pad, c.s_pad).syn_split
        syn = torch.empty(split, rows, c.s_pad, dtype=torch.float32, device=mag.device)
        stream = torch.cuda.current_stream(mag.device).cuda_stream
        rc = lib.gl_run(
            m.data_ptr(), re0.data_ptr(), im0.data_ptr(), syn_b.data_ptr(),
            ana_b.data_ptr(), c.ck.data_ptr(), c.g.data_ptr(), re.data_ptr(),
            im.data_ptr(), a_syn.data_ptr(), syn.data_ptr(), a_ana.data_ptr(),
            rows, c.f_pad, c.s_pad, t_pad, cfg.hop_length, c.n_taps, n_iter,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"griffin_lim kernel launch failed: CUDA error {rc}")
    griffin_lim_phases.launches += 1
    return _from_frames(re, im, b, t_pad, n_freq, t)


griffin_lim_phases.launches = 0


def _polish_exact(mag, spec, cfg: SignalConfig, k: int):
    """k exact Griffin-Lim iterations seeded with the kernel's phases: they
    repair the utterance-boundary and segment-seam perturbations of the
    kernel's interior-band approximation."""
    return _exact_iterations(
        mag, spec, cfg.n_fft, cfg.hop_length, cfg.win_length, k
    )


# Windows of SEG_FRAMES frames overlapping by SEG_OVERLAP, run through the
# kernel as one stacked batch, then stitched at the midpoints of their
# overlaps. n_taps = 4 frames is the kernel's coupling radius, so a 32-frame
# overlap keeps each kept frame > 4 taps away from its window's edge. The
# JAX package needed the cap for VMEM; it is kept here because it changes
# the output for T > 384.
SEG_FRAMES = 384
SEG_OVERLAP = 32


def _segment_starts(t: int) -> list:
    if t <= SEG_FRAMES:
        return [0]
    step = SEG_FRAMES - SEG_OVERLAP
    starts = list(range(0, t - SEG_FRAMES + step, step))
    starts[-1] = min(starts[-1], t - SEG_FRAMES)
    return starts


def griffin_lim_phases_segmented(
    mag: torch.Tensor,
    cfg: SignalConfig = SignalConfig(),
    n_iter: int = 100,
    init_spec: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel phases for any frame count: mag (B, n_freq, T) -> complex
    (B, n_freq, T) via overlapping SEG_FRAMES windows stacked in one launch.
    ``init_spec`` seeds every window with the prior global phase estimate."""
    b, n_freq, t = mag.shape
    starts = _segment_starts(t)
    if len(starts) == 1:
        return griffin_lim_phases(mag, cfg, n_iter=n_iter, init_spec=init_spec)
    segs = torch.cat([mag[:, :, s : s + SEG_FRAMES] for s in starts], dim=0)
    init_segs = (
        None
        if init_spec is None
        else torch.cat([init_spec[:, :, s : s + SEG_FRAMES] for s in starts], dim=0)
    )
    spec_segs = griffin_lim_phases(segs, cfg, n_iter=n_iter, init_spec=init_segs)
    parts = []
    for i, s in enumerate(starts):
        seg = spec_segs[i * b : (i + 1) * b]
        lo = 0 if i == 0 else (starts[i - 1] + SEG_FRAMES + s) // 2 - s
        hi = (
            SEG_FRAMES
            if i == len(starts) - 1
            else (s + SEG_FRAMES + starts[i + 1]) // 2 - s
        )
        parts.append(seg[:, :, lo:hi])
    return torch.cat(parts, dim=-1)


def _reflect_frames(x: torch.Tensor, ext: int) -> torch.Tensor:
    """Torch-style reflect of the frame axis (edge frame not repeated)."""
    return torch.cat(
        [x[:, :, 1 : 1 + ext].flip(-1), x, x[:, :, -1 - ext : -1].flip(-1)],
        dim=-1,
    )


def griffin_lim_fused(
    mag: torch.Tensor,
    cfg: SignalConfig = SignalConfig(),
    n_iter: Optional[int] = None,
    polish_iters: int = 2,
    schedule: str = "end",
    ext_frames: int = 6,
    warm_start: int = 4,
) -> torch.Tensor:
    """Griffin-Lim through the fused kernel; counterpart of the JAX
    package's ``griffin_lim_pallas``.

    mag: (n_freq, T) or (B, n_freq, T) f32 -> wav (..., hop*(T-1)).
      1. ``warm_start`` exact iterations from zero phase give every frame
         (and every segment) one coherent phase estimate;
      2. the kernel runs the bulk iterations on the magnitude reflect-
         extended by ``ext_frames`` per side, so the true edges sit inside
         its exact interior band;
      3. ``polish_iters`` exact iterations repair the boundary perturbation.
    ``schedule``: "end" (default) or "interleaved" (kernel runs split
    between single exact iterations)."""
    if schedule not in ("end", "interleaved"):
        raise ValueError(f"schedule={schedule!r}: expected 'end' or 'interleaved'")
    n_iter = cfg.n_iter if n_iter is None else n_iter
    polish = min(polish_iters, n_iter)
    squeeze = mag.dim() == 2
    if squeeze:
        mag = mag[None]
    warm = min(warm_start, n_iter - polish)
    warm_spec = (
        _polish_exact(mag, mag.to(torch.complex64), cfg, warm) if warm else None
    )
    ext = min(ext_frames, mag.shape[-1] - 1)
    mag_k = _reflect_frames(mag, ext) if ext else mag

    def _crop(spec_e):
        return spec_e[:, :, ext : spec_e.shape[-1] - ext] if ext else spec_e

    def _ext_spec(sp):
        if sp is None or not ext:
            return sp
        return _reflect_frames(sp, ext)

    if polish == 0:
        spec = _crop(griffin_lim_phases_segmented(
            mag_k, cfg, n_iter=n_iter - warm, init_spec=_ext_spec(warm_spec),
        ))
    elif schedule == "end":
        spec = _crop(griffin_lim_phases_segmented(
            mag_k, cfg, n_iter=n_iter - polish - warm,
            init_spec=_ext_spec(warm_spec),
        ))
        spec = _polish_exact(mag, spec, cfg, polish)
    else:
        kern_total = n_iter - polish
        base = kern_total // polish
        rem = kern_total - base * polish
        spec = None
        for j in range(polish):
            k = base + (rem if j == 0 else 0)
            if k > 0:
                spec = _crop(griffin_lim_phases_segmented(
                    mag_k, cfg, n_iter=k, init_spec=_ext_spec(spec),
                ))
            spec = _polish_exact(
                mag, spec if spec is not None else mag.to(torch.complex64),
                cfg, 1,
            )
    wav = istft(spec, cfg.n_fft, cfg.hop_length, cfg.win_length).float()
    return wav[0] if squeeze else wav
