"""Audio IO and time-domain utilities (librosa-free).

The numpy/scipy functions are the port's own copies of the JAX package's:
wav load with resampling, silence trim (librosa.effects.trim semantics),
pre-emphasis and de-preemphasis (scipy lfilter). ``deemphasis_torch`` is
the on-device de-preemphasis for tensors, and ``trim_bounds`` the silence
trim's bounds for a batch of rows on their device (the served wavs').
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal
from scipy.io import wavfile

from ..utils.profiling import span


def load_wav(path: str, sr: int) -> np.ndarray:
    """Read a wav file as mono float32 in [-1, 1], resampled to ``sr``."""
    in_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim == 2:
        y = y.mean(axis=1)
    if in_sr != sr:
        g = np.gcd(int(in_sr), int(sr))
        y = signal.resample_poly(y, sr // g, in_sr // g).astype(np.float32)
    return y


def save_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write a float32 wav."""
    wavfile.write(path, sr, y.astype(np.float32))


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered per-frame RMS (librosa.feature.rms semantics: constant pad)."""
    pad = frame_length // 2
    yp = np.pad(y.astype(np.float64), pad, mode="constant")
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = (
        np.arange(frame_length)[None, :]
        + hop_length * np.arange(n_frames)[:, None]
    )
    frames = yp[idx]
    return np.sqrt(np.mean(frames**2, axis=1))


def trim_silence(
    y: np.ndarray,
    top_db: float,
    frame_length: int = 2048,
    hop_length: int = 512,
):
    """librosa.effects.trim: drop leading/trailing frames quieter than
    ``top_db`` dB below the peak RMS. Returns (trimmed, (start, end))."""
    with span("dsp.trim"):
        rms = _frame_rms(y, frame_length, hop_length)
        power = rms**2
        ref = power.max()
        if ref <= 0:
            return y, (0, len(y))
        db = 10.0 * np.log10(np.maximum(power, 1e-20) / ref)
        nonsilent = np.flatnonzero(db > -top_db)
        if len(nonsilent) == 0:
            return y[0:0], (0, 0)
        start = int(nonsilent[0] * hop_length)
        end = min(len(y), int((nonsilent[-1] + 1) * hop_length))
        return y[start:end], (start, end)


def _pairwise_frame_sums(sq: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Sums of the centred frames of ``sq`` (B, nb * hop_length), already
    padded, in numpy's pairwise order for a contiguous float64 row of
    ``frame_length`` values: halves down to 128-value leaves, each leaf
    summed by 8 strided accumulators. So every frame's sum is the one
    ``np.mean`` takes, bit for bit, and no frame is gathered: the leaves
    and their aligned pairs up to hop-sized blocks are computed once, and
    a frame joins the ``frame_length // hop_length`` blocks it spans."""
    b = sq.shape[0]
    leaves = sq.reshape(b, -1, 16, 8)
    acc = leaves[:, :, 0]
    for i in range(1, 16):
        acc = acc + leaves[:, :, i]
    while acc.shape[-1] > 1:  # 8 accumulators: ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))
        acc = acc[..., 0::2] + acc[..., 1::2]
    blocks = acc[..., 0]
    width = 128
    while width < hop_length:  # aligned pairs up to hop-sized blocks
        blocks = blocks[:, 0::2] + blocks[:, 1::2]
        width *= 2
    span_ = 1
    while span_ < frame_length // hop_length:  # the frame's upper halvings
        blocks = blocks[:, :-span_] + blocks[:, span_:]
        span_ *= 2
    return blocks


def trim_bounds(
    wavs: torch.Tensor,
    valid_lens: Optional[torch.Tensor],
    top_db: float,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> torch.Tensor:
    """``trim_silence``'s (start, end) for every row of ``wavs`` (B, N), each
    row cropped to its ``valid_lens[k]`` (B,) samples (every row whole where
    None), in one batched float64 pass on the rows' device: (B, 2) int64.

    Row by row the semantics are ``trim_silence``'s on the cropped row:
    samples past the crop count as zero, the row's ``1 + L // hop_length``
    frames set the peak and the loud set, a silent row keeps (0, L) and a
    row with no loud frame gets (0, 0). Each frame's mean square is
    numpy's bit for bit (``_pairwise_frame_sums``); the square root and the
    logarithm are the device's own roundings, so a bound could move only
    where a frame's decibels lie within the last bits of ``-top_db``.
    ``frame_length`` and ``hop_length`` are powers of two with 128 <=
    hop_length < frame_length.
    """
    if not (128 <= hop_length < frame_length and _pow2(hop_length) and _pow2(frame_length)):
        raise ValueError(f"frame_length={frame_length}, hop_length={hop_length}: expected "
                         "powers of two with 128 <= hop_length < frame_length")
    with span("dsp.trim"):
        b, n = wavs.shape
        dev = wavs.device
        lens = (torch.full((b,), n, dtype=torch.int64, device=dev) if valid_lens is None
                else valid_lens.to(torch.int64))
        y = wavs.to(torch.float64)
        y = torch.where(torch.arange(n, device=dev) < lens[:, None], y, 0.0)
        pad = frame_length // 2
        nb = n // hop_length + frame_length // hop_length  # blocks under the last frame
        sq = F.pad(y * y, (pad, nb * hop_length - pad - n))
        rms = torch.sqrt(_pairwise_frame_sums(sq, frame_length, hop_length) / frame_length)
        power = rms * rms
        # a frame past a row's count holds a tail of its last frame's samples:
        # out of the peak and the loud set, it could differ only in the last bit
        frames = torch.arange(power.shape[1], device=dev)
        counted = frames <= (lens // hop_length)[:, None]
        ref = torch.where(counted, power, 0.0).amax(dim=1, keepdim=True)
        # a silent row's peak is 0: its frames read +inf dB, so it keeps (0, L)
        loud = (10.0 * torch.log10(power.clamp_min(1e-20) / ref) > -top_db) & counted
        first = torch.where(loud, frames, power.shape[1]).amin(dim=1)
        last = torch.where(loud, frames, -1).amax(dim=1)
        start = torch.where(last >= 0, first * hop_length, 0)
        end = torch.where(last >= 0, torch.minimum(lens, (last + 1) * hop_length), 0)
        return torch.stack([start, end], dim=1)


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def preemphasis(y: np.ndarray, coef: float) -> np.ndarray:
    """y'[0]=y[0]; y'[t] = y[t] - coef*y[t-1]."""
    return np.append(y[0], y[1:] - coef * y[:-1]).astype(y.dtype)


def deemphasis(y: np.ndarray, coef: float) -> np.ndarray:
    """Inverse filter lfilter([1], [1, -coef])."""
    return signal.lfilter([1.0], [1.0, -coef], y)


def deemphasis_torch(y: torch.Tensor, coef: float, taps: int = 512) -> torch.Tensor:
    """De-preemphasis on a tensor (..., n_samples): the IIR
    ``1/(1 - coef z^-1)`` truncated to a ``taps``-tap FIR, built by
    recursive doubling exactly as the JAX package's ``deemphasis_jax``:

        1/(1 - a z^-1)  ~  prod_{k<log2(taps)} (1 + a^(2^k) z^-(2^k))

    whose expansion is sum_{j<taps} a^j z^-j. log2(taps) shift-and-add
    passes; coef^512 < 2e-7 at coef 0.97, so it matches scipy ``lfilter``
    to ~1e-6 of the signal scale. Causal, so a zero-padded tail does not
    change the kept prefix."""
    if taps & (taps - 1):
        raise ValueError(f"taps={taps}: must be a power of two")
    out = y
    shift = 1
    while shift < taps:
        a_k = float(np.float32(np.float64(coef) ** shift))
        out = out + a_k * F.pad(out, (shift, 0))[..., : out.shape[-1]]
        shift *= 2
    return out
