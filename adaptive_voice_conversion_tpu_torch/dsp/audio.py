"""Audio IO and time-domain utilities (librosa-free).

The numpy/scipy functions are the port's own copies of the JAX package's:
wav load with resampling, silence trim (librosa.effects.trim semantics),
pre-emphasis and de-preemphasis (scipy lfilter). ``deemphasis_torch`` is
the on-device de-preemphasis for tensors.
"""

from __future__ import annotations

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
