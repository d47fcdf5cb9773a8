"""The reference featurizer, numpy on the host: wave -> normalised mel.

The reference repository's ``preprocess/tacotron/utils.py``
``get_spectrograms`` after the load: ``librosa.effects.trim`` at
``top_db``, pre-emphasis, the STFT (periodic Hann of ``win_length``
centred in ``n_fft``, reflect padding), |.|, the Slaney mel filterbank with
area normalisation, 20 log10, and the clip to [1e-8, 1]. librosa is not
installed, so its functions are written out in float64 numpy. The mel
matrix's pseudo-inverse, ``mel_to_linear``, is the vocoder's first step.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=4)
def hann(win_length: int, n_fft: int) -> np.ndarray:
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    out = np.zeros(n_fft)
    lo = (n_fft - win_length) // 2
    out[lo : lo + win_length] = w
    return out


_F_SP = 200.0 / 3.0  # Slaney: Hz per mel below 1 kHz
_MIN_LOG_MEL = 1000.0 / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    log_mel = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / 1000.0) / _LOGSTEP
    return np.where(f >= 1000.0, log_mel, f / _F_SP)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL, 1000.0 * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), m * _F_SP)


@lru_cache(maxsize=4)
def mel_basis(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels): Slaney scale and norm, f32."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2 : n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


@lru_cache(maxsize=4)
def mel_to_linear(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """The reference's ``_mel_to_linear_matrix``: M^T diag(1 / colsum(M M^T))."""
    m = mel_basis(sr, n_fft, n_mels).astype(np.float64)
    col = (m @ m.T).sum(axis=0)
    d = np.where(np.abs(col) > 1e-8, 1.0 / np.where(col == 0, 1.0, col), col)
    return (m.T @ np.diag(d)).astype(np.float32)


def trim(y: np.ndarray, top_db: float, frame_length: int = 2048, hop_length: int = 512):
    """librosa.effects.trim: (trimmed, start, end)."""
    yp = np.pad(y.astype(np.float64), frame_length // 2)
    n = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n)[:, None]
    power = np.sqrt(np.mean(yp[idx] ** 2, axis=1)) ** 2  # librosa squares the RMS
    ref = power.max()
    if ref <= 0:
        return y, 0, len(y)
    loud = np.flatnonzero(10.0 * np.log10(np.maximum(power, 1e-20) / ref) > -top_db)
    if len(loud) == 0:
        return y[:0], 0, 0
    start = int(loud[0] * hop_length)
    end = min(len(y), int((loud[-1] + 1) * hop_length))
    return y[start:end], start, end


def stft_mag(y: np.ndarray, sig: dict) -> np.ndarray:
    """|STFT| (1 + n_fft//2, frames) of y, librosa's centred framing."""
    n_fft, hop = sig["n_fft"], sig["hop_length"]
    yp = np.pad(y.astype(np.float64), n_fft // 2, mode="reflect")
    n = 1 + (len(yp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    frames = yp[idx] * hann(sig["win_length"], n_fft)[None, :]
    return np.abs(np.fft.rfft(frames, axis=1).T.astype(np.complex64))


def featurize(y: np.ndarray, sig: dict, control: bool = False) -> np.ndarray:
    """Wave -> mel (T, n_mels) f32 in [1e-8, 1]: the STFT in float64 and
    rounded to complex64 (librosa's default), the mel product and the dB
    in float32, as the reference computes them. ``control=True`` takes the
    STFT in float32, the lower-precision control."""
    y, _, _ = trim(y, sig["top_db"])
    y = np.append(y[0], y[1:] - sig["preemphasis"] * y[:-1]).astype(y.dtype)
    if not control:
        mag = stft_mag(y, sig)
    else:
        n_fft, hop = sig["n_fft"], sig["hop_length"]
        yp = np.pad(y.astype(np.float32), n_fft // 2, mode="reflect")
        n = 1 + (len(yp) - n_fft) // hop
        idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
        frames = yp[idx] * hann(sig["win_length"], n_fft)[None, :].astype(np.float32)
        mag = np.abs(np.fft.rfft(frames, axis=1).T.astype(np.complex64))
    mel = mel_basis(sig["sr"], sig["n_fft"], sig["n_mels"]) @ mag
    mel = 20.0 * np.log10(np.maximum(1e-5, mel))
    mel = np.clip((mel - sig["ref_db"] + sig["max_db"]) / sig["max_db"], 1e-8, 1.0)
    return mel.T.astype(np.float32)
