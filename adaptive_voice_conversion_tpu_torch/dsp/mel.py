"""Mel filterbank construction (librosa-compatible, self-contained).

The reference computes its filterbank with ``librosa.filters.mel(sr, n_fft,
n_mels)`` (reference: preprocess/tacotron/utils.py:72) using librosa's
defaults: Slaney mel scale (linear below 1 kHz, log above) and Slaney area
normalization. librosa is not a dependency here — the same math is
implemented directly, cached, and shared by the numpy and JAX paths.

The Griffin-Lim mel->linear pseudo-inverse reproduces
``_mel_to_linear_matrix`` (reference: preprocess/tacotron/utils.py:20-25).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_F_SP = 200.0 / 3.0  # Slaney: 66.667 Hz per mel below the break
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mel,
    )
    return mel


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)
    return f


@lru_cache(maxsize=8)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float = None
) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filterbank, Slaney scale + norm."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=8)
def mel_to_linear_matrix(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Regularized pseudo-inverse M^T diag(d), d_i = 1/sum_j (M M^T)_{ji}.

    Exactly the reference's ``_mel_to_linear_matrix``
    (preprocess/tacotron/utils.py:20-25). Shape (1 + n_fft//2, n_mels).
    """
    m = mel_filterbank(sr, n_fft, n_mels).astype(np.float64)
    p = m @ m.T
    col = p.sum(axis=0)
    d = np.where(np.abs(col) > 1.0e-8, 1.0 / np.where(col == 0, 1.0, col), col)
    return (m.T @ np.diag(d)).astype(np.float32)
