"""Mel featurizer: wav -> (mel, mag), host numpy as in the JAX package.

Chain: load -> trim(top_db 15) -> preemphasis .97 -> STFT(2048/300/1200)
-> |.| -> mel(512) -> 20*log10(max(1e-5, .)) -> clip((x - 20 + 100)/100,
1e-8, 1) -> transpose to (T, n_mels).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.config import SignalConfig
from .audio import load_wav, preemphasis, trim_silence
from .mel import mel_filterbank
from .stft import stft_np

DEFAULT_SIGNAL = SignalConfig()


def _to_db_norm(x: np.ndarray, cfg: SignalConfig) -> np.ndarray:
    x = 20.0 * np.log10(np.maximum(1e-5, x))
    return np.clip((x - cfg.ref_db + cfg.max_db) / cfg.max_db, 1e-8, 1.0)


def mel_from_wave(
    y: np.ndarray, cfg: SignalConfig = DEFAULT_SIGNAL
) -> Tuple[np.ndarray, np.ndarray]:
    """Trimmed-and-preemphasized wave -> (mel (T, n_mels), mag (T, n_freq))."""
    spec = stft_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length)
    mag = np.abs(spec)
    mel_basis = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels)
    mel = mel_basis @ mag
    mel = _to_db_norm(mel, cfg).T.astype(np.float32)
    mag = _to_db_norm(mag, cfg).T.astype(np.float32)
    return mel, mag


def get_spectrograms(
    fpath: str, cfg: SignalConfig = DEFAULT_SIGNAL
) -> Tuple[np.ndarray, np.ndarray]:
    """wav file -> (mel (T, n_mels), mag (T, n_freq)), normalized to [0, 1]."""
    y = load_wav(fpath, cfg.sr)
    y, _ = trim_silence(y, cfg.top_db)
    y = preemphasis(y, cfg.preemphasis)
    return mel_from_wave(y, cfg)
