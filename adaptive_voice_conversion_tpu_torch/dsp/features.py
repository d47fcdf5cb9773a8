"""Mel featurizer: wav -> (mel, mag).

Chain: load -> trim(top_db 15) -> preemphasis .97 -> STFT(2048/300/1200)
-> |.| -> mel(512) -> 20*log10(max(1e-5, .)) -> clip((x - 20 + 100)/100,
1e-8, 1) -> transpose to (T, n_mels).

``get_spectrograms`` / ``mel_from_wave`` are the host numpy featurizer, as
in the JAX package; ``mel_from_wave_batched`` is the same chain on tensors
with leading batch dims, the batched preprocessing path on the card
(tools/etl.py).
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Iterator, Tuple

import numpy as np
import torch

from ..core.config import SignalConfig
from ..utils.profiling import span
from .audio import load_wav, preemphasis, trim_silence
from .mel import mel_filterbank
from .stft import stft, stft_frames, stft_np

DEFAULT_SIGNAL = SignalConfig()


def _to_db_norm(x: np.ndarray, cfg: SignalConfig) -> np.ndarray:
    x = 20.0 * np.log10(np.maximum(1e-5, x))
    return np.clip((x - cfg.ref_db + cfg.max_db) / cfg.max_db, 1e-8, 1.0)


def mel_from_wave(
    y: np.ndarray, cfg: SignalConfig = DEFAULT_SIGNAL
) -> Tuple[np.ndarray, np.ndarray]:
    """Trimmed-and-preemphasized wave -> (mel (T, n_mels), mag (T, n_freq))."""
    with span("dsp.mel"):
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


@lru_cache(maxsize=8)
def _mel_basis(sr: int, n_fft: int, n_mels: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(device)


@contextlib.contextmanager
def _f32_matmuls() -> Iterator[None]:
    """f32 matmuls without TF32 inside the block, whatever an earlier call
    set (core/device.py ``set_precision``), and the switch put back after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _db_norm(x: torch.Tensor, cfg: SignalConfig) -> torch.Tensor:
    x = 20.0 * torch.log10(torch.clamp(x, min=1e-5))
    return torch.clamp((x - cfg.ref_db + cfg.max_db) / cfg.max_db, 1e-8, 1.0)


def mel_from_wave_batched(
    y: torch.Tensor, cfg: SignalConfig = DEFAULT_SIGNAL, centered: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trimmed-and-preemphasized waves (..., n_samples) f32 -> (mel (..., T,
    n_mels), mag (..., T, n_freq)) on the tensor's device: ``torch.fft`` STFT,
    one f32 product with the mel basis (TF32 off), the dB normalisation.

    ``centered=False`` takes waves that are already reflect-padded by
    n_fft//2 at their own ends (tools/etl.py pads each before it fills a
    bucket)."""
    frame = stft if centered else stft_frames
    mag = frame(y.float(), cfg.n_fft, cfg.hop_length, cfg.win_length).abs()
    basis = _mel_basis(cfg.sr, cfg.n_fft, cfg.n_mels, y.device)
    with _f32_matmuls():
        mel = torch.matmul(basis, mag)  # (..., n_mels, T)
    return _db_norm(mel, cfg).transpose(-1, -2), _db_norm(mag, cfg).transpose(-1, -2)
