"""Griffin-Lim vocoder on tensors: normalized mel -> waveform.

Chain: denormalize dB -> amplitude 10^(x*0.05) -> mel->linear regularized
pseudo-inverse -> 100 iterations of ISTFT/STFT phase projection ->
de-preemphasis -> trim. ``griffin_lim(method=...)`` selects the exact
``torch.fft`` loop or the fused CUDA kernel's hybrid schedule
(kernels/griffin_lim.py); the JAX package calls the latter "pallas".
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import SignalConfig
from .audio import deemphasis_torch, trim_silence
from .mel import mel_to_linear_matrix
from .stft import istft, stft

DEFAULT_SIGNAL = SignalConfig()


def mel_to_mag(mel_tm: torch.Tensor, cfg: SignalConfig = DEFAULT_SIGNAL) -> torch.Tensor:
    """Normalized mel (..., T, n_mels) -> magnitude (..., n_freq, T), f32."""
    mel = mel_tm.transpose(-1, -2).float()
    mel = (torch.clamp(mel, 0.0, 1.0) * cfg.max_db) - cfg.max_db + cfg.ref_db
    mel = torch.pow(10.0, mel * 0.05)
    m = torch.from_numpy(mel_to_linear_matrix(cfg.sr, cfg.n_fft, cfg.n_mels))
    return torch.matmul(m.to(mel.device), mel)


def _exact_iterations(
    mag: torch.Tensor, spec: torch.Tensor, n_fft: int, hop_length: int,
    win_length: int, n_iter: int,
) -> torch.Tensor:
    """``n_iter`` exact Griffin-Lim projections from the complex ``spec``."""
    X = spec.to(torch.complex64)
    for _ in range(n_iter):
        x_t = istft(X, n_fft, hop_length, win_length)
        est = stft(x_t, n_fft, hop_length, win_length)
        phase = est / torch.clamp(est.abs(), min=1e-8)
        X = (mag * phase).to(torch.complex64)
    return X


def _griffin_lim_core(
    mag: torch.Tensor, n_fft: int, hop_length: int, win_length: int, n_iter: int
) -> torch.Tensor:
    """mag: (..., n_freq, T) f32 -> wav (..., hop*(T-1)) f32, zero-phase start."""
    X = _exact_iterations(
        mag, mag.to(torch.complex64), n_fft, hop_length, win_length, n_iter
    )
    return istft(X, n_fft, hop_length, win_length).float()


def griffin_lim(
    mag: torch.Tensor,
    cfg: SignalConfig = DEFAULT_SIGNAL,
    n_iter: Optional[int] = None,
    method: str = "exact",
) -> torch.Tensor:
    """Batched Griffin-Lim. mag: (..., n_freq, T) -> wav (..., hop*(T-1)).

    ``method``: "exact" (the torch.fft loop) or "fused" (the CUDA kernel
    with the hybrid warm-start/reflect-extend/polish schedule; on a CPU
    tensor it runs the kernel's plain PyTorch version)."""
    n_iter = cfg.n_iter if n_iter is None else n_iter
    if method == "fused":
        from ..kernels.griffin_lim import griffin_lim_fused

        return griffin_lim_fused(mag, cfg, n_iter=n_iter)
    if method != "exact":
        raise ValueError(f"method={method!r}: expected 'exact' or 'fused'")
    return _griffin_lim_core(mag, cfg.n_fft, cfg.hop_length, cfg.win_length, n_iter)


def melspectrogram2wav(
    mel_tm: torch.Tensor, cfg: SignalConfig = DEFAULT_SIGNAL,
    gl_method: str = "exact",
) -> np.ndarray:
    """Vocoder on the tensor's device: Griffin-Lim and de-preemphasis there,
    one copy to the host, trim on the host (for a single utterance)."""
    mag = mel_to_mag(mel_tm, cfg)
    wav = deemphasis_torch(griffin_lim(mag, cfg, method=gl_method), cfg.preemphasis)
    wav = wav.cpu().numpy()
    if wav.ndim == 1:
        wav, _ = trim_silence(wav, top_db=60.0)
    return wav.astype(np.float32)
