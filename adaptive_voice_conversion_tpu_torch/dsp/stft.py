"""STFT / ISTFT: the numpy oracle (copied) and a torch version on tensors.

librosa's conventions, as the reference featurizer and Griffin-Lim use them:
- periodic Hann window of ``win_length``, zero-padded centered to ``n_fft``
- center=True: the signal is reflect-padded by n_fft//2 on both sides
- ISTFT applies the window again and normalizes by the window-sum-squares

The torch version frames with ``unfold`` and overlap-adds with ``fold``;
the JAX package's slice-and-concat framing only avoided a TPU gather cost.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=8)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of ``win_length`` zero-padded centered to ``n_fft``."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad : lpad + win_length] = w
    return out


def frame_count(n_samples: int, n_fft: int, hop_length: int) -> int:
    """Number of STFT frames with center=True padding."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop_length


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------


def stft_np(
    y: np.ndarray, n_fft: int, hop_length: int, win_length: int
) -> np.ndarray:
    """(n_samples,) -> complex (1 + n_fft//2, n_frames), librosa layout."""
    w = hann_window(win_length, n_fft)
    pad = n_fft // 2
    yp = np.pad(y.astype(np.float64), pad, mode="reflect")
    n_frames = 1 + (len(yp) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = yp[idx] * w[None, :]
    return np.fft.rfft(frames, axis=1).T.astype(np.complex64)


def istft_np(
    S: np.ndarray, n_fft: int, hop_length: int, win_length: int
) -> np.ndarray:
    """complex (1 + n_fft//2, n_frames) -> (hop * (n_frames - 1),)."""
    w = hann_window(win_length, n_fft)
    n_frames = S.shape[1]
    frames = np.fft.irfft(S.T.astype(np.complex128), n=n_fft, axis=1) * w[None, :]
    total = n_fft + hop_length * (n_frames - 1)
    out = np.zeros(total, dtype=np.float64)
    wss = np.zeros(total, dtype=np.float64)
    for t in range(n_frames):
        s = t * hop_length
        out[s : s + n_fft] += frames[t]
        wss[s : s + n_fft] += w**2
    nz = wss > np.finfo(np.float64).tiny
    out[nz] /= wss[nz]
    pad = n_fft // 2
    return out[pad:-pad].astype(np.float32) if pad else out.astype(np.float32)


# ---------------------------------------------------------------------------
# torch (leading batch dims allowed)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _window(win_length: int, n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(
        hann_window(win_length, n_fft), dtype=torch.float32, device=device
    )


@lru_cache(maxsize=8)
def _wss_inv(
    n_frames: int, n_fft: int, hop_length: int, win_length: int,
    device: torch.device,
) -> torch.Tensor:
    """Inverse window-sum-squares of the overlap-add (1 where it is 0)."""
    w = hann_window(win_length, n_fft)
    total = n_fft + hop_length * (n_frames - 1)
    wss = np.zeros(total, dtype=np.float64)
    for t in range(n_frames):
        wss[t * hop_length : t * hop_length + n_fft] += w**2
    inv = np.where(
        wss > np.finfo(np.float64).tiny, 1.0 / np.where(wss == 0, 1, wss), 1.0
    )
    return torch.tensor(inv, dtype=torch.float32, device=device)


def stft(
    y: torch.Tensor, n_fft: int, hop_length: int, win_length: int
) -> torch.Tensor:
    """(..., n_samples) f32 -> complex64 (..., 1 + n_fft//2, n_frames)."""
    lead = y.shape[:-1]
    pad = n_fft // 2
    yp = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    frames = yp[:, 0].unfold(-1, n_fft, hop_length)  # (N, n_frames, n_fft)
    frames = frames * _window(win_length, n_fft, y.device)
    spec = torch.fft.rfft(frames, dim=-1).transpose(-1, -2)
    return spec.reshape(*lead, *spec.shape[-2:])


def istft(
    S: torch.Tensor, n_fft: int, hop_length: int, win_length: int
) -> torch.Tensor:
    """complex (..., 1 + n_fft//2, n_frames) -> f32 (..., hop*(n_frames-1))."""
    lead = S.shape[:-2]
    n_frames = S.shape[-1]
    frames = torch.fft.irfft(S.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * _window(win_length, n_fft, S.device)
    total = n_fft + hop_length * (n_frames - 1)
    out = F.fold(
        frames.reshape(-1, n_frames, n_fft).transpose(1, 2),
        output_size=(1, total),
        kernel_size=(1, n_fft),
        stride=(1, hop_length),
    ).reshape(*lead, total)
    out = out * _wss_inv(n_frames, n_fft, hop_length, win_length, S.device)
    pad = n_fft // 2
    return out[..., pad : total - pad]
