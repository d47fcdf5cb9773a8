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
from typing import Optional

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
    pad = n_fft // 2
    yp = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    return stft_frames(yp.reshape(*y.shape[:-1], -1), n_fft, hop_length, win_length)


def stft_frames(
    yp: torch.Tensor, n_fft: int, hop_length: int, win_length: int
) -> torch.Tensor:
    """``stft`` of a signal that is already padded (center=False framing):
    (..., n_samples) -> complex64 (..., 1 + n_fft//2, 1 + (n_samples -
    n_fft) // hop)."""
    lead = yp.shape[:-1]
    frames = yp.reshape(-1, yp.shape[-1]).unfold(-1, n_fft, hop_length)
    frames = frames * _window(win_length, n_fft, yp.device)  # (N, n_frames, n_fft)
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
    out = _overlap_add(frames.reshape(-1, n_frames, n_fft), n_fft, hop_length)
    out = out.reshape(*lead, total)
    out = out * _wss_inv(n_frames, n_fft, hop_length, win_length, S.device)
    pad = n_fft // 2
    return out[..., pad : total - pad]


# ---------------------------------------------------------------------------
# Length-masked batched STFT / ISTFT, for ragged-batch Griffin-Lim
#
# A conversion grid vocodes B spectrograms of different frame counts L_b in
# one (B, n_freq, T) tensor. For each sample to equal the single-utterance
# path, two things change (dsp/vocoder.py griffin_lim_masked):
# - ISTFT: the window-sum-squares normalizer counts only the L_b real
#   frames (zero-magnitude pad frames add no signal, but the plain
#   normalizer would still count their window energy near the tail);
# - STFT: the center=True reflect padding reflects at the sample's own
#   signal end hop*(L_b - 1), not at the padded buffer's end. Only the
#   frames whose window crosses that end differ: the last
#   ``n_edge_frames`` valid frames.
# ---------------------------------------------------------------------------


def _overlap_add(frames: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(N, n_frames, n_fft) -> (N, n_fft + hop*(n_frames-1))."""
    n_frames = frames.shape[1]
    total = n_fft + hop_length * (n_frames - 1)
    return F.fold(
        frames.transpose(1, 2),
        output_size=(1, total),
        kernel_size=(1, n_fft),
        stride=(1, hop_length),
    ).reshape(frames.shape[0], total)


def istft_env_inv_masked(
    frame_lengths: torch.Tensor, n_frames: int, n_fft: int, hop_length: int,
    win_length: int,
) -> torch.Tensor:
    """Per-sample inverse window-sum-squares envelope for ``istft_masked``.

    frame_lengths: (B,) valid frame counts. Returns (B, total) f32 with
    total = n_fft + hop*(n_frames-1): 1 / sum_{i < L_b} w^2(t - i*hop) where
    that is positive, 1 elsewhere (the ragged counterpart of ``_wss_inv``).
    """
    dev = frame_lengths.device
    w2 = _window(win_length, n_fft, dev).square()
    mask = (torch.arange(n_frames, device=dev)[None, :] < frame_lengths[:, None]).float()
    wss = _overlap_add(mask[:, :, None] * w2, n_fft, hop_length)
    tiny = float(np.finfo(np.float32).tiny)
    return torch.where(wss > tiny, 1.0 / torch.where(wss == 0, 1.0, wss), 1.0)


def istft_masked(
    S: torch.Tensor, env_inv: torch.Tensor, n_fft: int, hop_length: int,
    win_length: int,
) -> torch.Tensor:
    """``istft`` of (B, n_freq, n_frames) with a per-sample envelope (B, total).

    S must have zero magnitude at frames >= L_b (``griffin_lim_masked``
    keeps it so): the overlap-add is then already right per sample, and only
    the normalizer needs the masked envelope.
    """
    frames = torch.fft.irfft(S.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * _window(win_length, n_fft, S.device)
    out = _overlap_add(frames, n_fft, hop_length) * env_inv
    pad = n_fft // 2
    return out[..., pad : out.shape[-1] - pad]


def n_edge_frames(n_fft: int, hop_length: int) -> int:
    """Frames whose analysis window crosses the signal end: frame i spans
    samples [i*hop - pad, i*hop - pad + n_fft), which crosses
    N = hop*(L-1) iff i > L - 1 - (n_fft - pad)/hop."""
    pad = n_fft // 2
    return -(-(n_fft - pad) // hop_length)


def stft_mirror_index(
    frame_lengths: torch.Tensor, n_samples: int, n_fft: int, hop_length: int
) -> torch.Tensor:
    """The gather that mirrors each sample's tail in its signal, for
    ``stft_masked``: an index (B, n_samples + w), w = n_fft - n_fft//2,
    into the signal extended by w zeros, such that

        y'(q) = y(q)              for q < N_b = hop*(L_b - 1)
                y(2*N_b - 2 - q)  for N_b <= q < N_b + w
                0                 beyond (the index of the last, zero, sample)

    A valid frame's taps past N_b then read what the per-sample center=True
    reflection would supply, and valid frames read no tap beyond N_b + w.
    The extension by w keeps the mirror window of a sample near the longest
    inside the buffer. The index depends on the lengths alone, so
    Griffin-Lim builds it once per call, not once per iteration.

    Needs hop*(L_b - 1) >= w (L_b >= 5 frames at the shipped geometry); for
    shorter samples the mirror's source start is clamped at 0, which is
    finite and deterministic but approximate.
    """
    w = n_fft - n_fft // 2
    n_total = n_samples + w
    n_b = (hop_length * (frame_lengths - 1))[:, None]  # per-sample signal length
    q = torch.arange(n_total, device=frame_lengths.device)[None, :]
    src_start = (n_b - 1 - w).clamp(0, n_total - w)
    j = q - n_b.clamp(0, n_total - w)  # position inside the mirror window
    mirror = torch.where((j >= 0) & (j < w), src_start + w - 1 - j, n_total - 1)
    return torch.where(q < n_b, q, mirror)


def stft_masked(
    y: torch.Tensor, frame_lengths: torch.Tensor, n_fft: int, hop_length: int,
    win_length: int, mirror_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``stft`` of (B, n_samples) with the reflection at each sample's own
    end hop*(L_b - 1). Frames < L_b are the single-sample STFT of
    y[b, :hop*(L_b-1)]; frames >= L_b are garbage (the caller's magnitude
    multiply zeroes them). ``mirror_index`` is ``stft_mirror_index`` of
    these lengths, for callers that iterate."""
    n_samples = y.shape[-1]
    if mirror_index is None:
        mirror_index = stft_mirror_index(frame_lengths, n_samples, n_fft, hop_length)
    n_frames_out = frame_count(n_samples, n_fft, hop_length)
    y_ext = F.pad(y, (0, n_fft - n_fft // 2))
    y2 = torch.gather(y_ext, -1, mirror_index)
    return stft(y2, n_fft, hop_length, win_length)[..., :n_frames_out]
