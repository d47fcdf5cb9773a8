"""The reference vocoder and the measure a converted wav is judged by.

``mel_to_mag`` and ``griffin_lim`` are the reference repository's
``melspectrogram2wav`` before its de-emphasis: the dB mel back to
amplitude, the mel matrix's pseudo-inverse, then ``n_iter`` iterations of
ISTFT / STFT phase projection from zero phase (librosa's framing, here
``torch.stft`` / ``torch.istft``), in complex64 on the device.

``spectral_convergence`` judges a wav by what it says: the wav with its
de-emphasis undone is framed again, and its magnitude is held against the
reference's magnitude, ||(|STFT(w)| - M)|| / ||M||. A wav that the program
trimmed (librosa's trim at 60 dB, 512-sample hops) is placed back at the
start among the trim's possible offsets that fits best, with silence
around it.

``griffin_lim(..., int8=True)`` is the lower-precision control: the
spectrum and the signal rounded to int8 (symmetric, one scale a tensor) in
every iteration, the step below the bf16 products of the program's kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .featurize import mel_to_linear


def mel_to_mag(mel: torch.Tensor, sig: dict) -> torch.Tensor:
    """Denormalised mel (T, n_mels) -> linear magnitude (1 + n_fft//2, T)."""
    db = torch.clamp(mel.t().float(), 0.0, 1.0) * sig["max_db"] - sig["max_db"] + sig["ref_db"]
    m = torch.from_numpy(mel_to_linear(sig["sr"], sig["n_fft"], sig["n_mels"])).to(mel.device)
    return m @ torch.pow(10.0, db * 0.05)


def _window(sig: dict, device) -> torch.Tensor:
    return torch.hann_window(sig["win_length"], periodic=True, dtype=torch.float32, device=device)


def stft(y: torch.Tensor, sig: dict) -> torch.Tensor:
    return torch.stft(y, sig["n_fft"], sig["hop_length"], sig["win_length"],
                      window=_window(sig, y.device), center=True, pad_mode="reflect",
                      return_complex=True)


def istft(X: torch.Tensor, sig: dict) -> torch.Tensor:
    return torch.istft(X, sig["n_fft"], sig["hop_length"], sig["win_length"],
                       window=_window(sig, X.device), center=True,
                       length=sig["hop_length"] * (X.shape[-1] - 1))


def _int8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


def griffin_lim(mag: torch.Tensor, sig: dict, n_iter: int, int8: bool = False) -> torch.Tensor:
    """Magnitude (1 + n_fft//2, T) -> wav (hop * (T - 1),), before de-emphasis."""
    X = mag.to(torch.complex64)
    for _ in range(n_iter):
        if int8:
            X = torch.complex(_int8(X.real), _int8(X.imag))
        y = istft(X, sig)
        est = stft(_int8(y) if int8 else y, sig)
        X = mag * (est / torch.clamp(est.abs(), min=1e-8))
    return istft(X, sig)


def deemphasis(y: np.ndarray, coef: float) -> np.ndarray:
    """The IIR 1 / (1 - coef z^-1), scipy's ``lfilter([1], [1, -coef])``."""
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coef], y).astype(np.float32)


def sc_signal(y: torch.Tensor, mag: torch.Tensor, sig: dict) -> float:
    """SC of a signal (before de-emphasis) of hop * (T - 1) samples against
    ``mag`` (1 + n_fft//2, T)."""
    return float((stft(y, sig).abs() - mag).norm() / mag.norm())


def spectral_convergence(wav: np.ndarray, mag: torch.Tensor, sig: dict, trim_hop: int = 512) -> float:
    """SC of a de-emphasised (and perhaps trimmed) wav against ``mag``
    (1 + n_fft//2, T), over the T frames of a hop * (T - 1) signal; inf
    when the wav is longer than that or not finite."""
    n0 = sig["hop_length"] * (mag.shape[1] - 1)
    w = np.asarray(wav, np.float64)
    if len(w) > n0 or not np.isfinite(w).all() or len(w) == 0:
        return float("inf")
    e = np.empty_like(w)
    e[0] = w[0]
    e[1:] = w[1:] - sig["preemphasis"] * w[:-1]
    best = float("inf")
    for s in range(0, n0 - len(w) + 1, trim_hop):
        full = torch.zeros(n0, dtype=torch.float32, device=mag.device)
        full[s : s + len(e)] = torch.from_numpy(e.astype(np.float32)).to(mag.device)
        best = min(best, sc_signal(full, mag, sig))
    return best
