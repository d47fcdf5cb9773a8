"""Griffin-Lim vocoder: normalized mel -> waveform.

Chain: denormalize dB -> amplitude 10^(x*0.05) -> mel->linear regularized
pseudo-inverse -> 100 iterations of ISTFT/STFT phase projection ->
de-preemphasis -> trim. ``griffin_lim(method=...)`` selects the exact
``torch.fft`` loop or the fused CUDA kernel's hybrid schedule
(kernels/griffin_lim.py); the JAX package calls the latter "pallas", and
both names select it here (``GL_METHODS``).

``melspectrogram2wav`` is the vocoder on tensors. The numpy oracle (complex128
iterations on the host, a copy of the JAX package's ``melspectrogram2wav``)
takes the ``_np`` suffix: ``mel_to_mag_np``, ``griffin_lim_np``,
``melspectrogram2wav_np``. It is what ``Inferencer(gpu_vocoder=False)`` and
``cli/inference.py --cpu_vocoder`` vocode with.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.config import SignalConfig
from ..utils.profiling import span
from .audio import deemphasis, deemphasis_torch, trim_bounds, trim_silence
from .mel import mel_to_linear_matrix
from .stft import (
    istft,
    istft_env_inv_masked,
    istft_masked,
    istft_np,
    stft,
    stft_masked,
    stft_mirror_index,
    stft_np,
)

DEFAULT_SIGNAL = SignalConfig()
# "pallas" is the JAX package's name for the fused kernel's schedule
GL_METHODS = ("exact", "fused", "pallas")


def _fused(method: str) -> bool:
    if method not in GL_METHODS:
        raise ValueError(f"method={method!r}: expected one of {GL_METHODS}")
    return method != "exact"


def mel_to_mag_np(mel_tm: np.ndarray, cfg: SignalConfig = DEFAULT_SIGNAL) -> np.ndarray:
    """Normalized mel (T, n_mels) -> linear magnitude (n_freq, T), numpy."""
    mel = mel_tm.T
    mel = (np.clip(mel, 0.0, 1.0) * cfg.max_db) - cfg.max_db + cfg.ref_db
    mel = np.power(10.0, mel * 0.05)
    m = mel_to_linear_matrix(cfg.sr, cfg.n_fft, cfg.n_mels)
    return np.dot(m, mel)


def griffin_lim_np(
    mag: np.ndarray, cfg: SignalConfig = DEFAULT_SIGNAL, n_iter: Optional[int] = None
) -> np.ndarray:
    """Magnitude (n_freq, T) -> waveform, complex128 phase projection on the
    host (the exact iteration in numpy)."""
    n_iter = cfg.n_iter if n_iter is None else n_iter
    X = mag.astype(np.complex128)
    for _ in range(n_iter):
        x_t = istft_np(X, cfg.n_fft, cfg.hop_length, cfg.win_length)
        est = stft_np(x_t, cfg.n_fft, cfg.hop_length, cfg.win_length)
        phase = est / np.maximum(1e-8, np.abs(est))
        X = mag * phase[: mag.shape[0], : mag.shape[1]]
    return np.real(istft_np(X, cfg.n_fft, cfg.hop_length, cfg.win_length)).astype(
        np.float32
    )


def melspectrogram2wav_np(
    mel_tm: np.ndarray, cfg: SignalConfig = DEFAULT_SIGNAL
) -> np.ndarray:
    """The numpy vocoder: normalized mel (T, n_mels) -> trimmed wav, all on
    the host with ``cfg.n_iter`` exact iterations."""
    mag = mel_to_mag_np(mel_tm, cfg)
    wav = griffin_lim_np(mag, cfg)
    wav = deemphasis(wav, cfg.preemphasis)
    wav, _ = trim_silence(wav, top_db=60.0)
    return wav.astype(np.float32)


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
    tensor it runs the kernel's plain PyTorch version); "pallas" is an
    alias of "fused"."""
    n_iter = cfg.n_iter if n_iter is None else n_iter
    if _fused(method):
        from ..kernels.griffin_lim import griffin_lim_fused

        return griffin_lim_fused(mag, cfg, n_iter=n_iter)
    return _griffin_lim_core(mag, cfg.n_fft, cfg.hop_length, cfg.win_length, n_iter)


def _masked_projection(mag: torch.Tensor, frame_lengths: torch.Tensor, cfg: SignalConfig):
    """What both ragged Griffin-Lim cores share: the magnitude zeroed at
    frames >= L_b, one exact iteration X -> X', and the final synthesis,
    with the per-sample envelope and mirror index built once."""
    n_fft, hop, win = cfg.n_fft, cfg.hop_length, cfg.win_length
    n_frames = mag.shape[-1]
    fmask = torch.arange(n_frames, device=mag.device)[None, None, :] < frame_lengths[:, None, None]
    mag = mag * fmask.to(mag.dtype)
    env_inv = istft_env_inv_masked(frame_lengths, n_frames, n_fft, hop, win)
    mirror = stft_mirror_index(frame_lengths, hop * (n_frames - 1), n_fft, hop)

    def synthesize(X: torch.Tensor) -> torch.Tensor:
        return istft_masked(X, env_inv, n_fft, hop, win)

    def exact_iteration(X: torch.Tensor) -> torch.Tensor:
        est = stft_masked(synthesize(X), frame_lengths, n_fft, hop, win, mirror)
        phase = est / torch.clamp(est.abs(), min=1e-8)
        return (mag * phase).to(torch.complex64)

    return mag, exact_iteration, synthesize


def _griffin_lim_core_masked(
    mag: torch.Tensor, frame_lengths: torch.Tensor, cfg: SignalConfig, n_iter: int
) -> torch.Tensor:
    """Ragged-batch Griffin-Lim: mag (B, n_freq, T) with per-sample valid
    frame counts L_b. For every sample the first hop*(L_b - 1) output
    samples are ``griffin_lim`` on mag[b, :, :L_b] alone.

    Three ingredients (dsp/stft.py): zero magnitude at frames >= L_b (their
    phase does not matter: the magnitude replacement zeroes them again in
    every iteration), a masked window-sum envelope in the ISTFT, and
    per-sample reflect boundaries for the STFT's edge frames.
    """
    mag, exact_iteration, synthesize = _masked_projection(mag, frame_lengths, cfg)
    X = mag.to(torch.complex64)
    for _ in range(n_iter):
        X = exact_iteration(X)
    return synthesize(X).float()


def _griffin_lim_core_masked_fast(
    mag: torch.Tensor, frame_lengths: torch.Tensor, cfg: SignalConfig,
    n_iter: int, warm_start: int, polish_iters: int,
) -> torch.Tensor:
    """Ragged-batch fast Griffin-Lim: masked exact warm start, the fused
    kernel for the bulk of the iterations, masked exact polish.

    The kernel runs on the zero-masked padded batch as it is, with no
    reflect extension of the magnitude: zero-magnitude pad frames stay zero
    through its magnitude projection, so each sample's end sees the
    kernel's interior-band approximation, and the masked exact iterations
    before and after it (per-sample reflection, masked envelope) supply
    the true edge behaviour.
    """
    from ..kernels.griffin_lim import griffin_lim_phases_segmented

    mag, exact_iteration, synthesize = _masked_projection(mag, frame_lengths, cfg)
    warm = min(warm_start, n_iter)
    polish = min(polish_iters, n_iter - warm)
    X = mag.to(torch.complex64)
    for _ in range(warm):
        X = exact_iteration(X)
    kern_iters = n_iter - warm - polish
    if kern_iters > 0:
        X = griffin_lim_phases_segmented(mag, cfg, n_iter=kern_iters, init_spec=X)
    for _ in range(polish):
        X = exact_iteration(X)
    return synthesize(X).float()


def griffin_lim_masked(
    mag: torch.Tensor,
    frame_lengths,
    cfg: SignalConfig = DEFAULT_SIGNAL,
    n_iter: Optional[int] = None,
    method: str = "exact",
) -> torch.Tensor:
    """Batched ragged Griffin-Lim: mag (B, n_freq, T), frame_lengths (B,)
    -> wav (B, hop*(T-1)); sample b is valid up to hop*(L_b - 1).

    ``method="exact"``: per-sample-exact iterations only (equal to
    ``griffin_lim`` on each sample, see ``_griffin_lim_core_masked``).
    ``method="fused"`` (or its alias "pallas"): the fused kernel between 4
    masked exact warm-start iterations and 2 of polish
    (``_griffin_lim_core_masked_fast``), the fast serving mode for
    mixed-length grids.
    """
    n_iter = cfg.n_iter if n_iter is None else n_iter
    lens = torch.as_tensor(frame_lengths, dtype=torch.int64, device=mag.device)
    if _fused(method):
        return _griffin_lim_core_masked_fast(mag, lens, cfg, n_iter, 4, 2)
    return _griffin_lim_core_masked(mag, lens, cfg, n_iter)


def melspectrogram2wav(
    mel_tm: torch.Tensor, cfg: SignalConfig = DEFAULT_SIGNAL,
    gl_method: str = "exact",
) -> np.ndarray:
    """Vocoder on the tensor's device: Griffin-Lim and de-preemphasis there,
    and, for a single utterance, the trim's bounds (``to_host_trimmed``);
    one copy to the host."""
    with span("infer.vocode"):
        mag = mel_to_mag(mel_tm, cfg)
        wav = deemphasis_torch(griffin_lim(mag, cfg, method=gl_method), cfg.preemphasis)
    if wav.ndim == 1:
        return to_host_trimmed(wav[None], None)[0]
    with span("infer.to_host"):
        wav = wav.cpu().numpy()
    return wav.astype(np.float32)


def to_host_trimmed(wavs: torch.Tensor, valid_lens: Optional[torch.Tensor]) -> List[np.ndarray]:
    """Served wavs (B, N) on their device, each cropped to ``valid_lens[k]``
    (whole where None) -> the host's float32 wavs, silence-trimmed at 60 dB
    as every served wav is: the bounds of every row in one batched pass
    where the wavs are (``trim_bounds``), one copy of the wavs and the
    bounds, the host's slices."""
    bounds = trim_bounds(wavs, valid_lens, top_db=60.0)
    with span("infer.to_host"):
        host, bounds = wavs.cpu().numpy(), bounds.tolist()
    with span("dsp.trim"):
        return [host[k, s:e].astype(np.float32, copy=False) for k, (s, e) in enumerate(bounds)]
