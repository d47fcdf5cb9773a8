"""The fused Griffin-Lim CUDA kernel on the card, against its plain PyTorch
version. Every test is marked ``cuda`` and skips without a card. The file
imports nothing of JAX, so that it runs where only the port is installed;
the tests directory's conftest imports JAX, so there run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances (see chip_smoke.py): one iteration seeded with the signal's own
STFT phases to 1e-3 of max|mag| per bin and 1e-3 relative Frobenius (f32
summation order, the projection's last ulp and the bf16 rounding flips
they cause); whole vocoder runs by spectral
convergence (SC) against the exact loop.
"""

import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig
from adaptive_voice_conversion_tpu_torch.dsp.stft import stft_np
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import griffin_lim
from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as tgl

CFG = SignalConfig()


def spec_frames(n_frames, seed=0, f0=220.0):
    rng = np.random.default_rng(seed)
    n = CFG.hop_length * (n_frames - 1)
    t = np.arange(n) / CFG.sr
    y = (
        0.5 * np.sin(2 * np.pi * f0 * t)
        + 0.3 * np.sin(2 * np.pi * 2 * f0 * t) * np.exp(-2 * t)
        + 0.05 * rng.standard_normal(n)
    ).astype(np.float32)
    return stft_np(y, CFG.n_fft, CFG.hop_length, CFG.win_length)


def sc(mag, wav):
    est = np.abs(stft_np(np.asarray(wav), CFG.n_fft, CFG.hop_length, CFG.win_length))
    f = min(est.shape[1], mag.shape[1])
    return float(np.linalg.norm(est[:, :f] - mag[:, :f]) / np.linalg.norm(mag[:, :f]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(card):
    """Stacked blocks (two utterances, 100 frames: t_pad 104, M = 208 rows,
    not a multiple of the 64-row tiles), one seeded iteration, and the
    launch counter."""
    S = np.stack([spec_frames(100, seed=0), spec_frames(100, seed=1)])
    mag = torch.from_numpy(np.abs(S).astype(np.float32)).to(card)
    init = torch.from_numpy(S).to(card)
    before = tgl.griffin_lim_phases.launches
    k = tgl.griffin_lim_phases(mag, CFG, n_iter=1, init_spec=init)
    p = tgl.griffin_lim_phases_plain(mag, CFG, n_iter=1, init_spec=init)
    torch.cuda.synchronize()
    assert tgl.griffin_lim_phases.launches == before + 1
    assert float((k - p).abs().max()) <= 1e-3 * float(mag.max())
    assert float(torch.linalg.norm(k - p) / torch.linalg.norm(p)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", [41, 500])  # one block; two 384-frame segments
def test_fused_vocoder_on_card_meets_sc_bound(card, n_frames):
    """The hybrid vocoder through the kernel converges as the JAX package
    requires of it: SC below the exact loop's + 0.05."""
    mag_np = np.abs(spec_frames(n_frames, seed=2)).astype(np.float32)
    mag = torch.from_numpy(mag_np).to(card)
    before = tgl.griffin_lim_phases.launches
    wav_k = griffin_lim(mag, CFG, method="fused").cpu().numpy()
    wav_x = griffin_lim(mag, CFG, method="exact").cpu().numpy()
    assert tgl.griffin_lim_phases.launches == before + 1
    assert wav_k.shape == wav_x.shape == (CFG.hop_length * (n_frames - 1),)
    assert np.isfinite(wav_k).all()
    assert sc(mag_np, wav_k) < sc(mag_np, wav_x) + 0.05


@pytest.mark.cuda
def test_kernel_rejects_a_hop_it_cannot_band(card):
    """gl_run refuses shapes its launches cannot take, and the wrapper
    raises instead of falling back."""
    cfg = SignalConfig(hop_length=302)  # the band kernel needs hop % 4 == 0
    mag = torch.ones(1, 1 + cfg.n_fft // 2, 20, device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        tgl.griffin_lim_phases(mag, cfg, n_iter=1)
