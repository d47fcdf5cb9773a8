"""The fused Griffin-Lim kernel's plain version and the hybrid schedule
(adaptive_voice_conversion_tpu_torch.kernels.griffin_lim) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

Tolerances, and why they differ by iteration count:
- one iteration seeded with the signal's own STFT phases: <= 1e-4 of
  max|mag|. Only the f32 summation order differs, plus the rare bf16
  rounding flip it causes at the kernel's two rounding points.
- five iterations from zero phase: relative Frobenius error <= 1e-2. From
  zero phase the first projections divide by |X2|, which nearly vanishes at
  some bins where the magnitude is large, so a last-bit difference in the
  f32 sums, or one bf16 flip of an operand, turns such a bin's phase by a
  visible angle; later iterations carry the difference on, so the bound
  grows with the count.
- the hybrid vocoder: SC within 0.01 of the JAX hybrid, and SC below the
  exact path's + 0.05 (tests/test_kernels.py).
The CUDA kernel itself runs only on the card: tests/test_torch_kernels_cuda.py
(marked ``cuda``, no JAX) and chip_smoke.py hold it against the plain
version there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptive_voice_conversion_tpu.core.config import SignalConfig as JSignal
from adaptive_voice_conversion_tpu.dsp.stft import stft_np
from adaptive_voice_conversion_tpu.dsp.vocoder import griffin_lim_jax
from adaptive_voice_conversion_tpu.kernels import griffin_lim as jgl
from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import griffin_lim
from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as tgl

CFG, JCFG = SignalConfig(), JSignal()


def spec_of(seconds, seed=0, f0=220.0, n_samples=None):
    rng = np.random.default_rng(seed)
    n = int(round(seconds * CFG.sr)) if n_samples is None else n_samples
    t = np.arange(n) / CFG.sr
    y = (
        0.5 * np.sin(2 * np.pi * f0 * t)
        + 0.3 * np.sin(2 * np.pi * 2 * f0 * t) * np.exp(-2 * t)
        + 0.05 * rng.standard_normal(len(t))
    ).astype(np.float32)
    return stft_np(y, CFG.n_fft, CFG.hop_length, CFG.win_length)


def spec_frames(n_frames, seed=0):
    spec = spec_of(0.0, seed, n_samples=CFG.hop_length * (n_frames - 1))
    assert spec.shape[1] == n_frames
    return spec


def sc(mag, wav):
    est = np.abs(stft_np(np.asarray(wav), CFG.n_fft, CFG.hop_length, CFG.win_length))
    f = min(est.shape[1], mag.shape[1])
    return float(np.linalg.norm(est[:, :f] - mag[:, :f]) / np.linalg.norm(mag[:, :f]))


def test_constants_and_segments_match_jax():
    ours = tgl._gl_constants(CFG.n_fft, CFG.win_length, CFG.hop_length)
    ref = jgl._gl_constants(JCFG.n_fft, JCFG.win_length, JCFG.hop_length)
    for a, b in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    assert ours[4:] == ref[4:] and ours[5] == 4
    assert (tgl.SEG_FRAMES, tgl.SEG_OVERLAP) == (jgl.SEG_FRAMES, jgl.SEG_OVERLAP)
    for t in (10, 384, 385, 500, 737, 768, 2000):
        assert tgl._segment_starts(t) == jgl._segment_starts(t)


@pytest.mark.parametrize("seconds", [0.5, 1.2])
def test_plain_one_iteration_matches_pallas(seconds):
    S = spec_of(seconds)[None]
    mag = np.abs(S).astype(np.float32)
    ref = np.asarray(jgl.griffin_lim_phases_pallas(
        jnp.asarray(mag), JCFG, n_iter=1, interpret=True, init_spec=jnp.asarray(S)
    ))
    ours = tgl.griffin_lim_phases_plain(
        torch.from_numpy(mag), CFG, n_iter=1, init_spec=torch.from_numpy(S)
    ).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-4 * mag.max()


def test_plain_five_iterations_match_pallas_stacked():
    """Two utterances of different lengths padded to one T: JAX runs one
    grid program per utterance, the port stacks them along the rows, so
    this also holds the band's block mask against the grid boundary."""
    mags = np.stack([
        np.abs(spec_frames(61, seed=0)), np.abs(spec_frames(61, seed=1)) * 0.5
    ]).astype(np.float32)
    mags[1, :, 50:] = 0.0  # a shorter second utterance
    ref = np.asarray(jgl.griffin_lim_phases_pallas(jnp.asarray(mags), JCFG, n_iter=5, interpret=True))
    ours = tgl.griffin_lim_phases_plain(torch.from_numpy(mags), CFG, n_iter=5).numpy()
    for b in range(2):
        err = np.linalg.norm(ours[b] - ref[b]) / np.linalg.norm(ref[b])
        assert err <= 1e-2, (b, err)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    mag = torch.from_numpy(np.abs(spec_frames(20))[None].astype(np.float32))
    before = tgl.griffin_lim_phases.launches
    a = tgl.griffin_lim_phases(mag, CFG, n_iter=2)
    b = tgl.griffin_lim_phases_plain(mag, CFG, n_iter=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tgl.griffin_lim_phases.launches == before
    # zero iterations return the seed spectrum unchanged
    init = torch.from_numpy(spec_frames(20)[None])
    torch.testing.assert_close(tgl.griffin_lim_phases(mag, CFG, 0, init), init)


@pytest.mark.parametrize(
    "n_frames,n_iter,kw",
    [
        (57, 30, {}),
        (424, 8, {}),  # > 384 frames: two stacked segments, stitched
        (57, 12, dict(warm_start=2, polish_iters=2, ext_frames=4)),
        (57, 12, dict(warm_start=0, polish_iters=3, schedule="interleaved")),
        (57, 12, dict(warm_start=0, polish_iters=0, ext_frames=0)),
    ],
)
def test_fused_hybrid_matches_pallas_hybrid(n_frames, n_iter, kw):
    mag = np.abs(spec_frames(n_frames)).astype(np.float32)
    ref = np.asarray(jgl.griffin_lim_pallas(jnp.asarray(mag), JCFG, n_iter=n_iter, interpret=True, **kw))
    ours = tgl.griffin_lim_fused(torch.from_numpy(mag), CFG, n_iter=n_iter, **kw).numpy()
    assert ours.shape == ref.shape == (CFG.hop_length * (n_frames - 1),)
    assert np.isfinite(ours).all()
    sc_t, sc_j = sc(mag, ours), sc(mag, ref)
    assert abs(sc_t - sc_j) < 0.01, (sc_t, sc_j)
    sc_x = sc(mag, griffin_lim_jax(jnp.asarray(mag), JCFG, n_iter=n_iter))
    assert sc_t < sc_x + 0.05, (sc_t, sc_x)


def test_device_basis_is_the_plain_cs():
    """The wrapper hands the kernel the basis untiled: cs (s_pad, 2*f_pad)
    is [w*cos | -w*sin] of the constants rounded once to bf16, ck and g are
    the f32 constants, and every padded frequency column is zero (the
    kernel's tiling of cs lives in csrc/griffin_lim.cu alone)."""
    cos_m, sin_m, ck, g, _, n_taps = tgl._gl_constants(CFG.n_fft, CFG.win_length, CFG.hop_length)
    c = tgl._device_consts(CFG.n_fft, CFG.win_length, CFG.hop_length, torch.device("cpu"))
    assert (c.s_pad, c.f_pad, c.n_taps) == (1280, 1152, n_taps) and c.cs.dtype == torch.bfloat16
    want = torch.from_numpy(np.concatenate([cos_m, sin_m], axis=1)).to(torch.bfloat16)
    assert torch.equal(c.cs, want)
    assert torch.equal(c.ck, torch.from_numpy(ck)) and torch.equal(c.g, torch.from_numpy(g))
    n_freq = 1 + CFG.n_fft // 2
    for half in (0, c.f_pad):
        assert not c.cs[:, half + n_freq : half + c.f_pad].any()
    assert not c.ck[n_freq:].any()


def test_fused_batched_rows_identical():
    mag = np.abs(spec_frames(40)).astype(np.float32)
    w = griffin_lim(torch.from_numpy(np.stack([mag, mag])), CFG, n_iter=6, method="fused")
    torch.testing.assert_close(w[0], w[1], rtol=0, atol=1e-6)
