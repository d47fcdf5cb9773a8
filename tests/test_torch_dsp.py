"""Port DSP (adaptive_voice_conversion_tpu_torch.dsp) against the JAX
package's DSP on the same seeded numpy signals, at the tolerances of
tests/test_dsp.py: STFT/ISTFT 2e-3, mel 1e-4, the exact Griffin-Lim within
0.02 of SC (spectral convergence) at 100 iterations, de-preemphasis 1e-6."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptive_voice_conversion_tpu.core.config import SignalConfig as JSignal
from adaptive_voice_conversion_tpu.dsp import audio as jaudio
from adaptive_voice_conversion_tpu.dsp import features as jfeat
from adaptive_voice_conversion_tpu.dsp import mel as jmel
from adaptive_voice_conversion_tpu.dsp import stft as jstft
from adaptive_voice_conversion_tpu.dsp import vocoder as jvoc
from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig
from adaptive_voice_conversion_tpu_torch.dsp import audio, features, mel, stft, vocoder

SR = 24000
SMALL = dict(sr=8000, n_fft=256, hop_length=64, win_length=192, n_mels=40, n_iter=8)
FULL = SignalConfig()


def sine_speechish(n, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = (
        0.5 * np.sin(2 * np.pi * 220 * t)
        + 0.25 * np.sin(2 * np.pi * 440 * t + 0.3)
        + 0.05 * rng.standard_normal(n)
    )
    env = np.clip(np.sin(np.pi * np.arange(n) / n), 0, 1)
    return (y * env).astype(np.float32)


def full_cfg_wave(n=12000):
    rng = np.random.default_rng(0)
    t = np.arange(n) / FULL.sr
    y = (
        0.4 * np.sin(2 * np.pi * 180 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
        + 0.2 * np.sin(2 * np.pi * 460 * t)
        + 0.01 * rng.standard_normal(n)
    )
    return y.astype(np.float32)


def sc(mag, wav, cfg):
    est = np.abs(stft.stft_np(np.asarray(wav), cfg.n_fft, cfg.hop_length, cfg.win_length))
    t = min(est.shape[1], mag.shape[1])
    return float(np.linalg.norm(est[:, :t] - mag[:, :t]) / (np.linalg.norm(mag[:, :t]) + 1e-9))


def test_numpy_copies_equal_jax():
    """The numpy helpers the port keeps its own copies of."""
    np.testing.assert_array_equal(mel.mel_filterbank(SR, 2048, 512), jmel.mel_filterbank(SR, 2048, 512))
    np.testing.assert_array_equal(
        mel.mel_to_linear_matrix(SR, 2048, 512), jmel.mel_to_linear_matrix(SR, 2048, 512)
    )
    np.testing.assert_array_equal(stft.hann_window(1200, 2048), jstft.hann_window(1200, 2048))
    assert stft.frame_count(12345, 2048, 300) == jstft.frame_count(12345, 2048, 300)
    y = sine_speechish(4096, 8000)
    S = stft.stft_np(y, 256, 64, 192)
    np.testing.assert_array_equal(S, jstft.stft_np(y, 256, 64, 192))
    np.testing.assert_array_equal(stft.istft_np(S, 256, 64, 192), jstft.istft_np(S, 256, 64, 192))
    np.testing.assert_array_equal(audio.preemphasis(y, 0.97), jaudio.preemphasis(y, 0.97))
    np.testing.assert_array_equal(audio.deemphasis(y, 0.97), jaudio.deemphasis(y, 0.97))
    padded = np.concatenate([np.zeros(4000, np.float32), y, np.zeros(4000, np.float32)])
    ours, span = audio.trim_silence(padded, top_db=30)
    ref, ref_span = jaudio.trim_silence(padded, top_db=30)
    assert span == ref_span
    np.testing.assert_array_equal(ours, ref)


def test_stft_matches_jax_and_np():
    y = sine_speechish(4096, 8000)
    ours = stft.stft(torch.from_numpy(y), 256, 64, 192).numpy()
    ref = np.asarray(jstft.stft_jax(jnp.asarray(y), 256, 64, 192))
    S_np = jstft.stft_np(y, 256, 64, 192)
    assert ours.shape == ref.shape == S_np.shape
    for other in (ref, S_np):
        np.testing.assert_allclose(ours.real, other.real, atol=2e-3)
        np.testing.assert_allclose(ours.imag, other.imag, atol=2e-3)


def test_istft_matches_jax_and_np():
    y = sine_speechish(4096, 8000)
    S = jstft.stft_np(y, 256, 64, 192)
    ours = stft.istft(torch.from_numpy(S), 256, 64, 192).numpy()
    ref = np.asarray(jstft.istft_jax(jnp.asarray(S), 256, 64, 192))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-3)
    np.testing.assert_allclose(ours, jstft.istft_np(S, 256, 64, 192), atol=2e-3)


def test_stft_istft_batched_full_config():
    y = np.stack([full_cfg_wave(6000 + 300 * s)[:6000] for s in range(3)])
    ours = stft.stft(torch.from_numpy(y), 2048, 300, 1200)
    ref = np.asarray(jstft.stft_jax(jnp.asarray(y), 2048, 300, 1200))
    np.testing.assert_allclose(ours.numpy().real, ref.real, atol=2e-3)
    back = stft.istft(ours, 2048, 300, 1200).numpy()
    ref_back = np.asarray(jstft.istft_jax(jnp.asarray(ref), 2048, 300, 1200))
    np.testing.assert_allclose(back, ref_back, atol=2e-3)


def test_featurizer_matches_jax(tmp_path):
    y = jaudio.preemphasis(sine_speechish(4096, 8000), 0.97)
    cfg, jcfg = SignalConfig(**SMALL), JSignal(**SMALL)
    mel_t, mag_t = features.mel_from_wave(y, cfg)
    mel_j, mag_j = jfeat.mel_from_wave_jax(jnp.asarray(y), jcfg)
    np.testing.assert_allclose(mel_t, np.asarray(mel_j), atol=1e-4)
    np.testing.assert_allclose(mag_t, np.asarray(mag_j), atol=1e-4)
    p = str(tmp_path / "u.wav")
    jaudio.save_wav(p, sine_speechish(SR, SR), SR)
    ours = features.get_spectrograms(p)
    ref = jfeat.get_spectrograms(p)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_mel_to_mag_matches_jax():
    rng = np.random.default_rng(1)
    m = rng.uniform(0, 1, (2, 30, 512)).astype(np.float32)
    ours = vocoder.mel_to_mag(torch.from_numpy(m), FULL).numpy()
    ref = np.asarray(jvoc.mel_to_mag_jax(jnp.asarray(m), JSignal()))
    assert ours.shape == ref.shape == (2, 1025, 30)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def test_deemphasis_matches_jax():
    """The 512-tap recursive-doubling FIR, batched, causal under padding."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal(24000).astype(np.float32) * 0.3
    yb = np.stack([y, np.pad(y[:20000], (0, 4000))])
    ours = audio.deemphasis_torch(torch.from_numpy(yb), 0.97).numpy()
    ref = np.asarray(jaudio.deemphasis_jax(yb, 0.97))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours[1][:20000], ours[0][:20000], rtol=0, atol=1e-6)
    lf = jaudio.deemphasis(y, 0.97)
    assert np.abs(ours[0] - lf).max() < 2e-5 * np.abs(lf).max()


def test_exact_griffin_lim_matches_jax_full_config():
    """The exact torch.fft loop against griffin_lim_jax at 100 iterations of
    the full signal config: both meet the pinned SC bound and agree to 0.02."""
    y = full_cfg_wave()
    mag = np.abs(jstft.stft_np(y, 2048, 300, 1200)).astype(np.float32)
    ours = vocoder.griffin_lim(torch.from_numpy(mag), FULL).numpy()
    ref = np.asarray(jvoc.griffin_lim_jax(jnp.asarray(mag), JSignal()))
    assert ours.shape == ref.shape
    sc_t, sc_j = sc(mag, ours, FULL), sc(mag, ref, FULL)
    assert sc_t < 0.08
    assert abs(sc_t - sc_j) < 0.02, (sc_t, sc_j)


def test_griffin_lim_batched_rows_match_single():
    cfg = SignalConfig(**SMALL)
    mags = np.stack([
        np.abs(jstft.stft_np(sine_speechish(2048, 8000, s), 256, 64, 192)) for s in range(2)
    ]).astype(np.float32)
    batched = vocoder.griffin_lim(torch.from_numpy(mags), cfg, n_iter=3).numpy()
    for i in range(2):
        single = vocoder.griffin_lim(torch.from_numpy(mags[i]), cfg, n_iter=3).numpy()
        np.testing.assert_allclose(batched[i], single, atol=1e-4)


@pytest.mark.parametrize("gl_method", ["exact", "fused"])
def test_melspectrogram2wav_matches_jax(gl_method):
    """The vocoder chain (mel -> magnitude -> Griffin-Lim -> de-preemphasis
    -> trim) against melspectrogram2wav_jax ("fused" against "pallas", the
    Pallas kernel in interpret mode), 12 iterations, full signal config."""
    y = jaudio.preemphasis(full_cfg_wave(), 0.97)
    m, _ = jfeat.mel_from_wave(y, JSignal())
    cfg, jcfg = SignalConfig(n_iter=12), JSignal(n_iter=12)
    ours = vocoder.melspectrogram2wav(torch.from_numpy(m), cfg, gl_method=gl_method)
    ref = jvoc.melspectrogram2wav_jax(
        jnp.asarray(m), jcfg, gl_method="pallas" if gl_method == "fused" else "exact"
    )
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    assert abs(len(ours) - len(ref)) <= 512  # trim works on 512-sample frames
    mag = np.asarray(jvoc.mel_to_mag(m, jcfg)).astype(np.float32)
    assert abs(sc(mag, ours, FULL) - sc(mag, ref, FULL)) < 0.02
