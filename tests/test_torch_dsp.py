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


def speech_rows(lens, width, seed, head=0, tail=0, tail_fill=0.0):
    """Rows of ``width`` samples: a voiced stretch with a slow envelope in
    each row's first ``lens[k]`` samples, with ``head`` and ``tail`` samples
    of near-silence at its ends, and ``tail_fill`` times noise past it."""
    rng = np.random.default_rng(seed)
    rows = tail_fill * rng.standard_normal((len(lens), width))
    for k, n in enumerate(lens):
        t = np.arange(n) / SR
        f0 = 110 + 40 * k
        y = (0.4 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2.5 * t))
             + 0.1 * np.sin(2 * np.pi * 3.1 * f0 * t) + 0.01 * rng.standard_normal(n))
        quiet = 1e-5 * rng.standard_normal(n)
        voiced = np.zeros(n, bool)
        voiced[min(head, n):max(n - tail, 0)] = True
        rows[k, :n] = np.where(voiced, y, quiet)
    return rows.astype(np.float32)


def loud_last_partial_frame():
    """Its loudest frame is the last one, which the row's end cuts short."""
    rows = speech_rows([9000, 7433], 9600, 5) * 0.01
    rows[0, 8900:9000] = 0.9
    rows[1, 7300:7433] = -0.9
    return rows, [9000, 7433]


def with_a_silent_row():
    rows = speech_rows([8000, 6500, 9000], 9000, 6, head=2048, tail=1500)
    rows[1] = 0.0
    return rows, [8000, 6500, 9000]


TRIM_CASES = {
    "ragged": (lambda: (speech_rows([24000, 23999, 12345, 7000, 4097, 513], 24000, 1),
                        [24000, 23999, 12345, 7000, 4097, 513]), 60.0),
    "garbage_past_the_lengths": (lambda: (speech_rows([20000, 15001, 9999], 24000, 2, head=2500,
                                                      tail=3100, tail_fill=0.8),
                                          [20000, 15001, 9999]), 60.0),
    "silent_ends_60db": (lambda: (speech_rows([24000, 17777, 11000], 24000, 3, head=4000, tail=5123),
                                  [24000, 17777, 11000]), 60.0),
    "silent_ends_15db": (lambda: (speech_rows([24000, 17777, 11000], 24000, 3, head=4000, tail=5123),
                                  [24000, 17777, 11000]), 15.0),
    "an_all_zero_row": (with_a_silent_row, 60.0),
    "loudest_frame_last_and_partial": (loud_last_partial_frame, 60.0),
    "one_row": (lambda: (speech_rows([14321], 14321, 4, head=3000, tail=2000), None), 60.0),
    "no_frame_loud_enough": (lambda: (speech_rows([6000, 5000], 6000, 7), [6000, 5000]), 0.0),
}


@pytest.mark.parametrize("case", list(TRIM_CASES))
def test_card_trim_bounds_equal_the_host_trims(case):
    """``trim_bounds``, the batched tensor trim the serving path runs on the
    card, gives each row the (start, end) that the port's host
    ``trim_silence`` and the JAX package's give the row cropped to its
    length, exactly."""
    make, top_db = TRIM_CASES[case]
    rows, lens = make()
    lens_t = None if lens is None else torch.tensor(lens)
    got = audio.trim_bounds(torch.from_numpy(rows), lens_t, top_db)
    assert got.dtype == torch.int64 and got.shape == (len(rows), 2)
    for k, row in enumerate(rows):
        y = row if lens is None else row[: lens[k]]
        _, host = audio.trim_silence(y, top_db)
        _, jax_host = jaudio.trim_silence(y, top_db)
        assert tuple(got[k].tolist()) == host == jax_host, (k, got[k].tolist(), host)
    if case == "an_all_zero_row":
        assert got[1].tolist() == [0, lens[1]]
    if case == "no_frame_loud_enough":
        assert got.tolist() == [[0, 0], [0, 0]]
    if case == "silent_ends_60db":
        assert (got[:, 0] > 0).all() and (got[:, 1] < torch.tensor(lens)).all()


def test_card_trim_frame_means_are_numpys_bit_for_bit():
    """Each frame's mean square sums in numpy's pairwise order, so it equals
    the host's ``np.mean`` over the same frame bit for bit, not only in the
    bounds. (The square root after it is the device's own: correctly
    rounded on the card, within an ulp on this CPU build.)"""
    rows = speech_rows([24000, 12345], 24000, 8, tail_fill=0.3)
    n = rows.shape[1]
    for k, length in enumerate([24000, 12345]):
        y = torch.from_numpy(rows[k : k + 1]).double()
        y[:, length:] = 0.0
        sq = torch.nn.functional.pad(y * y, (1024, (n // 512 + 4) * 512 - 1024 - n))
        got = audio._pairwise_frame_sums(sq, 2048, 512)[0] / 2048
        yp = np.pad(rows[k, :length].astype(np.float64), 1024)
        nf = 1 + (len(yp) - 2048) // 512
        want = np.mean(yp[np.arange(2048)[None] + 512 * np.arange(nf)[:, None]] ** 2, axis=1)
        np.testing.assert_array_equal(got[:nf].numpy(), want)
    with pytest.raises(ValueError):
        audio.trim_bounds(torch.from_numpy(rows), None, 60.0, frame_length=2048, hop_length=300)
