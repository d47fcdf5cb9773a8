"""The port's DSP against the committed librosa golden fixture
``tests/golden/librosa_golden.npz``, at the tolerances tests/test_golden.py
holds the JAX package's DSP to: the Hann window 1e-10, the mel basis 1e-6,
the trim bounds exactly, the STFT magnitude 2e-4, the full chain 1e-4; and
the batched featurizer (dsp.features.mel_from_wave_batched, the ETL's
featurize_batch) on the same chain at 1e-4. Until these, the port's DSP was
held only against the JAX package."""

import os

import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig
from adaptive_voice_conversion_tpu_torch.dsp.audio import preemphasis, trim_silence
from adaptive_voice_conversion_tpu_torch.dsp.features import mel_from_wave, mel_from_wave_batched
from adaptive_voice_conversion_tpu_torch.dsp.mel import mel_filterbank
from adaptive_voice_conversion_tpu_torch.dsp.stft import hann_window, stft, stft_np
from adaptive_voice_conversion_tpu_torch.tools.etl import featurize_batch

CFG = SignalConfig()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "librosa_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def wave(golden):
    """The fixture's wave trimmed and pre-emphasized, as the chain does."""
    y, _ = trim_silence(golden["wave"], CFG.top_db)
    return preemphasis(y, CFG.preemphasis)


def test_golden_hann(golden):
    lpad = (CFG.n_fft - CFG.win_length) // 2
    ours = hann_window(CFG.win_length, CFG.n_fft)
    np.testing.assert_allclose(ours[lpad : lpad + CFG.win_length], golden["hann_win"], atol=1e-10)


def test_golden_mel_basis(golden):
    np.testing.assert_allclose(
        mel_filterbank(CFG.sr, CFG.n_fft, CFG.n_mels), golden["mel_basis"], atol=1e-6
    )


def test_golden_trim(golden):
    _, (s, e) = trim_silence(golden["wave"], CFG.top_db)
    assert (s, e) == (int(golden["trim_start"]), int(golden["trim_end"]))


def test_golden_stft_mag(golden, wave):
    ours = np.abs(stft_np(wave, CFG.n_fft, CFG.hop_length, CFG.win_length))
    np.testing.assert_allclose(ours, golden["stft_mag"], atol=2e-4)
    tens = stft(torch.from_numpy(wave), CFG.n_fft, CFG.hop_length, CFG.win_length)
    np.testing.assert_allclose(tens.abs().numpy(), golden["stft_mag"], atol=2e-4)


def test_golden_full_chain(golden, wave):
    mel, mag = mel_from_wave(wave, CFG)
    np.testing.assert_allclose(mel, golden["mel_norm"], atol=1e-4)
    np.testing.assert_allclose(mag, golden["mag_norm"], atol=1e-4)


def test_golden_batched_featurizer(golden, wave):
    mel, mag = mel_from_wave_batched(torch.from_numpy(wave)[None], CFG)
    np.testing.assert_allclose(mel[0].numpy(), golden["mel_norm"], atol=1e-4)
    np.testing.assert_allclose(mag[0].numpy(), golden["mag_norm"], atol=1e-4)
    # the ETL's call: reflect-padded at the wave's ends, zero-filled to a
    # 2-second bucket that it shares with a longer wave
    other = np.resize(wave, 2 * CFG.sr - CFG.n_fft)
    out = featurize_batch([("other", other), ("golden", wave)], 2 * CFG.sr, CFG, torch.device("cpu"))
    assert out["golden"].shape == golden["mel_norm"].shape
    np.testing.assert_allclose(out["golden"], golden["mel_norm"], atol=1e-4)
