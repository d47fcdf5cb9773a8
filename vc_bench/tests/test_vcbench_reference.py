"""The plain reference against the program under test at a tiny size on
the CPU: the model's forward, the training steps, the featurizer and the
exact Griffin-Lim; and the measure a wav is judged by."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
from adaptive_voice_conversion_tpu_torch.dsp.audio import preemphasis, trim_silence
from adaptive_voice_conversion_tpu_torch.dsp.features import mel_from_wave
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import griffin_lim, mel_to_mag
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from vc_bench import run, traffic
from vc_bench.reference import featurize as ref_feat
from vc_bench.reference import vocoder as ref_voc
from vc_bench.reference.model import Net, make_params
from vc_bench.tests.tiny import tiny_cell, tiny_config


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def port_model(cfg, params):
    model = AE(config_from_dict(cfg).model)
    model.load_state_dict(params, strict=True)
    return model.eval()


@pytest.mark.parametrize("sn", [False, True])
def test_forward_matches_the_port(sn):
    cfg = tiny_config(sn)
    params = make_params(cfg, 11, "cpu")
    g = torch.Generator().manual_seed(0)
    src, tar = torch.randn(37, 16, generator=g), torch.randn(29, 16, generator=g)
    ours = Net(cfg, params).inference(src, tar)
    with torch.no_grad():
        theirs = port_model(cfg, params).inference(src[None], tar[None])[0]
    assert ours.shape == theirs.shape == (40, 16)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell,sn", [("train_b128", False), ("train_sn_b128", True)])
def test_training_steps_match_the_port(cell, sn):
    """The harness's whole training run at a tiny size: the program's first
    steps against the reference's, both in f32 on the CPU."""
    res = run.run_cell(cell, 2**31 + 17, 0.2, False, device="cpu", cell=tiny_cell(cell),
                       cfg=tiny_config(sn), log=lambda s: None)
    assert res["correct"] and res["failed"] == 0
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["loss1_gap"] <= 1e-6 and checks["loss23_gap"] <= 1e-5
    assert checks["grad_gap"] <= 1e-4 and checks["change_gap"] <= 1e-3


def test_featurizer_is_the_ports_bit_for_bit():
    sig = tiny_config()["signal"]
    tcfg = config_from_dict(tiny_config()).signal
    for y in traffic.voiced_waves([0.7, 1.3], sig["sr"], 5, "cpu"):
        t, _ = trim_silence(y, tcfg.top_db)
        theirs = mel_from_wave(preemphasis(t, tcfg.preemphasis), tcfg)[0]
        ours = ref_feat.featurize(y, sig)
        assert ours.shape == theirs.shape and np.array_equal(ours, theirs)
        assert ours.shape[0] < 1 + len(y) // sig["hop_length"]  # the trim cut the silences
        assert np.abs(ref_feat.featurize(y, sig, control=True) - ours).max() > 0


def test_exact_griffin_lim_matches_the_port():
    """Two iterations (Griffin-Lim amplifies the last bits of its input
    about five times an iteration, so longer runs part)."""
    cfg = tiny_config()
    sig = cfg["signal"]
    mel = torch.rand(30, sig["n_mels"], generator=torch.Generator().manual_seed(3)) * 0.5 + 0.3
    mag = ref_voc.mel_to_mag(mel, sig)
    tcfg = config_from_dict(cfg).signal
    torch.testing.assert_close(mag, mel_to_mag(mel, tcfg), rtol=1e-5, atol=1e-6)
    ours = ref_voc.griffin_lim(mag, sig, 2)
    theirs = griffin_lim(mag, tcfg, n_iter=2, method="exact")
    assert ours.shape == theirs.shape
    assert (ours - theirs).abs().max() <= 1e-4 * theirs.abs().max()


def test_spectral_convergence_of_trimmed_and_broken_wavs():
    cfg = tiny_config()
    sig = cfg["signal"]
    mel = torch.rand(40, sig["n_mels"], generator=torch.Generator().manual_seed(4)) * 0.4 + 0.4
    mag = ref_voc.mel_to_mag(mel, sig)
    y = ref_voc.griffin_lim(mag, sig, 30)
    base = ref_voc.sc_signal(y, mag, sig)
    wav = ref_voc.deemphasis(y.numpy(), sig["preemphasis"])
    assert ref_voc.spectral_convergence(wav, mag, sig) == pytest.approx(base, abs=2e-3)
    # a trim that cut a silent start is placed back where it was
    e = y.numpy().copy()
    e[:512] = 0.0
    quiet = ref_voc.deemphasis(e, sig["preemphasis"])
    full = ref_voc.spectral_convergence(quiet, mag, sig)
    assert ref_voc.spectral_convergence(quiet[512:], mag, sig) == pytest.approx(full, abs=1e-4)
    assert ref_voc.spectral_convergence(wav[::-1].copy(), mag, sig) > base + 0.3
    assert ref_voc.spectral_convergence(np.zeros(10, np.float32), mag, sig) >= 0.9
    assert ref_voc.spectral_convergence(np.concatenate([wav, wav]), mag, sig) == float("inf")
    assert ref_voc.griffin_lim(mag, sig, 30, int8=True).shape == y.shape
