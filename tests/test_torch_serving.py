"""Batched serving in the port (``Inferencer.convert_grid`` /
``convert_pairs`` / ``cli.convert_grid``) against the JAX package's
``convert_grid`` and against the port's own one-at-a-time conversion, on
the same seeded weights and mels, on the CPU.

Tolerances: converted mels 1e-5 (the gate of tests/test_masked.py); wavs
2e-2 of the peak, as there. On an untrained decoder's inconsistent
magnitude Griffin-Lim amplifies the last bits of its input about fivefold
per iteration (a projection divides by |X| where it nearly vanishes). Within
the port, grid against one-at-a-time, the wavs hold 2e-2 at 30 iterations,
as in the JAX package's own test. Across the two packages the mels already
differ by ~1e-6 (two convolution libraries) and the wavs by ~3e-3 of the
peak at 2 iterations, 2e-2 at 4 and 0.5 at 30, so the cross-package wav
comparison is made at 2 iterations; tests/test_torch_masked.py holds the
ragged Griffin-Lim itself against the JAX one on a fixed magnitude.
"""

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
import jax
from scipy.io import wavfile

from adaptive_voice_conversion_tpu.core import config as jcfg
from adaptive_voice_conversion_tpu.infer.inferencer import Inferencer as JInferencer
from adaptive_voice_conversion_tpu.models.ae import init_ae
from adaptive_voice_conversion_tpu_torch.cli.convert_grid import main as grid_main
from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.dsp.audio import save_wav, trim_silence
from adaptive_voice_conversion_tpu_torch.dsp import vocoder as tvoc
from adaptive_voice_conversion_tpu_torch.dsp.features import get_spectrograms
from adaptive_voice_conversion_tpu_torch.infer import inferencer as tinf
from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as tgl
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.models.weights import (
    save_checkpoint,
    state_dict_from_jax_params,
)

from test_torch_masked import N_MELS, SIGNAL, tiny_model_configs

REPO = Path(__file__).resolve().parents[1]
HOP = SIGNAL["hop_length"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The TINY model at the small signal geometry in both packages'
    Inferencers, on the same weights and attr.pkl."""
    d = tmp_path_factory.mktemp("serving")
    j_model, t_model = tiny_model_configs()
    sig = dict(SIGNAL, n_mels=N_MELS)
    j_cfg = jcfg.TrainConfig(model=j_model, signal=jcfg.SignalConfig(**sig))
    t_cfg = tcfg.TrainConfig(model=t_model, signal=tcfg.SignalConfig(**sig))
    params = jax.jit(lambda k: init_ae(k, j_model))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    attr = {
        "mean": rng.standard_normal(N_MELS).astype(np.float32),
        "std": (1.0 + rng.random(N_MELS)).astype(np.float32),
    }
    attr_path = str(d / "attr.pkl")
    with open(attr_path, "wb") as fh:
        pickle.dump(attr, fh)
    model = AE(t_model)
    model.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), t_model),
        strict=True,
    )
    port = tinf.Inferencer(t_cfg, model, attr_path, device="cpu")
    return port, JInferencer(j_cfg, params, attr_path), attr_path


def mels_of(rng, lens):
    return [rng.standard_normal((L, N_MELS)).astype(np.float32) for L in lens]


def test_convert_grid_matches_jax_and_one_at_a_time(served):
    """The mixed-length grid: mels against one-at-a-time ``convert_mel`` and
    against the JAX package's grid to 1e-5, wavs against the JAX grid's to
    2e-2 of the peak at 2 iterations (see the module docstring)."""
    port, jax_inf, _ = served
    rng = np.random.default_rng(7)
    srcs, tgts = mels_of(rng, (40, 29)), mels_of(rng, (24, 33))
    wavs, mels = port.convert_grid(srcs, tgts, gl_iters=2, trim=False, return_mels=True)
    j_wavs, j_mels = jax_inf.convert_grid(srcs, tgts, gl_iters=2, trim=False, return_mels=True)
    assert len(wavs) == len(mels) == 4
    for i, s in enumerate(srcs):
        for j, t in enumerate(tgts):
            k = i * len(tgts) + j
            single = port.denormalize(port.convert_mel(s, t))
            assert mels[k].shape == single.shape == j_mels[k].shape
            np.testing.assert_allclose(mels[k], single, atol=1e-5)
            np.testing.assert_allclose(mels[k], j_mels[k], atol=1e-5)
            assert wavs[k].shape == j_wavs[k].shape == (HOP * (s.shape[0] - 1),)
            assert wavs[k].dtype == np.float32
            peak = max(float(np.abs(j_wavs[k]).max()), 1.0)
            np.testing.assert_allclose(wavs[k], j_wavs[k], atol=2e-2 * peak)


def test_convert_grid_wavs_match_one_at_a_time_vocoder(served):
    """The grid's wav for a pair against ``inference_one_utterance`` on the
    pair alone (same package, same FFT library): 2e-2 of the peak."""
    port, _, attr_path = served
    rng = np.random.default_rng(17)
    srcs, tgts = mels_of(rng, (40, 29)), mels_of(rng, (24,))
    wavs = port.convert_grid(srcs, tgts, gl_iters=30, trim=False)
    signal30 = dataclasses.replace(port.config.signal, n_iter=30)
    solo = tinf.Inferencer(
        dataclasses.replace(port.config, signal=signal30), port.model, attr_path,
        device="cpu",
    )
    for k, s in enumerate(srcs):
        mel = torch.from_numpy(solo.denormalize(solo.convert_mel(s, tgts[0])))
        with torch.no_grad():
            ref = tinf.deemphasis_torch(
                tinf.griffin_lim(tinf.mel_to_mag(mel, signal30), signal30), signal30.preemphasis
            ).numpy()
        n = HOP * (s.shape[0] - 1)
        peak = max(float(np.abs(ref[:n]).max()), 1.0)
        np.testing.assert_allclose(wavs[k], ref[:n], atol=2e-2 * peak)


def test_convert_grid_uniform_fast_path(served, monkeypatch):
    """A uniform grid (lengths multiples of the downsample product, targets
    equal) has no padding: it runs the unmasked model and the plain
    Griffin-Lim, never the masked ones, and still equals per-pair
    conversion to 1e-5."""
    port, jax_inf, _ = served
    rng = np.random.default_rng(9)
    srcs, tgts = mels_of(rng, (40, 40)), mels_of(rng, (24, 24))

    def refuse(*a, **k):
        raise AssertionError("the uniform grid reached a masked function")

    monkeypatch.setattr(tinf, "ae_inference_masked", refuse)
    monkeypatch.setattr(tinf, "griffin_lim_masked", refuse)
    wavs, mels = port.convert_grid(srcs, tgts, gl_iters=8, trim=False, return_mels=True)
    monkeypatch.undo()
    _, j_mels = jax_inf.convert_grid(srcs, tgts, gl_iters=8, trim=False, return_mels=True)
    for i, s in enumerate(srcs):
        for j, t in enumerate(tgts):
            k = i * 2 + j
            np.testing.assert_allclose(mels[k], port.denormalize(port.convert_mel(s, t)), atol=1e-5)
            np.testing.assert_allclose(mels[k], j_mels[k], atol=1e-5)
            assert wavs[k].shape == (HOP * 39,) and np.isfinite(wavs[k]).all()
    # one frame off the padded length, and the grid is ragged again
    monkeypatch.setattr(tinf, "ae_inference_masked", refuse)
    with pytest.raises(AssertionError, match="masked function"):
        port.convert_grid(mels_of(rng, (40, 39)), tgts, gl_iters=2)


def test_convert_grid_len_bucket_changes_nothing(served):
    """Bucketed padded shapes must not change any output (1e-5): the masked
    path is exact under any padding."""
    port, _, _ = served
    rng = np.random.default_rng(10)
    srcs, tgts = mels_of(rng, (37, 29)), mels_of(rng, (24, 31))
    assert port._padded_shapes([37, 29], [24, 31], 1) == (38, 31)
    assert port._padded_shapes([37, 29], [24, 31], 16) == (48, 32)
    assert port._padded_shapes([37, 29], [24, 31], 3) == (42, 33)  # lcm(2, 3) = 6
    wavs_a, mels_a = port.convert_grid(srcs, tgts, gl_iters=4, trim=False, return_mels=True)
    wavs_b, mels_b = port.convert_grid(
        srcs, tgts, gl_iters=4, trim=False, return_mels=True, len_bucket=16
    )
    for a, b in zip(mels_a, mels_b):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-5)
    for a, b in zip(wavs_a, wavs_b):
        assert a.shape == b.shape and np.isfinite(b).all()


def test_convert_pairs_matches_singles_and_jax(served):
    port, jax_inf, _ = served
    rng = np.random.default_rng(12)
    pairs = [
        (mels_of(rng, (ls,))[0], mels_of(rng, (lt,))[0])
        for ls, lt in ((40, 24), (29, 33), (35, 19))
    ]
    wavs, mels = port.convert_pairs(pairs, gl_iters=4, trim=False, return_mels=True)
    _, j_mels = jax_inf.convert_pairs(pairs, gl_iters=4, trim=False, return_mels=True)
    assert len(wavs) == len(mels) == 3
    for k, (s, t) in enumerate(pairs):
        single = port.denormalize(port.convert_mel(s, t))
        assert mels[k].shape == single.shape
        np.testing.assert_allclose(mels[k], single, atol=1e-5)
        np.testing.assert_allclose(mels[k], j_mels[k], atol=1e-5)
        assert wavs[k].shape == (HOP * (s.shape[0] - 1),)


def test_convert_grid_fused_and_trim(served, monkeypatch):
    """``gl_method="fused"`` on a ragged grid goes through the kernel's
    wrapper once (its plain version on the CPU, which counts no launch);
    trimmed wavs are no longer than the crop; the constructor's method is
    the default."""
    port, _, attr_path = served
    rng = np.random.default_rng(18)
    srcs, tgts = mels_of(rng, (40, 29)), mels_of(rng, (24, 33, 30))
    calls = []
    real = tgl.griffin_lim_phases

    def spy(mag, *a, **k):
        calls.append(tuple(mag.shape))
        return real(mag, *a, **k)

    before = real.launches
    monkeypatch.setattr(tvoc, "griffin_lim_phases", spy)  # the name the schedules call
    wavs = port.convert_grid(srcs, tgts, gl_iters=10, gl_method="fused")
    monkeypatch.undo()
    assert calls == [(6, SIGNAL["n_fft"] // 2 + 1, 40)]  # one call, all six pairs
    assert real.launches == before
    assert len(wavs) == 6
    for k, w in enumerate(wavs):
        assert w.ndim == 1 and np.isfinite(w).all()
        assert 0 < len(w) <= HOP * (srcs[k // 3].shape[0] - 1)
    fused = tinf.Inferencer(port.config, port.model, attr_path, gl_method="fused", device="cpu")
    again = fused.convert_grid(srcs, tgts, gl_iters=10)
    for a, b in zip(wavs, again):
        np.testing.assert_array_equal(a, b)


def test_trim_on_the_device_equals_the_host_trim(served, monkeypatch):
    """``convert_grid``, ``convert_pairs`` and the one-shot path with the
    trim on (bounds computed on the wavs' device, ``trim_bounds``) return,
    bit for bit, the host's ``trim_silence`` of the same call with the trim
    off. The mixed-length grid's wavs get silent heads and tails (an
    envelope after the de-emphasis, other per row), so the bounds cut."""
    port, _, _ = served
    real = tinf.deemphasis_torch

    def quiet_ends(y, coef):
        out = real(y, coef)
        idx = torch.arange(out.shape[-1])
        row = torch.arange(out.shape[0])[:, None] if out.ndim == 2 else 0
        loud = (idx >= 1100 + 300 * row) & (idx < 3000 + 700 * row)
        return torch.where(loud, out, 1e-6 * out)

    monkeypatch.setattr(tinf, "deemphasis_torch", quiet_ends)
    monkeypatch.setattr(tvoc, "deemphasis_torch", quiet_ends)
    rng = np.random.default_rng(19)
    srcs, tgts = mels_of(rng, (120, 61, 90)), mels_of(rng, (40, 33))
    whole = port.convert_grid(srcs, tgts, gl_iters=2, trim=False)
    cut = port.convert_grid(srcs, tgts, gl_iters=2)
    pairs = [(srcs[1], tgts[0]), (srcs[0], tgts[1]), (srcs[2], tgts[1])]
    whole_pairs = port.convert_pairs(pairs, gl_iters=2, trim=False)
    cut_pairs = port.convert_pairs(pairs, gl_iters=2)
    bounds = []
    for w, c in zip(whole + whole_pairs, cut + cut_pairs):
        want, cut_at = trim_silence(w, top_db=60.0)
        assert c.dtype == np.float32
        np.testing.assert_array_equal(c, want)
        bounds.append((cut_at, len(w)))
    assert any(s > 0 for (s, _), _ in bounds) and any(e < n for (_, e), n in bounds)
    src, tgt = srcs[0], tgts[1]
    wav, dec = port.inference_one_utterance(src, tgt)
    mel = torch.from_numpy(np.asarray(dec, np.float32))
    with torch.no_grad():
        y = quiet_ends(tinf.griffin_lim(tinf.mel_to_mag(mel, port.config.signal), port.config.signal),
                       port.config.signal.preemphasis).numpy()
    want, (s, e) = trim_silence(y, top_db=60.0)
    assert s > 0 and e < len(y)
    np.testing.assert_array_equal(wav, want)


@pytest.mark.parametrize("gl_method", ["exact", "fused"])
@pytest.mark.parametrize("attr_dtype", [np.float32, np.float64])
def test_one_shot_vocodes_from_the_card(served, tmp_path, monkeypatch, attr_dtype, gl_method):
    """``inference_one_utterance`` returns, bit for bit and dtype included,
    what the chain through the host computes: ``convert_mel``, the host's
    ``denormalize`` (float64 for a float64 attr.pkl), ``melspectrogram2wav``
    on the float32 copy of that mel made on the host. The decoder's output
    stays on its device for the vocoder: no mel becomes a tensor from the
    host after the model has run."""
    port, _, _ = served
    rng = np.random.default_rng(23)
    attr = {"mean": rng.standard_normal(N_MELS).astype(attr_dtype),
            "std": (1.0 + rng.random(N_MELS)).astype(attr_dtype)}
    path = tmp_path / "attr.pkl"
    with open(path, "wb") as fh:
        pickle.dump(attr, fh)
    cfg = dataclasses.replace(port.config, signal=dataclasses.replace(port.config.signal, n_iter=8))
    inf = tinf.Inferencer(cfg, port.model, str(path), gl_method=gl_method, device="cpu")
    src, tar = mels_of(rng, (37, 26))
    want_mel = inf.denormalize(inf.convert_mel(src, tar))
    with torch.no_grad():
        mel = torch.from_numpy(np.asarray(want_mel, np.float32))
        want_wav = tinf.melspectrogram2wav(mel, cfg.signal, gl_method=gl_method)

    ran, made, real = [], [], torch.from_numpy

    class Marked:  # the model, marking that it has run
        def inference(self, *a):
            out = port.model.inference(*a)
            ran.append(out.shape)
            return out

    def from_numpy(a):
        if ran:
            made.append(a.shape)
        return real(a)

    inf.model = Marked()
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    wav, mel = inf.inference_one_utterance(src, tar)
    monkeypatch.undo()
    assert ran == [(1,) + want_mel.shape]
    assert want_mel.shape not in made, made
    assert mel.dtype == want_mel.dtype == np.result_type(np.float32, attr_dtype)
    np.testing.assert_array_equal(mel, want_mel)
    assert wav.dtype == want_wav.dtype == np.float32
    np.testing.assert_array_equal(wav, want_wav)


def test_serving_refuses_other_frame_sizes(served):
    port, _, attr_path = served
    cfg = dataclasses.replace(
        port.config, data_loader=dataclasses.replace(port.config.data_loader, frame_size=2)
    )
    other = tinf.Inferencer(cfg, port.model, attr_path, device="cpu")
    m = np.zeros((8, N_MELS), np.float32)
    with pytest.raises(NotImplementedError):
        other.convert_grid([m], [m])
    with pytest.raises(NotImplementedError):
        other.convert_pairs([(m, m)])


def test_plain_kernel_keeps_padded_rows_zero():
    """Zero-magnitude pad frames stay exactly zero and finite through the
    plain version's projection (its clamp(min=1e-8) times mag = 0), on a
    ragged stacked batch, and no block leaks into another: changing one
    block leaves the others' outputs bit for bit."""
    cfg = tcfg.SignalConfig()
    rng = np.random.default_rng(19)
    lens, t = [16, 9, 13], 16
    n_freq = 1 + cfg.n_fft // 2
    mag = np.abs(rng.standard_normal((3, n_freq, t))).astype(np.float32)
    for i, L in enumerate(lens):
        mag[i, :, L:] = 0.0
    out = tgl.griffin_lim_phases(torch.from_numpy(mag), cfg, n_iter=12)
    assert torch.isfinite(out.real).all() and torch.isfinite(out.imag).all()
    for i, L in enumerate(lens):
        assert not out[i, :, L:].abs().any()
        assert out[i, :, :L].abs().sum() > 0
    other = mag.copy()
    other[1, :, :9] *= 3.0
    out2 = tgl.griffin_lim_phases(torch.from_numpy(other), cfg, n_iter=12)
    for i in (0, 2):
        torch.testing.assert_close(out2[i], out[i], rtol=0, atol=0)
    assert not torch.equal(out2[1], out[1])


@pytest.fixture(scope="module")
def cli_assets(tmp_path_factory):
    """A narrow model at the 512-mel width, 6 Griffin-Lim iterations, two
    source and three target wavs of different lengths."""
    d = tmp_path_factory.mktemp("grid")
    raw = yaml.safe_load((REPO / "examples" / "config.yaml").read_text())
    for k in ("SpeakerEncoder", "ContentEncoder"):
        raw[k].update(c_h=8, c_out=8, c_bank=4)
    raw["Decoder"].update(c_in=8, c_cond=8, c_h=8)
    raw["signal"] = {"n_iter": 6}
    (d / "config.yaml").write_text(yaml.safe_dump(raw))
    cfg = tcfg.config_from_dict(raw)
    rng = np.random.default_rng(0)
    names = {"s0": 0.50, "s1": 0.42, "t0": 0.40, "t1": 0.46, "t2": 0.52}
    for i, (name, seconds) in enumerate(names.items()):
        t = np.arange(int(seconds * cfg.signal.sr)) / cfg.signal.sr
        f0 = 120.0 + 30.0 * i
        y = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 2 * f0 * t)
        save_wav(str(d / f"{name}.wav"), (y + 0.01 * rng.standard_normal(len(t))).astype(np.float32), cfg.signal.sr)
    mels = np.concatenate([get_spectrograms(str(d / f"{n}.wav"))[0] for n in names])
    with open(d / "attr.pkl", "wb") as f:
        pickle.dump({"mean": mels.mean(0), "std": mels.std(0)}, f)
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    save_checkpoint(model, str(d / "model.ckpt"))
    return d, cfg


@pytest.mark.parametrize("gl_method", ["exact", "fused"])
def test_cli_convert_grid_on_cpu(cli_assets, gl_method, capsys):
    d, cfg = cli_assets
    out = d / f"out_{gl_method}"
    grid_main([
        "-a", str(d / "attr.pkl"), "-c", str(d / "config.yaml"), "-m", str(d / "model.ckpt"),
        "-s", str(d / "s0.wav"), str(d / "s1.wav"),
        "-t", str(d / "t0.wav"), str(d / "t1.wav"), str(d / "t2.wav"),
        "-o", str(out), "--device", "cpu", "--gl_method", gl_method, "--len_bucket", "16",
    ])
    assert "wrote 6 conversions" in capsys.readouterr().out
    written = sorted(p.name for p in out.iterdir())
    assert written == sorted(f"s{i}__to__t{j}.wav" for i in range(2) for j in range(3))
    for i in range(2):
        n_src = get_spectrograms(str(d / f"s{i}.wav"))[0].shape[0]
        for j in range(3):
            sr, wav = wavfile.read(out / f"s{i}__to__t{j}.wav")
            assert sr == cfg.signal.sr and wav.dtype == np.float32 and np.isfinite(wav).all()
            assert 0 < len(wav) <= cfg.signal.hop_length * (n_src - 1)


def test_cli_convert_grid_raises_without_a_gpu(cli_assets, monkeypatch):
    """The default device is ``cuda``; without one the CLI raises before it
    writes anything, and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, _ = cli_assets
    with pytest.raises(RuntimeError, match="cuda"):
        grid_main([
            "-a", str(d / "attr.pkl"), "-c", str(d / "config.yaml"), "-m", str(d / "model.ckpt"),
            "-s", str(d / "s0.wav"), "-t", str(d / "t0.wav"), "-o", str(d / "never"),
        ])
    assert not (d / "never").exists()
