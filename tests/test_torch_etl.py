"""The port's batched featurizer and ETL machinery (dsp/features.py,
tools/etl.py) against the JAX package's on the same seeded numpy inputs:
``mel_from_wave_batched`` against ``mel_from_wave_jax`` to 1e-4 (the bound of
tests/test_dsp.py), ``featurize_paths(host=True)`` bit for bit against
``use_tpu=False``, the batched path within 5e-4 (tests/test_kernels.py's
bound) of the host path on every frame, and the split, attr, reduce and
sampling functions exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu.core.config import SignalConfig as JSignal
from adaptive_voice_conversion_tpu.dsp import features as jfeat
from adaptive_voice_conversion_tpu.tools import etl as jetl
from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig
from adaptive_voice_conversion_tpu_torch.dsp import features
from adaptive_voice_conversion_tpu_torch.dsp.audio import preemphasis, save_wav
from adaptive_voice_conversion_tpu_torch.dsp.stft import frame_count
from adaptive_voice_conversion_tpu_torch.tools import etl

SMALL = dict(sr=8000, n_fft=256, hop_length=64, win_length=192, n_mels=40)
FULL = SignalConfig()
CPU = torch.device("cpu")
# frames whose window reaches past a wave's end: ceil((n_fft/2) / hop)
N_EDGE = -(-(FULL.n_fft // 2) // FULL.hop_length)


def waves(n, count, seed=0, sr=24000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    out = []
    for i in range(count):
        f0 = 150.0 + 60.0 * i
        y = (
            0.5 * np.sin(2 * np.pi * f0 * t)
            + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t + 0.4)
            + 0.03 * rng.standard_normal(n)
        ) * np.clip(np.sin(np.pi * np.arange(n) / n) * 4, 0, 1)
        out.append(preemphasis(y.astype(np.float32), 0.97))
    return np.stack(out)


@pytest.mark.parametrize("sig", [SMALL, {}], ids=["small", "full"])
def test_mel_from_wave_batched_matches_jax(sig):
    cfg, jcfg = SignalConfig(**sig), JSignal(**sig)
    y = waves(int(0.61 * cfg.sr), 3, sr=cfg.sr)  # a batch of 3 waves of one length
    mel, mag = features.mel_from_wave_batched(torch.from_numpy(y), cfg)
    jmel, jmag = jfeat.mel_from_wave_jax(jnp.asarray(y), jcfg)
    n_frames = frame_count(y.shape[1], cfg.n_fft, cfg.hop_length)
    assert tuple(mel.shape) == (3, n_frames, cfg.n_mels)
    assert tuple(mag.shape) == (3, n_frames, 1 + cfg.n_fft // 2)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-4)
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), atol=1e-4)
    # each row is the host featurizer on that wave alone
    for r in range(3):
        host_mel, _ = features.mel_from_wave(y[r], cfg)
        np.testing.assert_allclose(mel[r].numpy(), host_mel, atol=1e-4)


def test_uncentered_framing_of_a_padded_wave_is_the_centered_stft():
    cfg = SignalConfig(**SMALL)
    y = waves(700, 2, sr=cfg.sr)
    pad = cfg.n_fft // 2
    yp = np.pad(y, ((0, 0), (pad, pad)), mode="reflect")
    a, _ = features.mel_from_wave_batched(torch.from_numpy(y), cfg)
    b, _ = features.mel_from_wave_batched(torch.from_numpy(yp), cfg, centered=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mel_matmul_runs_without_tf32_and_restores_the_switch():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with features._f32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


LENGTHS = (1.0, 1.37, 2.61)  # seconds: one whole bucket, two inside a bucket


@pytest.fixture(scope="module")
def wav_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = []
    for i, sec in enumerate(LENGTHS):
        n = int(round(sec * FULL.sr))
        rng = np.random.default_rng(3 + i)
        t = np.arange(n) / FULL.sr
        y = 0.5 * np.sin(2 * np.pi * (330 - 40 * i) * t) + 0.02 * rng.standard_normal(n)
        paths.append(str(d / f"u{i}_{sec}.wav"))
        save_wav(paths[-1], y.astype(np.float32), FULL.sr)
    # reverse name order, so that the output order follows the paths
    return paths[::-1]


@pytest.fixture(scope="module")
def jax_host(wav_paths):
    return jetl.featurize_paths(wav_paths, JSignal(), use_tpu=False)


def test_host_path_equals_jax_bit_for_bit(wav_paths, jax_host):
    ours = etl.featurize_paths(wav_paths, FULL, host=True)
    assert list(ours) == list(jax_host) == [os.path.basename(p) for p in wav_paths]
    for k in ours:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], jax_host[k])


@pytest.mark.parametrize("batch", [1, 2, 16])
def test_batched_path_within_5e4_of_jax_host_on_every_frame(wav_paths, jax_host, batch):
    ours = etl.featurize_paths(wav_paths, FULL, device="cpu", batch=batch)
    assert list(ours) == list(jax_host)  # the order of the paths, not of the buckets
    for k, ref in jax_host.items():
        assert ours[k].shape == ref.shape and ours[k].dtype == np.float32
        np.testing.assert_allclose(ours[k], ref, atol=5e-4, err_msg=k)


def test_batched_path_against_jax_tpu_path_pins_its_edge_frames(wav_paths, jax_host):
    """JAX's batched path reflects at the bucket's end, not the wave's: the
    last frames of a wave that ends inside a bucket are off there (the
    recorded reference fault). Every other frame agrees within 5e-4."""
    ours = etl.featurize_paths(wav_paths, FULL, device="cpu")
    jtpu = jetl.featurize_paths(wav_paths, JSignal(), use_tpu=True)
    for k, ref in jtpu.items():
        n = len(etl.load_wave(next(p for p in wav_paths if p.endswith(k)), FULL))
        ends_inside = n % FULL.sr != 0
        body = slice(0, len(ref) - N_EDGE)
        np.testing.assert_allclose(ours[k][body], ref[body], atol=5e-4, err_msg=k)
        edge_jax = float(np.abs(ref[-N_EDGE:] - jax_host[k][-N_EDGE:]).max())
        edge_ours = float(np.abs(ours[k][-N_EDGE:] - jax_host[k][-N_EDGE:]).max())
        assert edge_ours <= 5e-4, (k, edge_ours)
        if ends_inside:
            assert edge_jax > 1e-2, (k, edge_jax)
        else:
            assert edge_jax <= 5e-4, (k, edge_jax)
    # the JAX batched path returns its mels in bucket order
    assert list(jtpu) == sorted(jtpu, key=lambda k: float(k.split("_")[1][:-4]))


def test_bucket_batches_group_by_padded_length_and_keep_order():
    cfg = SignalConfig()
    ext = cfg.n_fft  # reflect padding of n_fft // 2 at each end
    lens = [cfg.sr - ext, cfg.sr - ext + 1, 10, 2 * cfg.sr, cfg.sr - ext - 5]
    ws = [(f"w{i}", np.zeros(n, np.float32)) for i, n in enumerate(lens)]
    got = etl.bucket_batches(ws, cfg, batch=2)
    assert [(p, [n for n, _ in c]) for p, c in got] == [
        (cfg.sr, ["w0", "w2"]), (cfg.sr, ["w4"]),
        (2 * cfg.sr, ["w1"]), (3 * cfg.sr, ["w3"]),
    ]


def test_featurize_batch_reads_no_fill():
    """A wave's mel does not depend on what shares its bucket or on the
    bucket's length."""
    cfg = SignalConfig(**SMALL)
    y = waves(1500, 2, sr=cfg.sr)
    alone = etl.featurize_batch([("a", y[0][:1100])], 4 * cfg.sr, cfg, CPU)["a"]
    mixed = etl.featurize_batch(
        [("b", y[1]), ("a", y[0][:1100])], 2 * cfg.sr, cfg, CPU
    )["a"]
    host, _ = features.mel_from_wave(y[0][:1100], cfg)
    assert alone.shape == host.shape == mixed.shape
    np.testing.assert_allclose(alone, host, atol=1e-4)
    np.testing.assert_allclose(mixed, alone, atol=1e-6)


@pytest.fixture
def split_data():
    rng = np.random.default_rng(7)
    lens = [40, 33, 32, 90, 31, 64]
    return {f"p{i:03d}_{i:03d}.wav": rng.random((n, 12)).astype(np.float32) for i, n in enumerate(lens)}


def test_compute_attr_and_normalize_equal_jax(split_data):
    order = list(split_data)[::-1]
    for n_attr in (1, 4, 100):
        ours = etl.compute_attr(split_data, order, n_attr)
        ref = jetl.compute_attr(split_data, order, n_attr)
        for key in ("mean", "std"):
            np.testing.assert_array_equal(ours[key], ref[key])
        a, b = etl.normalize_split(split_data, ours), jetl.normalize_split(split_data, ref)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seg", [31, 32, 64])
def test_reduce_and_sample_equal_jax(split_data, seg):
    ours, ref = etl.reduce_dataset(split_data, seg), jetl.reduce_dataset(split_data, seg)
    assert list(ours) == list(ref) and all(ours[k] is split_data[k] for k in ours)
    for seed in (0, 11, None):
        a = etl.sample_single_segments(split_data, 300, seg, seed=seed)
        b = jetl.sample_single_segments(split_data, 300, seg, seed=seed)
        if seed is None:  # unseeded draws differ, but stay in range
            assert all(0 <= t <= len(split_data[u]) - seg for u, t in a)
        else:
            assert a == b


def test_split_flags():
    rest, opts = etl.split_flags(["a", "--seed", "3", "b", "--device", "cuda:1"])
    assert rest == ["a", "b"] and opts == {"host": False, "device": "cuda:1", "seed": 3}
    rest, opts = etl.split_flags(["--tpu", "a"])
    assert rest == ["a"] and not opts["host"] and opts["device"] == "cuda"
    assert etl.split_flags(["--host"])[1]["host"]
    with pytest.raises(SystemExit):
        etl.split_flags(["--host", "--tpu"])
    with pytest.raises(SystemExit):
        etl.split_flags(["a", "--seed"])


def test_batched_path_needs_a_device_by_default(wav_paths, monkeypatch):
    """No silent fallback: the default device is ``cuda``, and without one
    the batched path raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        etl.featurize_paths(wav_paths, FULL)
