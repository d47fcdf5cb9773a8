"""The port's dataset tools (tools/make_datasets_vctk.py,
make_datasets_libri.py, reduce_dataset.py, sample_single_segments.py,
preprocess_pipeline.py) against the JAX package's on synthetic corpora (a
VCTK tree of 48 kHz wavs, a LibriTTS tree of 24 kHz wavs): with ``--host``
the port writes the JAX package's files, pickle for pickle and JSON for
JSON; the batched featurizer (``--device cpu``) writes mels within 5e-4 of
them, attr.pkl within 1e-5 relative and the same indexes. Then the whole
system on the CPU: wavs -> dataset -> 4 Solver steps -> one-shot conversion;
and the CPU vocoder, the numpy oracle, against the JAX package's."""

import dataclasses
import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from adaptive_voice_conversion_tpu.core.config import SignalConfig as JSignal
from adaptive_voice_conversion_tpu.dsp import vocoder as jvoc
from adaptive_voice_conversion_tpu.infer.inferencer import Inferencer as JInferencer
from adaptive_voice_conversion_tpu.tools import preprocess_pipeline as jpipeline
from adaptive_voice_conversion_tpu.tools import reduce_dataset as jreduce
from adaptive_voice_conversion_tpu.tools import sample_single_segments as jsample
from adaptive_voice_conversion_tpu_torch.cli.inference import main as inference_main
from adaptive_voice_conversion_tpu_torch.core.config import (
    DataLoaderConfig,
    SignalConfig,
    config_from_dict,
)
from adaptive_voice_conversion_tpu_torch.dsp import vocoder
from adaptive_voice_conversion_tpu_torch.dsp.audio import save_wav
from adaptive_voice_conversion_tpu_torch.dsp.features import get_spectrograms
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.models.weights import save_checkpoint
from adaptive_voice_conversion_tpu_torch.tools import (
    make_datasets_libri,
    preprocess_pipeline,
    reduce_dataset,
    sample_single_segments,
)
from adaptive_voice_conversion_tpu_torch.train.solver import Solver, SolverArgs

REPO = Path(__file__).resolve().parents[1]
SEG = 32


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One thread per test worker: the parallel test workers do not
    oversubscribe the cores, and the narrow models train as fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voiced(n, sr, f0, rng):
    """test_inference_and_tools.py's synthetic utterance at any length."""
    t = np.arange(n) / sr
    y = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 3 * f0 * t)
    y *= np.clip(np.sin(np.pi * np.arange(n) / n) * 3, 0, 1)
    return (y + 0.01 * rng.standard_normal(n)).astype(np.float32)


def vctk_corpus(root, sr=48000):
    """wav48/p<spk>/p<spk>_<utt>.wav at 48 kHz (VCTK's rate, resampled to 24
    kHz on load) + speaker-info.txt; no length a whole number of seconds."""
    rng = np.random.default_rng(0)
    lines = ["ID  AGE  GENDER  ACCENTS  REGION"]
    for s in range(4):
        spk = 225 + s
        lines.append(f"{spk}  23  F  English  Somewhere")
        os.makedirs(root / "wav48" / f"p{spk}")
        for u in range(1, 4):
            n = int((0.93 + 0.21 * u + 0.17 * s) * sr)
            save_wav(str(root / "wav48" / f"p{spk}" / f"p{spk}_{u:03d}.wav"),
                     voiced(n, sr, 120 + 40 * s, rng), sr)
    (root / "speaker-info.txt").write_text("\n".join(lines) + "\n")


def libri_corpus(root, sr=24000):
    """<set>/<spk>/<chapter>/<spk>_<chapter>_<utt>.wav."""
    rng = np.random.default_rng(1)
    for dset, n_spk in (("train-clean-100", 3), ("dev-clean", 2)):
        for s in range(n_spk):
            spk = 19 + 7 * s + (100 if dset == "dev-clean" else 0)
            for c in range(2 if dset == "train-clean-100" else 1):
                d = root / dset / str(spk) / str(200 + c)
                os.makedirs(d)
                for u in range(2):
                    n = int((1.07 + 0.31 * u + 0.13 * s + 0.05 * c) * sr)
                    save_wav(str(d / f"{spk}_{200 + c}_{u:06d}.wav"),
                             voiced(n, sr, 110 + 35 * s + 9 * c, rng), sr)


def pipeline_argv(corpus, root, out):
    common = ["--raw_data_dir", str(root), "--data_dir", str(out), "--segment_size", str(SEG),
              "--training_samples", "500", "--testing_samples", "20", "--seed", "0"]
    if corpus == "vctk":
        return ["vctk", *common, "--n_out_speakers", "1", "--test_prop", "0.34",
                "--n_utts_attr", "6"]
    return ["libri", *common, "--dev_prop", "0.25", "--n_utts_attr", "5"]


def narrow_raw():
    """examples/config.yaml with 8 channels where it has 128 or 256."""
    raw = yaml.safe_load((REPO / "examples" / "config.yaml").read_text())
    for k in ("SpeakerEncoder", "ContentEncoder"):
        raw[k].update(c_h=8, c_out=8, c_bank=4)
    raw["Decoder"].update(c_in=8, c_cond=8, c_h=8)
    return raw


def narrow_config():
    return config_from_dict(narrow_raw())


def make_runs(corpus, tmp_path_factory):
    """One corpus through the JAX pipeline (its default, host numpy) and the
    port's with --host and with the batched featurizer on the CPU."""
    d = tmp_path_factory.mktemp(corpus)
    (vctk_corpus if corpus == "vctk" else libri_corpus)(d / "corpus")
    jpipeline.main(pipeline_argv(corpus, d / "corpus", d / "jax"))
    preprocess_pipeline.main(pipeline_argv(corpus, d / "corpus", d / "host") + ["--host"])
    preprocess_pipeline.main(pipeline_argv(corpus, d / "corpus", d / "batched") + ["--device", "cpu"])
    return d


@pytest.fixture(scope="module")
def vctk(tmp_path_factory):
    return make_runs("vctk", tmp_path_factory)


@pytest.fixture(scope="module")
def libri(tmp_path_factory):
    return make_runs("libri", tmp_path_factory)


def load(path):
    if path.suffix == ".pkl":
        with open(path, "rb") as f:
            return pickle.load(f)
    if path.suffix == ".json":
        return json.loads(path.read_text())
    return path.read_text()


def expected_files(corpus):
    splits = ["train", "in_test", "out_test"] if corpus == "vctk" else ["train", "dev", "test"]
    tests = splits[1:]
    names = [f"{s}.pkl" for s in splits] + ["attr.pkl", f"train_{SEG}.pkl"]
    names += [f"{s}_samples_{SEG}.json" for s in splits]
    names += [f"{s}_files.txt" for s in (tests if corpus == "vctk" else splits)]
    return sorted(names)


@pytest.mark.parametrize("corpus", ["vctk", "libri"])
def test_host_run_writes_the_jax_files(corpus, request):
    d = request.getfixturevalue(corpus)
    names = expected_files(corpus)
    assert sorted(os.listdir(d / "jax")) == sorted(os.listdir(d / "host")) == names
    for name in names:
        ours, ref = load(d / "host" / name), load(d / "jax" / name)
        if name.endswith(".pkl"):
            assert list(ours) == list(ref), name
            for k in ref:
                assert ours[k].dtype == ref[k].dtype
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=f"{name}:{k}")
        else:
            assert ours == ref, name


@pytest.mark.parametrize("corpus", ["vctk", "libri"])
def test_batched_run_matches_the_host_run(corpus, request):
    """Mels on the [0, 1] scale (each run's pickle denormalized with its own
    attr) within 5e-4 on every frame; attr within 1e-5 relative; the
    indexes and file lists equal."""
    d = request.getfixturevalue(corpus)
    names = expected_files(corpus)
    assert sorted(os.listdir(d / "batched")) == names
    attr_b, attr_h = load(d / "batched" / "attr.pkl"), load(d / "host" / "attr.pkl")
    for key in ("mean", "std"):
        np.testing.assert_allclose(attr_b[key], attr_h[key], rtol=1e-5, atol=0)
    n_frames = 0
    for name in names:
        ours, ref = load(d / "batched" / name), load(d / "host" / name)
        if name == "attr.pkl":
            continue
        if name.endswith(".pkl"):
            assert list(ours) == list(ref), name
            for k in ref:
                mel_b = ours[k] * attr_b["std"] + attr_b["mean"]
                mel_h = ref[k] * attr_h["std"] + attr_h["mean"]
                assert mel_b.shape == mel_h.shape and ours[k].dtype == np.float32
                np.testing.assert_allclose(mel_b, mel_h, atol=5e-4, err_msg=f"{name}:{k}")
                n_frames += len(mel_h)
        else:
            assert ours == ref, name
    assert n_frames > 1000


def test_tpu_flag_selects_the_batched_featurizer(libri, tmp_path):
    d = libri
    make_datasets_libri.main([str(d / "corpus"), str(tmp_path), "0.25", "5", "train-clean-100",
                              "dev-clean", "--tpu", "--device", "cpu", "--seed", "0"])
    for name in ("train.pkl", "attr.pkl", "test.pkl"):
        a, b = load(tmp_path / name), load(d / "batched" / name)
        assert list(a) == list(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(SystemExit):
        preprocess_pipeline.main(pipeline_argv("libri", d / "corpus", tmp_path / "x") + ["--host", "--tpu"])


def test_stage_clis_equal_jax(libri, tmp_path):
    """reduce_dataset and sample_single_segments run on their own, with and
    without their optional arguments."""
    train = str(libri / "host" / "train.pkl")
    for extra in ([], ["100"]):
        reduce_dataset.main([train, str(tmp_path / "r.pkl"), *extra])
        jreduce.main([train, str(tmp_path / "j.pkl"), *extra])
        ours, ref = load(tmp_path / "r.pkl"), load(tmp_path / "j.pkl")
        assert list(ours) == list(ref)
        assert all(np.array_equal(ours[k], ref[k]) for k in ref)
    for seed in (["--seed", "5"], []):
        sample_single_segments.main([train, str(tmp_path / "s.json"), "50", "24"] + seed)
        jsample.main([train, str(tmp_path / "js.json"), "50", "24"] + seed)
        ours, ref = load(tmp_path / "s.json"), load(tmp_path / "js.json")
        assert len(ours) == len(ref) == 50
        if seed:
            assert ours == ref


def test_wavs_to_dataset_to_training_to_conversion_on_cpu(vctk, tmp_path):
    """The port's whole system on the CPU: its dataset, 4 Solver steps at
    batch 8 and segment 32 (a narrow model at the 512-mel width; the card
    runs the full width), the training checkpoint served by the one-shot
    path with 4 Griffin-Lim iterations; the target is a held-out speaker's
    wav."""
    data = vctk / "batched"
    cfg = dataclasses.replace(
        narrow_config(), data_loader=DataLoaderConfig(segment_size=SEG, frame_size=1, batch_size=8)
    )
    args = SolverArgs(
        data_dir=str(data), train_set=f"train_{SEG}", train_index_file=f"train_samples_{SEG}.json",
        logdir=str(tmp_path / "log"), store_model_path=str(tmp_path / "model"),
        summary_steps=2, save_steps=100,
    )
    m = Solver(cfg, args, device="cpu").train(4, log_every_print=False)
    assert np.isfinite(m["loss"])
    inf = Inferencer.from_train_checkpoint(cfg, str(tmp_path / "model"), str(data / "attr.pkl"),
                                           device="cpu", gl_method="fused")
    inf.config = dataclasses.replace(inf.config, signal=dataclasses.replace(cfg.signal, n_iter=4))
    out_test = (data / "out_test_files.txt").read_text().split()
    in_test = (data / "in_test_files.txt").read_text().split()
    wav = inf.inference_from_path(in_test[0], out_test[0], str(tmp_path / "converted.wav"))
    sr, written = wavfile.read(tmp_path / "converted.wav")
    assert sr == cfg.signal.sr and np.array_equal(written, wav)
    assert np.isfinite(wav).all() and len(wav) > 1000


# -- the CPU vocoder: the numpy oracle ----------------------------------------

SMALL = dict(sr=8000, n_fft=256, hop_length=64, win_length=192, n_mels=40)


@pytest.mark.parametrize("sig", [dict(SMALL, n_iter=6), dict(n_iter=3)], ids=["small", "full"])
def test_numpy_vocoder_equals_jax_bit_for_bit(sig):
    cfg, jcfg = SignalConfig(**sig), JSignal(**sig)
    rng = np.random.default_rng(4)
    mel = np.clip(0.55 + 0.15 * rng.standard_normal((37, cfg.n_mels)), 0, 1).astype(np.float32)
    mag = vocoder.mel_to_mag_np(mel, cfg)
    np.testing.assert_array_equal(mag, jvoc.mel_to_mag(mel, jcfg))
    np.testing.assert_array_equal(vocoder.griffin_lim_np(mag, cfg), jvoc.griffin_lim_np(mag, jcfg))
    np.testing.assert_array_equal(vocoder.griffin_lim_np(mag, cfg, n_iter=2),
                                  jvoc.griffin_lim_np(mag, jcfg, n_iter=2))
    ours = vocoder.melspectrogram2wav_np(mel, cfg)
    assert ours.dtype == np.float32 and len(ours) > 0
    np.testing.assert_array_equal(ours, jvoc.melspectrogram2wav(mel, jcfg))


# The converted mels of the two packages differ by the model's f32 rounding
# (the Inferencer parity test holds them to 1e-4; here they were 1.7e-6
# apart), and the 12 exact Griffin-Lim iterations carry that into the wav
# about 37-fold (6.2e-5 of the wav's peak measured). The JAX package's 1e-4
# mel tolerance carried through so would allow 3.7e-3; the wavs are held to
# 1e-3 of their peak, and to the same length.
TOL_CPU_VOCODER_WAV = 1e-3


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A narrow model at the 512-mel width, 12 Griffin-Lim iterations, two
    seeded 0.5 s wavs, their attr.pkl and a reference-format checkpoint."""
    d = tmp_path_factory.mktemp("cpu_vocoder")
    raw = narrow_raw()
    raw["signal"] = {"n_iter": 12}
    (d / "config.yaml").write_text(yaml.safe_dump(raw))
    cfg = config_from_dict(raw)
    rng = np.random.default_rng(0)
    for name, f0 in (("source", 140.0), ("target", 210.0)):
        save_wav(str(d / f"{name}.wav"), voiced(12000, 24000, f0, rng), 24000)
    mels = np.concatenate([get_spectrograms(str(d / f"{n}.wav"))[0] for n in ("source", "target")])
    with open(d / "attr.pkl", "wb") as f:
        pickle.dump({"mean": mels.mean(0), "std": mels.std(0)}, f)
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    save_checkpoint(model, str(d / "model.ckpt"))
    return d, cfg


def test_cpu_vocoder_is_the_jax_packages(assets):
    """Inferencer(gpu_vocoder=False) vocodes with the numpy oracle whatever
    gl_method is, as JAX's use_tpu_vocoder=False does."""
    d, cfg = assets
    ckpt, attr = str(d / "model.ckpt"), str(d / "attr.pkl")
    j = JInferencer.from_torch_checkpoint(cfg, ckpt, attr, use_tpu_vocoder=False)
    src = get_spectrograms(str(d / "source.wav"))[0]
    tar = get_spectrograms(str(d / "target.wav"))[0]
    wav_j, dec_j = j.inference_one_utterance(j.normalize(src), j.normalize(tar))
    for method in ("fused", "exact", "pallas"):
        t = Inferencer.from_torch_checkpoint(cfg, ckpt, attr, device="cpu", gl_method=method,
                                             gpu_vocoder=False)
        wav_t, dec_t = t.inference_one_utterance(t.normalize(src), t.normalize(tar))
        np.testing.assert_allclose(dec_t, np.asarray(dec_j), atol=1e-4)
        # on this Inferencer's own mel, the wav is the oracle's bit for bit
        np.testing.assert_array_equal(wav_t, vocoder.melspectrogram2wav_np(dec_t, cfg.signal))
        assert wav_t.shape == wav_j.shape
        err = float(np.abs(wav_t - wav_j).max() / np.abs(wav_j).max())
        assert err <= TOL_CPU_VOCODER_WAV, (method, err)


def test_cli_cpu_vocoder_writes_the_oracles_wav(assets):
    d, cfg = assets
    out = d / "cli_cpu_vocoder.wav"
    inference_main(["-a", str(d / "attr.pkl"), "-c", str(d / "config.yaml"), "-m", str(d / "model.ckpt"),
                    "-s", str(d / "source.wav"), "-t", str(d / "target.wav"), "-o", str(out),
                    "--device", "cpu", "--cpu_vocoder", "--gl_method", "fused"])
    t = Inferencer.from_torch_checkpoint(cfg, str(d / "model.ckpt"), str(d / "attr.pkl"), device="cpu")
    src = t.normalize(get_spectrograms(str(d / "source.wav"))[0])
    tar = t.normalize(get_spectrograms(str(d / "target.wav"))[0])
    dec = t.denormalize(t.convert_mel(src, tar))
    _, wav = wavfile.read(out)
    np.testing.assert_array_equal(wav, vocoder.melspectrogram2wav_np(dec, cfg.signal))
