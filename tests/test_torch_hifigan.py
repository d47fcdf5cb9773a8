"""The HiFi-GAN generator (models/hifigan.py) as the port's second vocoder,
on the CPU at tiny widths: against its plain reference
(vc_bench/reference/hifigan.py), a ragged batch against each row alone, weight-norm
folding and the checkpoint's key layout, the Inferencer's batched and
one-shot paths and both CLIs against the plain AdaIN model followed by the
plain generator, the counters, and the Griffin-Lim default.

Tolerances: 1e-5 relative (Frobenius) in f32, where the port and the
reference run the same convolutions in the same order but at other batch
shapes (the CPU's convolutions sum in another order at another batch
size; the readings are ~5e-7)."""

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile
from torch.profiler import ProfilerActivity, profile

from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.dsp.audio import save_wav, trim_silence
from adaptive_voice_conversion_tpu_torch.dsp.features import get_spectrograms
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.hifigan import Generator
from adaptive_voice_conversion_tpu_torch.models.weights import (
    fold_weight_norm,
    load_generator,
    save_checkpoint,
)
from adaptive_voice_conversion_tpu_torch.utils import profiling
from vc_bench.reference import hifigan as ref
from vc_bench.reference.model import Net, make_params
from vc_bench.tests.tiny import tiny_config

REPO = Path(__file__).resolve().parents[1]
TINY_VOC = dict(kind="hifigan", in_channels=16, channels=32, upsample_scales=(2, 3),
                upsample_kernel_sizes=(4, 6))
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def voc_dict(cfg: tcfg.VocoderConfig) -> dict:
    return {k: ([list(x) if isinstance(x, tuple) else x for x in v] if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(cfg).items()}


def tiny_generator(seed: int = 3, **kw):
    cfg = tcfg.VocoderConfig(**dict(TINY_VOC, **kw))
    params = ref.make_params(voc_dict(cfg), seed, "cpu")
    gen = Generator(cfg)
    gen.load_state_dict(params, strict=True)
    return gen.eval(), params, voc_dict(cfg)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("frames", [1, 9, 31])
def test_the_generator_equals_the_plain_reference(frames):
    gen, params, voc = tiny_generator()
    mel = torch.randn(frames, 16, generator=torch.Generator().manual_seed(frames))
    with torch.no_grad():
        ours = gen.generate(mel[None])[0]
        unbatched = gen(mel.t()[None])[0, 0]
    theirs = ref.generate(mel, params, voc)
    assert ours.shape == theirs.shape == (6 * frames,)
    assert rel(ours, theirs) <= RTOL
    assert torch.equal(ours, unbatched)


def test_a_ragged_batch_equals_each_row_alone():
    """Each row at its own length, and zero past it: the masks make the
    padding (filled with noise here, as a decoder's tail is) invisible."""
    gen, params, voc = tiny_generator(seed=5)
    lens = [23, 7, 16, 1]
    g = torch.Generator().manual_seed(0)
    batch = torch.randn(len(lens), 23, 16, generator=g)
    with torch.no_grad():
        wavs = gen.generate(batch, torch.tensor(lens))
        unmasked = gen.generate(batch)
    assert wavs.shape == (4, 6 * 23)
    for b, n in enumerate(lens):
        with torch.no_grad():
            alone = gen.generate(batch[b : b + 1, :n])[0]
        assert rel(wavs[b, : 6 * n], alone) <= RTOL
        assert rel(wavs[b, : 6 * n], ref.generate(batch[b, :n], params, voc)) <= RTOL
        assert not wavs[b, 6 * n :].any()
    # without the masks the padding leaks into the short rows
    assert rel(unmasked[1, :42], wavs[1, :42]) > 1e-2


def weight_normed_state_dict(gen: Generator) -> dict:
    """The generator's convolutions weight-normed as the recipe trains them
    (``torch.nn.utils.weight_norm``, dim 0), and their state_dict."""
    wn = Generator(gen.cfg)
    wn.load_state_dict(gen.state_dict())
    for m in wn.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            with pytest.warns(FutureWarning):
                torch.nn.utils.weight_norm(m)
            with torch.no_grad():  # a g apart from ||v||, as after training
                m.weight_g.mul_(1.5)
    return wn


def test_weight_norm_folds_into_the_plain_layout(tmp_path):
    gen, _, _ = tiny_generator()
    wn = weight_normed_state_dict(gen)
    sd = wn.state_dict()
    assert "input_conv.weight_g" in sd and "upsamples.1.1.weight_v" in sd
    assert "blocks.5.convs2.2.1.weight_g" in sd and "output_conv.1.weight_v" in sd
    assert not any(k.endswith(".weight") for k in sd)
    folded = fold_weight_norm(sd)
    assert set(folded) == set(gen.state_dict())
    mel = torch.randn(2, 11, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        expected = wn(mel.transpose(1, 2))[:, 0]
    # a bare state_dict and a ParallelWaveGAN training checkpoint load strictly
    for i, blob in enumerate([sd, {"model": {"generator": sd, "discriminator": {}}, "steps": 1}]):
        path = tmp_path / f"g{i}.pkl"
        torch.save(blob, path)
        loaded = load_generator(str(path), gen.cfg, "cpu")
        with torch.no_grad():
            assert rel(loaded.generate(mel), expected) <= RTOL
    # a key missing or left over fails the strict load
    for bad in ({k: v for k, v in sd.items() if not k.startswith("output_conv")},
                dict(sd, **{"extra.weight": torch.zeros(1)})):
        torch.save(bad, tmp_path / "bad.pkl")
        with pytest.raises(RuntimeError):
            load_generator(str(tmp_path / "bad.pkl"), gen.cfg, "cpu")
    with pytest.raises(KeyError):
        fold_weight_norm({"input_conv.weight_g": sd["input_conv.weight_g"]})


def test_the_key_layout_is_parallelwavegans():
    gen = Generator(tcfg.VocoderConfig(kind="hifigan"))
    keys = set(gen.state_dict())
    assert {"input_conv.weight", "upsamples.0.1.weight", "upsamples.3.1.bias",
            "blocks.0.convs1.0.1.weight", "blocks.11.convs2.2.1.bias", "output_conv.1.weight"} <= keys
    assert len(keys) == 2 * (1 + 4 + 4 * 3 * 6 + 1)
    assert sum(p.numel() for p in gen.parameters()) == 14_528_129
    shapes = {k: tuple(v.shape) for k, v in gen.state_dict().items()}
    assert shapes == dict(ref.param_shapes(voc_dict(gen.cfg)))


# -- the Inferencer ---------------------------------------------------------

N_MELS = 16
SIGNAL = dict(hop_length=6, win_length=24, n_iter=3)


def tiny_raw(vocoder: bool = True) -> dict:
    """The benchmark's tiny AdaIN-VC (16 mels) at hop 6, and the tiny generator."""
    raw = tiny_config()
    raw["signal"].update(SIGNAL)
    if vocoder:
        raw["vocoder"] = voc_dict(tcfg.VocoderConfig(**TINY_VOC))
    return raw


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """An Inferencer on a tiny adain_vc_hifigan-shaped config, and the
    weights the plain references take."""
    torch.set_num_threads(2)
    raw = tiny_raw()
    cfg = tcfg.config_from_dict(raw)
    params = make_params(raw, 21, "cpu")
    model = AE(cfg.model)
    model.load_state_dict(params, strict=True)
    gen_params = ref.make_params(raw["vocoder"], 22, "cpu")
    gen = Generator(cfg.vocoder)
    gen.load_state_dict(gen_params, strict=True)
    rng = np.random.default_rng(3)
    attr = {"mean": rng.random(N_MELS).astype(np.float32),
            "std": (0.5 + rng.random(N_MELS)).astype(np.float32)}
    path = tmp_path_factory.mktemp("hifigan") / "attr.pkl"
    with open(path, "wb") as f:
        pickle.dump(attr, f)
    inf = Inferencer(cfg, model, str(path), device="cpu", vocoder=gen)
    return inf, raw, params, gen_params


def plain_pair(raw, params, gen_params, src, tar) -> np.ndarray:
    """The plain AdaIN model, then the plain generator, on one pair."""
    with torch.no_grad():
        mel = Net(raw, params).inference(torch.from_numpy(src), torch.from_numpy(tar))
    return ref.generate(mel, gen_params, raw["vocoder"]).numpy()


def mels(frames, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, N_MELS)).astype(np.float32) for n in frames]


@pytest.mark.parametrize("len_bucket", [1, 16])
def test_convert_grid_equals_the_plain_references_pair_by_pair(served, len_bucket):
    inf, raw, params, gen_params = served
    srcs, tars = mels([21, 34, 13], 1), mels([40, 27], 2)
    wavs = inf.convert_grid(srcs, tars, trim=False, len_bucket=len_bucket)
    pairs = inf.convert_pairs([(srcs[0], tars[1]), (srcs[2], tars[0])], trim=False)
    trimmed = inf.convert_grid(srcs, tars, len_bucket=len_bucket)
    trimmed_pairs = inf.convert_pairs([(srcs[0], tars[1]), (srcs[2], tars[0])])
    hop = SIGNAL["hop_length"]
    for i, s in enumerate(srcs):
        for j, t in enumerate(tars):
            want = plain_pair(raw, params, gen_params, s, t)[: hop * (len(s) - 1)]
            got = wavs[i * len(tars) + j]
            assert got.shape == want.shape and rel(torch.from_numpy(got), torch.from_numpy(want)) <= RTOL
            np.testing.assert_array_equal(trimmed[i * len(tars) + j], trim_silence(got, top_db=60.0)[0])
    for (i, j), got, cut in zip([(0, 1), (2, 0)], pairs, trimmed_pairs):
        np.testing.assert_allclose(got, wavs[i * len(tars) + j], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(cut, trim_silence(got, top_db=60.0)[0])


def test_a_uniform_grid_runs_unmasked_and_equal(served):
    inf, raw, params, gen_params = served
    srcs, tars = mels([24, 24], 4), mels([16], 5)
    wavs = inf.convert_grid(srcs, tars, trim=False)
    for i, s in enumerate(srcs):
        want = plain_pair(raw, params, gen_params, s, tars[0])[: SIGNAL["hop_length"] * 23]
        assert rel(torch.from_numpy(wavs[i]), torch.from_numpy(want)) <= RTOL


def test_one_utterance_equals_the_plain_references(served):
    inf, raw, params, gen_params = served
    src, tar = mels([29, 18], 6)
    wav, dec = inf.inference_one_utterance(src, tar)
    want, _ = trim_silence(plain_pair(raw, params, gen_params, src, tar), top_db=60.0)
    assert wav.dtype == np.float32 and wav.shape == want.shape
    assert rel(torch.from_numpy(wav), torch.from_numpy(want)) <= RTOL
    with torch.no_grad():  # the same generator call, trimmed on the host
        whole = inf.vocoder.generate(torch.from_numpy(inf.convert_mel(src, tar))[None])[0].numpy()
    np.testing.assert_array_equal(wav, trim_silence(whole, top_db=60.0)[0])
    assert dec.shape == (32, N_MELS)  # denormalised, as with Griffin-Lim


def test_the_counters_are_silent_without_a_profiler_and_summed_with_one(served, monkeypatch):
    inf = served[0]
    log = profiling.CounterLog(cap=1_000_000)
    monkeypatch.setattr(profiling, "COUNTER_LOG", log)
    srcs, tars = mels([21, 13], 7), mels([19, 30, 9], 8)
    whole = [inf.convert_grid(srcs, tars, len_bucket=16, trim=False), inf.convert_grid(srcs, tars, trim=False)]
    assert log.counts == []
    with profile(activities=[ProfilerActivity.CPU]):
        served = [inf.convert_grid(srcs, tars, len_bucket=16), inf.convert_grid(srcs, tars)]
    names = [n for n, _, _ in log.counts]
    assert names == ["voc.computed_samples", "voc.samples", "voc.junctions", "voc.fused_junctions"] * 2
    hop = SIGNAL["hop_length"]
    # sources pad to 32 (16) frames; their decoder lengths are 24 and 16
    valid = 3 * (24 + 16) * hop
    assert profiling.counter_total("voc.samples", 0, 2**63) == 2 * valid
    assert profiling.counter_total("voc.computed_samples", 0, 2**63) == 6 * (32 + 24) * hop
    t_mid = log.counts[4][1]
    assert profiling.counter_total("voc.samples", 0, t_mid - 1) == valid
    for wavs, cut in zip(whole, served):  # every pair served, trimmed
        assert len(cut) == len(wavs) == 6
        for w, c in zip(wavs, cut):
            np.testing.assert_array_equal(c, trim_silence(w, top_db=60.0)[0])


def test_the_generator_path_emits_its_spans_in_order_and_flat(served, monkeypatch):
    inf = served[0]
    log = profiling.SpanLog(cap=1_000_000)
    monkeypatch.setattr(profiling, "SPAN_LOG", log)
    counts = profiling.CounterLog(cap=1_000_000)
    monkeypatch.setattr(profiling, "COUNTER_LOG", counts)
    srcs, tars = mels([21, 13], 11), mels([19, 30], 12)
    plain = [inf.convert_grid(srcs, tars), inf.inference_one_utterance(srcs[0], tars[0])[0]]
    with profile(activities=[ProfilerActivity.CPU]):
        traced = [inf.convert_grid(srcs, tars), inf.inference_one_utterance(srcs[0], tars[0])[0]]
    trim = ["dsp.trim", "infer.to_host", "dsp.trim"]  # bounds on the device, one copy, slices
    # the one-shot path: the model's output stays on the device for the
    # generator; the denormalised mel crosses last
    assert [n for n, _, _ in log.spans] == (
        ["infer.assemble", "infer.assemble", "infer.model", "infer.generate"] + trim
        + ["infer.assemble", "infer.model", "infer.generate"] + trim + ["infer.to_host"])
    assert [n for n, _, _ in counts.counts] == [
        "voc.computed_samples", "voc.samples", "voc.junctions", "voc.fused_junctions"] * 2
    for a, b in zip(plain[0] + plain[1:], traced[0] + traced[1:]):  # 4 trimmed pairs, 1 one-shot
        np.testing.assert_array_equal(a, b)
    for (_, _, end), (_, start, _) in zip(log.spans, log.spans[1:]):
        assert start >= end


def test_a_config_without_a_vocoder_runs_griffin_lim(served, tmp_path):
    inf, raw, params, _ = served
    raw_gl = tiny_raw(vocoder=False)
    cfg = tcfg.config_from_dict(raw_gl)
    assert cfg.vocoder == tcfg.VocoderConfig() and cfg.vocoder.kind == "griffin_lim"
    assert "vocoder" not in tcfg.config_to_dict(cfg)
    model = AE(cfg.model)
    model.load_state_dict(params, strict=True)
    attr = tmp_path / "attr.pkl"
    with open(attr, "wb") as f:
        pickle.dump(inf.attr, f)
    gl = Inferencer(cfg, model, str(attr), device="cpu")
    assert gl.vocoder is None
    srcs, tars = mels([21, 13], 9), mels([19], 10)
    wavs = gl.convert_grid(srcs, tars, trim=False, gl_iters=2)
    assert [len(w) for w in wavs] == [SIGNAL["hop_length"] * 20, SIGNAL["hop_length"] * 12]
    # the generator's wavs differ from Griffin-Lim's
    assert not np.allclose(inf.convert_grid(srcs, tars, trim=False)[0], wavs[0])
    with pytest.raises(ValueError, match="Griffin-Lim"):
        Inferencer(cfg, model, str(attr), device="cpu", vocoder=inf.vocoder)
    hcfg = tcfg.config_from_dict(tiny_raw())
    with pytest.raises(ValueError, match="vocoder_ckpt"):
        Inferencer(hcfg, model, str(attr), device="cpu")
    with pytest.raises(ValueError, match="gpu_vocoder"):
        Inferencer(hcfg, model, str(attr), device="cpu", vocoder=inf.vocoder, gpu_vocoder=False)


def test_the_vocoder_section_parses_round_trips_and_is_checked():
    cfg = tcfg.config_from_dict(tiny_raw())
    assert cfg.vocoder.resblock_dilations == ((1, 3, 5),) * 3
    assert tcfg.config_from_dict(tcfg.config_to_dict(cfg)) == cfg
    published = tcfg.config_from_dict({"vocoder": {"kind": "hifigan"}}).vocoder
    assert (published.upsample_scales, published.in_channels) == ((5, 5, 4, 3), 512)
    bad = [{"kind": "wavenet"}, dict(TINY_VOC, upsample_scales=[2, 2]),
           dict(TINY_VOC, upsample_kernel_sizes=[4, 7]), dict(TINY_VOC, in_channels=80),
           dict(TINY_VOC, resblock_dilations=[[1, 3, 5]])]
    for voc in bad:
        raw = tiny_raw()
        raw["vocoder"] = voc
        with pytest.raises(ValueError):
            tcfg.config_from_dict(raw)


# -- the CLIs -----------------------------------------------------------------

SR = 24000


@pytest.fixture(scope="module")
def cli_assets(tmp_path_factory):
    """A narrow AdaIN model and a narrow generator (32 channels, the
    published scales) at the 512-mel, 24 kHz signal; two 0.4 s wavs; a
    weight-normed generator checkpoint."""
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("cli")
    raw = yaml.safe_load((REPO / "examples" / "config.yaml").read_text())
    for k in ("SpeakerEncoder", "ContentEncoder"):
        raw[k].update(c_h=8, c_out=8, c_bank=4)
    raw["Decoder"].update(c_in=8, c_cond=8, c_h=8)
    raw["vocoder"] = {"kind": "hifigan", "channels": 32}
    (d / "config.yaml").write_text(yaml.safe_dump(raw))
    cfg = tcfg.config_from_dict(raw)
    t = np.arange(int(0.4 * SR)) / SR
    for name, f0 in (("source", 140.0), ("target", 210.0)):
        save_wav(str(d / f"{name}.wav"), (0.4 * np.sin(2 * np.pi * f0 * t)).astype(np.float32), SR)
    mel = np.concatenate([get_spectrograms(str(d / f"{n}.wav"))[0] for n in ("source", "target")])
    with open(d / "attr.pkl", "wb") as f:
        pickle.dump({"mean": mel.mean(0), "std": mel.std(0) + 1e-3}, f)
    model = AE(cfg.model)
    model.load_state_dict(make_params(raw, 5, "cpu"), strict=True)
    save_checkpoint(model, str(d / "model.ckpt"))
    gen = Generator(cfg.vocoder)
    gen.load_state_dict(ref.make_params(voc_dict(cfg.vocoder), 6, "cpu"), strict=True)
    torch.save(weight_normed_state_dict(gen).state_dict(), d / "generator.pkl")
    return d, cfg, load_generator(str(d / "generator.pkl"), cfg.vocoder, "cpu")


def test_both_clis_vocode_with_the_generator(cli_assets):
    from adaptive_voice_conversion_tpu_torch.cli import convert_grid, inference

    d, cfg, gen = cli_assets
    common = ["-a", str(d / "attr.pkl"), "-c", str(d / "config.yaml"), "-m", str(d / "model.ckpt"),
              "--device", "cpu", "--vocoder_ckpt", str(d / "generator.pkl")]
    inference.main(common + ["-s", str(d / "source.wav"), "-t", str(d / "target.wav"),
                             "-o", str(d / "one.wav")])
    convert_grid.main(common + ["-s", str(d / "source.wav"), "-t", str(d / "target.wav"),
                                str(d / "source.wav"), "-o", str(d / "grid"), "--gl_method", "fused"])
    inf = Inferencer.from_model_path(cfg, str(d / "model.ckpt"), str(d / "attr.pkl"), device="cpu",
                                     vocoder=gen)
    norm = lambda n: inf.normalize(get_spectrograms(str(d / f"{n}.wav"))[0])
    want, _ = inf.inference_one_utterance(norm("source"), norm("target"))
    sr, one = wavfile.read(d / "one.wav")
    assert sr == SR and one.shape == want.shape
    np.testing.assert_allclose(one, want, rtol=0, atol=1e-5 * np.abs(want).max())
    grid = inf.convert_grid([norm("source")], [norm("target"), norm("source")])
    _, first = wavfile.read(d / "grid" / "source__to__target.wav")
    assert first.shape == grid[0].shape and (d / "grid" / "source__to__source.wav").exists()
    np.testing.assert_allclose(first, grid[0], rtol=0, atol=1e-5 * np.abs(grid[0]).max())
    with pytest.raises(ValueError, match="vocoder_ckpt"):
        inference.main(common[:-2] + ["-s", str(d / "source.wav"), "-t", str(d / "target.wav"),
                                      "-o", str(d / "none.wav")])
