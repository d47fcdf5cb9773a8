"""Training the HiFi-GAN V1 vocoder (train/vocoder.py,
models/hifigan_disc.py) on the CPU at tiny widths, against the plain
reference (vc_bench/reference/hifigan_train.py) and against PyTorch's own
weight norm, spectral norm and AdamW.

Tolerances: 1e-5 relative in f32, where both sides run the same
convolutions in the same order; the readings are ~1e-7."""

import dataclasses
import hashlib
import pickle
import types

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.hifigan import Generator, apply_weight_norm, weight_norm
from adaptive_voice_conversion_tpu_torch.models.hifigan_disc import Discriminator, spectral_norm
from adaptive_voice_conversion_tpu_torch.models.weights import load_generator
from adaptive_voice_conversion_tpu_torch.train import vocoder as tv
from adaptive_voice_conversion_tpu_torch.train.optim import TorchAdam
from adaptive_voice_conversion_tpu_torch.utils import profiling
from vc_bench.drivers import train_hifigan
from vc_bench.reference import hifigan as ref_gen
from vc_bench.reference import hifigan_train as ref
from vc_bench.reference.model import Net, make_params
from vc_bench.tests.tiny_vocoder import tiny_train_config

RTOL = 1e-5
SEED = 2**31 + 17


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def networks(raw: dict, seed: int = SEED):
    """The program's generator and discriminators holding the reference's
    weights, and those weights."""
    cfg = tcfg.config_from_dict(raw)
    gen0 = ref.make_gen_params(raw["vocoder"], seed, "cpu")
    disc0 = ref.make_disc_params(raw["vocoder_train"], seed + 1, "cpu")
    generator, disc = apply_weight_norm(Generator(cfg.vocoder)), Discriminator(cfg.vocoder_train)
    generator.load_state_dict(gen0, strict=True)
    disc.load_state_dict(disc0, strict=True)
    return cfg, generator, disc, gen0, disc0


def corpus(cfg, n: int = 12, seed: int = 4, device: str = "cpu"):
    rng = np.random.default_rng(seed)
    waves = [0.2 * rng.standard_normal(int(rng.integers(900, 2400))).astype(np.float32) for _ in range(n)]
    return tv.WaveCorpus(waves, cfg.signal, cfg.vocoder_train.segment_samples, torch.device(device), 10**9)


def attr(n_mels: int = 16):
    rng = np.random.default_rng(9)
    return {"mean": (0.4 + 0.2 * rng.random(n_mels)).astype(np.float32),
            "std": (0.1 + 0.1 * rng.random(n_mels)).astype(np.float32)}


def test_the_discriminators_equal_the_plain_reference_feature_maps_included():
    raw = tiny_train_config()
    _, _, disc, _, disc0 = networks(raw)
    y = 0.3 * torch.randn(2, 1, 320, generator=torch.Generator().manual_seed(1))
    y_hat = 0.3 * torch.randn(2, 1, 320, generator=torch.Generator().manual_seed(2))
    params = {k: v.clone() for k, v in disc0.items()}
    ours = disc(y, y_hat)
    theirs = ref.discriminators(y, y_hat, params, raw["vocoder_train"])
    n_sub = len(raw["vocoder_train"]["mpd_periods"]) + raw["vocoder_train"]["msd_scales"]
    for a_list, b_list in zip(ours[:2], theirs[:2]):
        assert len(a_list) == len(b_list) == n_sub
        for a, b in zip(a_list, b_list):
            assert a.shape == b.shape and rel(a, b) <= RTOL
    for a_maps, b_maps in zip(ours[2] + ours[3], theirs[2] + theirs[3]):
        assert len(a_maps) == len(b_maps)
        for a, b in zip(a_maps, b_maps):
            assert a.shape == b.shape and rel(a, b) <= RTOL
    for name, buf in disc.named_buffers():
        torch.testing.assert_close(buf, params[name], rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_gan_steps_equal_the_plain_reference(n_steps):
    raw = tiny_train_config()
    cfg, _, _, gen0, disc0 = networks(raw)
    data, a = corpus(cfg), attr()
    nets = train_hifigan.build(cfg, gen0, disc0, torch.device("cpu"))
    ours = train_hifigan.program_steps(cfg, *nets, gen0, disc0, data, a, 5, n_steps)
    theirs = ref.reference_steps(raw, gen0, disc0, data.packed, data.starts, a, 5, n_steps)
    assert set(ours["grad1"]) == set(theirs["grad1"]) and set(ours["change"]) == set(theirs["change"])
    gaps = ref.compare_steps(ours, theirs)
    # the change takes AdamW's first steps, g / (|g| + eps): elements whose
    # gradient is near eps move by their rounding; the readings are ~2e-5
    assert max(gaps["loss_gap"], gaps["grad_gap"], gaps["grad_dist"]) <= RTOL, gaps
    assert gaps["change_gap"] <= 10 * RTOL, gaps


def test_the_check_steps_leave_the_networks_and_optimisers_as_built():
    """The benchmark's check runs its steps on the objects it then times,
    and ``restore`` puts them back: the next steps equal those of objects
    just built, bit for bit."""
    raw = tiny_train_config()
    cfg, _, _, gen0, disc0 = networks(raw)
    data, a = corpus(cfg), attr()
    runs = []
    for checked in (True, False):
        nets = train_hifigan.build(cfg, gen0, disc0, torch.device("cpu"))
        if checked:
            train_hifigan.program_steps(cfg, *nets, gen0, disc0, data, a, 5, 2)
            train_hifigan.restore(*nets, gen0, disc0)
        losses = tv.make_vocoder_train_step(cfg, *nets, a, 2)(data.packed, data.starts, 5, 0)
        runs.append((losses, nets[0].state_dict(), nets[1].state_dict(), nets[2].state_dict()))
    (l1, g1, d1, o1), (l2, g2, d2, o2) = runs
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
    for x, y in ((g1, g2), (d1, d2)):
        assert list(x) == list(y)
        for k in x:
            torch.testing.assert_close(x[k], y[k], rtol=0, atol=0)
    assert [float(s["step"]) for s in o1["state"].values()] == [float(s["step"]) for s in o2["state"].values()]


def test_weight_norm_is_torchs():
    conv = nn.Conv1d(6, 5, 3)
    theirs = nn.utils.weight_norm(_plain_copy(conv))
    ours = weight_norm(_plain_copy(conv))
    assert list(ours.state_dict()) == list(theirs.state_dict()) == ["bias", "weight_g", "weight_v"]
    x = torch.randn(2, 6, 11, requires_grad=True)
    for p, q in zip(ours.parameters(), theirs.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    a, b = ours(x), theirs(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ga = torch.autograd.grad(a.square().sum(), list(ours.parameters()))
    gb = torch.autograd.grad(b.square().sum(), list(theirs.parameters()))
    for p, q in zip(ga, gb):
        torch.testing.assert_close(p, q, rtol=RTOL, atol=0)
    up = weight_norm(nn.ConvTranspose1d(4, 3, 6, 3))
    assert up.weight_g.shape == (4, 1, 1)


def _plain_copy(conv: nn.Module) -> nn.Module:
    out = nn.Conv1d(conv.in_channels, conv.out_channels, conv.kernel_size[0])
    out.load_state_dict(conv.state_dict())
    return out


def test_spectral_norm_is_torchs_and_u_advances_four_times_a_step():
    torch.manual_seed(0)
    conv = nn.Conv1d(4, 8, 5, groups=2, padding=2)
    theirs = nn.utils.spectral_norm(nn.Conv1d(4, 8, 5, groups=2, padding=2))
    ours = spectral_norm(nn.Conv1d(4, 8, 5, groups=2, padding=2))
    for m in (theirs, ours):
        m.weight_orig.data.copy_(conv.weight.data)
        m.bias.data.copy_(conv.bias.data)
    ours.weight_u.copy_(theirs.weight_u)
    ours.weight_v.copy_(theirs.weight_v)
    assert sorted(ours.state_dict()) == sorted(theirs.state_dict())
    x = torch.randn(3, 4, 20)
    for _ in range(4):
        a, b = ours(x), theirs(x)
        assert rel(a, b) <= RTOL
        torch.testing.assert_close(ours.weight_u, theirs.weight_u, rtol=RTOL, atol=1e-7)
    # one training step takes four discriminator passes through the first scale
    raw = tiny_train_config()
    cfg, generator, disc, _, disc0 = networks(raw)
    data = corpus(cfg)
    u = disc.msd.discriminators[0].convs[0].weight_u
    opt_g, opt_d = tv.make_optimizers(cfg.vocoder_train, generator, disc)
    multi = tv.make_vocoder_train_step(cfg, generator, disc, opt_g, opt_d, attr(), 1)
    calls = []
    handle = disc.msd.discriminators[0].convs[0].register_forward_pre_hook(lambda m, i: calls.append(1))
    multi(data.packed, data.starts, 3, 0)
    handle.remove()
    assert len(calls) == 4 and not torch.equal(u, disc0["msd.discriminators.0.convs.0.weight_u"])
    assert "weight_orig" in dict(disc.msd.discriminators[0].convs[0].named_parameters())
    assert "weight_g" in dict(disc.msd.discriminators[1].convs[0].named_parameters())


def _leaves(seed: int):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(5, 3, generator=g).requires_grad_(True), torch.randn(7, generator=g).requires_grad_(True)]


def _run(opt_cls, leaves, steps: int, clip=None, **kw):
    """``steps`` steps of ``opt_cls`` on a cubic loss, the gradients clipped
    to ``clip`` by ``clip_grad_norm_`` first where it is given."""
    opt = opt_cls(leaves, **kw)
    for i in range(steps):
        opt.zero_grad()
        sum(((p - 0.3 * (i + 1)) ** 3).sum() for p in leaves).backward()
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(leaves, max_norm=clip)
        opt.step()
    return [p.detach() for p in leaves]


def test_the_adamw_option_is_torchs_adamw():
    """The trainer's optimisers are ``torch.optim.AdamW`` in its multi-tensor
    form with the configuration's numbers, and step as the reference's
    single-tensor AdamW does."""
    vt = tcfg.config_from_dict(tiny_train_config()).vocoder_train
    opts = tv.make_optimizers(vt, nn.Linear(3, 5), nn.Linear(5, 2))
    for opt in opts:
        group = opt.param_groups[0]
        assert type(opt) is torch.optim.AdamW and group["foreach"] and not group["amsgrad"]
        assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
            vt.lr, tuple(vt.betas), vt.eps, vt.weight_decay)
    kw = dict(lr=2e-4, betas=(0.8, 0.99), eps=1e-8, weight_decay=0.01)
    ours = _run(torch.optim.AdamW, _leaves(1), 5, foreach=True, **kw)
    theirs = _run(ref._adamw, _leaves(1), 5, vt=dict(kw, betas=list(kw["betas"])))
    for a, b, p0 in zip(ours, theirs, _leaves(1)):
        assert rel(a - p0.detach(), b - p0.detach()) <= RTOL


def test_torchadams_default_is_still_clipped_l2_amsgrad_adam():
    kw = dict(lr=5e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4, amsgrad=True)
    ours = _run(TorchAdam, _leaves(2), 5, clip_norm=0.5, **kw)
    theirs = _run(torch.optim.Adam, _leaves(2), 5, clip=0.5, foreach=False, **kw)
    for a, b, p0 in zip(ours, theirs, _leaves(2)):
        assert rel(a - p0.detach(), b - p0.detach()) <= RTOL
    opt = TorchAdam(_leaves(3))
    opt.param_groups[0]["params"][0].grad = torch.ones(5, 3)
    opt.param_groups[0]["params"][1].grad = torch.ones(7)
    assert float(opt.step()) == pytest.approx(np.sqrt(22.0))


def test_a_decayed_lr_takes_effect_at_the_epochs_first_step():
    raw = tiny_train_config()
    outs = []
    for steps_per_epoch in (1, 1000):
        cfg, generator, disc, gen0, _ = networks(raw)
        data = corpus(cfg)
        opt_g, opt_d = tv.make_optimizers(cfg.vocoder_train, generator, disc)
        multi = tv.make_vocoder_train_step(cfg, generator, disc, opt_g, opt_d, attr(), 1, steps_per_epoch)
        multi(data.packed, data.starts, 3, 0)
        after1 = {n: p.detach().clone() for n, p in generator.named_parameters()}
        multi(data.packed, data.starts, 3, 1)
        outs.append((after1, dict(generator.named_parameters()), opt_g.param_groups[0]["lr"]))
    (a1, a2, lr_a), (b1, b2, lr_b) = outs
    vt = raw["vocoder_train"]
    assert lr_a == pytest.approx(vt["lr"] * vt["lr_decay"]) and lr_b == vt["lr"]
    assert tv.lr_at(cfg.vocoder_train, 2 * 7 + 3, 7) == pytest.approx(vt["lr"] * vt["lr_decay"] ** 2)
    name = "upsamples.0.1.weight_v"
    torch.testing.assert_close(a1[name], b1[name], rtol=0, atol=0)
    # decoupled AdamW's change is linear in the lr: step 2 moves 0.999 as far
    ratio = (a2[name].detach() - a1[name]).norm() / (b2[name].detach() - b1[name]).norm()
    assert float(ratio) == pytest.approx(vt["lr_decay"], rel=1e-4)


# the parent's generator on the CPU (sha256 of the wavs, unmasked and masked):
# training's differentiable path leaves the served wavs as they were
PARENT_WAVS = ("40f5991723e73c2dddcd2a762f97a46732afa25441e6315e694ca44ff51c3ca3",
               "b119b6e74d8affcf9acff9a059a965f3bbb1d836d13526a8d8d273c199e0c373")


def test_generate_without_a_gradient_is_unchanged_and_takes_the_fused_route():
    voc = dict(kind="hifigan", in_channels=16, channels=32, upsample_scales=(2, 3), upsample_kernel_sizes=(4, 6))
    cfg = tcfg.VocoderConfig(**voc)
    plain = {k: ([list(x) if isinstance(x, tuple) else x for x in v] if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(cfg).items()}
    gen = Generator(cfg)
    gen.load_state_dict(ref_gen.make_params(plain, 11, "cpu"), strict=True)
    gen.eval()
    mel = torch.randn(3, 17, 16, generator=torch.Generator().manual_seed(5))
    lengths = torch.tensor([17, 9, 12])
    with torch.no_grad():
        wavs = gen.generate(mel), gen.generate(mel, lengths)
        assert not gen._records_grad(mel.transpose(1, 2))
    assert tuple(hashlib.sha256(w.numpy().tobytes()).hexdigest() for w in wavs) == PARENT_WAVS
    with torch.inference_mode():
        assert not gen._records_grad(mel)
    assert gen._records_grad(mel)
    gen.requires_grad_(False)
    assert not gen._records_grad(mel) and gen._records_grad(mel.requires_grad_(True))


def test_a_trainer_checkpoint_serves_through_load_generator(tmp_path):
    raw = tiny_train_config()
    cfg = tcfg.config_from_dict(raw)
    rng = np.random.default_rng(1)
    waves = [0.2 * rng.standard_normal(n).astype(np.float32) for n in (900, 1500, 2000)]
    a = attr()
    trainer = tv.VocoderTrainer(dataclasses.replace(cfg, inner_steps=2), waves, a, seed=4, device="cpu")
    trainer.train(3)
    path = str(tmp_path / "vocoder.pkl")
    trainer.save(path)
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "steps"} and ckpt["steps"] == 3
    assert set(ckpt["model"]) == set(ckpt["optimizer"]) == {"generator", "discriminator"}
    gen = load_generator(path, cfg.vocoder, "cpu")
    params = make_params(raw, 21, "cpu")
    model = AE(cfg.model)
    model.load_state_dict(params, strict=True)
    with open(tmp_path / "attr.pkl", "wb") as f:
        pickle.dump(a, f)
    inf = Inferencer(cfg, model, str(tmp_path / "attr.pkl"), device="cpu", vocoder=gen)
    srcs = [np.random.default_rng(s).standard_normal((n, 16)).astype(np.float32) for s, n in ((1, 21), (2, 13))]
    tars = [np.random.default_rng(3).standard_normal((17, 16)).astype(np.float32)]
    wavs = inf.convert_grid(srcs, tars, trim=False)
    folded = {k: v for k, v in gen.state_dict().items()}
    hop = cfg.signal.hop_length
    for s, got in zip(srcs, wavs):
        with torch.no_grad():
            mel = Net(raw, params).inference(torch.from_numpy(s), torch.from_numpy(tars[0]))
        want = ref_gen.generate(mel, folded, raw["vocoder"]).numpy()[: hop * (len(s) - 1)]
        assert got.shape == want.shape and rel(torch.from_numpy(got), torch.from_numpy(want)) <= RTOL
    # a resumed trainer continues where the saved one stopped
    again = tv.VocoderTrainer(dataclasses.replace(cfg, inner_steps=2), waves, a, seed=4, device="cpu")
    again.load(path)
    trainer.train(2)
    again.train(2)
    for p, q in zip(trainer.generator.parameters(), again.generator.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_a_corpus_over_the_budget_raises_and_short_utterances_are_left_out():
    cfg = tcfg.config_from_dict(tiny_train_config())
    waves = [np.zeros(1000, np.float32), np.zeros(100, np.float32)]
    data = tv.WaveCorpus(waves, cfg.signal, 320, torch.device("cpu"), 10**6)
    assert data.n_utterances == 1 and data.starts.numel() == (1000 - 320) // 40 + 1
    with pytest.raises(ValueError, match="device_data_budget_bytes"):
        tv.WaveCorpus(waves, cfg.signal, 320, torch.device("cpu"), 4000)


def test_the_spans_and_counters_are_silent_without_a_profiler(monkeypatch):
    raw = tiny_train_config()
    cfg, generator, disc, _, _ = networks(raw)
    data = corpus(cfg)
    opt_g, opt_d = tv.make_optimizers(cfg.vocoder_train, generator, disc)
    multi = tv.make_vocoder_train_step(cfg, generator, disc, opt_g, opt_d, attr(), 2)
    monkeypatch.setattr(profiling, "SPAN_LOG", profiling.SpanLog(cap=1000))
    monkeypatch.setattr(profiling, "COUNTER_LOG", profiling.CounterLog(cap=1000))
    multi(data.packed, data.starts, 3, 0)
    assert profiling.SPAN_LOG.spans == [] and profiling.COUNTER_LOG.counts == []
    with profile(activities=[ProfilerActivity.CPU]):
        multi(data.packed, data.starts, 3, 2)
    names = [n for n, _, _ in profiling.SPAN_LOG.spans]
    assert names == ["vtrain.sample", "vtrain.disc", "vtrain.gen"] * 2
    spans = profiling.SPAN_LOG.spans
    assert all(spans[i][2] <= spans[i + 1][1] for i in range(len(spans) - 1))
    counts = {}
    for n, _, v in profiling.COUNTER_LOG.counts:
        counts.setdefault(n, []).append(float(v))
    vt = cfg.vocoder_train
    assert counts["vtrain.segments"] == [vt.batch_size] * 2
    t, pooled = vt.segment_samples, []
    for _ in range(vt.msd_scales):
        pooled.append(t)
        t = t // 2 + 1
    per_wav = sum(-(-vt.segment_samples // p) * p for p in vt.mpd_periods) + sum(pooled)
    assert counts["vtrain.disc_samples"] == [4 * vt.batch_size * per_wav] * 2


def test_the_vocoder_train_section_is_optional_and_round_trips():
    assert tcfg.config_from_dict({}).vocoder_train is None
    assert "vocoder_train" not in tcfg.config_to_dict(tcfg.config_from_dict({}))
    raw = tiny_train_config()
    cfg = tcfg.config_from_dict(raw)
    again = tcfg.config_from_dict(tcfg.config_to_dict(cfg))
    assert again.vocoder_train == cfg.vocoder_train
    with pytest.raises(ValueError, match="multiple of the hop"):
        tcfg.config_from_dict(dict(raw, vocoder_train=dict(raw["vocoder_train"], segment_samples=330)))


# -- the step as two CUDA graphs (``GANGraphs``) -----------------------------


class Stand:
    """Stands in for ``GANGraphs``' capture on the CPU, where there is no
    graph: records each capture and "replays" each half by running its code
    again on the captured inputs, as a real replay reruns its kernels."""

    def __init__(self, monkeypatch):
        self.captured = []
        monkeypatch.setattr(tv, "graph_eligible", lambda device: True)
        monkeypatch.setattr(tv.GANGraphs, "eligible", lambda self: True)
        monkeypatch.setattr(tv.GANGraphs, "_capture", self.capture_for(self))

    @staticmethod
    def capture_for(stand):
        def capture(graphs, packed, starts):
            stand.captured.append(packed)
            out, carry = torch.zeros(len(tv.LOSS_NAMES)), []

            def first():
                carry[:] = graphs.first(packed, starts)

            def second():
                out.copy_(graphs.second(*carry))

            graphs.graphs = (types.SimpleNamespace(replay=first), types.SimpleNamespace(replay=second))
            graphs.out = out
            return True

        return capture


def gan_run(raw, calls, graphed: bool, device: str = "cpu", data_seed: int = 4):
    """3-step calls at ``calls`` (it0s) from the reference's weights, an
    epoch of 4 steps (the lr decays inside the second call): the losses,
    both state dicts and both optimisers' state."""
    cfg = tcfg.config_from_dict(raw)
    dev = torch.device(device)
    gen0 = ref.make_gen_params(raw["vocoder"], SEED, dev)
    disc0 = ref.make_disc_params(raw["vocoder_train"], SEED + 1, dev)
    nets = train_hifigan.build(cfg, gen0, disc0, dev)
    data = corpus(cfg, seed=data_seed, device=device)
    multi = tv.make_vocoder_train_step(cfg, *nets, attr(), 3, steps_per_epoch=4)
    if not graphed:
        multi.graphs.off = True
    losses = torch.stack([multi(data.packed, data.starts, 7, it0) for it0 in calls])
    state = [nets[0].state_dict(), nets[1].state_dict()]
    state += [{f"{k}.{n}": v for k, st in o.state_dict()["state"].items() for n, v in st.items()} for o in nets[2:]]
    return losses, state, multi


def assert_same(run_a, run_b):
    torch.testing.assert_close(run_a[0], run_b[0], rtol=0, atol=0)
    for a, b in zip(run_a[1], run_b[1]):
        assert list(a) == list(b)
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_replayed_gan_steps_equal_eager_steps(monkeypatch):
    """The seeds, the lrs (decayed inside the second call) and the order of
    the two halves of a replayed step are the eager step's: the losses,
    the networks and the optimisers' state bit for bit, one capture."""
    stand = Stand(monkeypatch)
    raw = tiny_train_config()
    graphed, eager = gan_run(raw, (0, 3, 6), True), gan_run(raw, (0, 3, 6), False)
    assert len(stand.captured) == 1 and graphed[2].graphs.key is not None
    assert_same(graphed, eager)


def test_a_gan_capture_waits_for_no_hook_and_no_profiler_and_never_replays_another_corpus(monkeypatch):
    """A call with an optimiser step hook, or one that would capture under a
    profiler, runs eagerly; the next call captures; a replayed step under a
    profiler is the two halves' spans; a call on another corpus captures
    anew once, and back on the first, with the recapture spent, the
    multi-step stays eager."""
    stand = Stand(monkeypatch)
    log = profiling.SpanLog(cap=1000)
    monkeypatch.setattr(profiling, "SPAN_LOG", log)
    raw = tiny_train_config()
    cfg, generator, disc, _, _ = networks(raw)
    data, other = corpus(cfg), corpus(cfg, seed=5)
    opts = tv.make_optimizers(cfg.vocoder_train, generator, disc)
    multi = tv.make_vocoder_train_step(cfg, generator, disc, *opts, attr(), 2)
    seen = []
    handle = opts[1].register_step_post_hook(lambda *a: seen.append(1))
    multi(data.packed, data.starts, 3, 0)
    multi(data.packed, data.starts, 3, 2)
    assert len(seen) == 4 and not stand.captured
    handle.remove()
    with profile(activities=[ProfilerActivity.CPU]):
        multi(data.packed, data.starts, 3, 4)
    assert not stand.captured
    assert [n for n, _, _ in log.spans] == ["vtrain.sample", "vtrain.disc", "vtrain.gen"] * 2
    multi(data.packed, data.starts, 3, 6)
    assert len(stand.captured) == 1
    del log.spans[:]
    with profile(activities=[ProfilerActivity.CPU]):
        multi(data.packed, data.starts, 3, 8)
    assert [n for n, _, _ in log.spans] == ["vtrain.disc", "vtrain.gen"] * 2
    multi(other.packed, other.starts, 3, 10)
    multi(data.packed, data.starts, 3, 12)
    assert [p is other.packed for p in stand.captured] == [False, True] and multi.graphs.off


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_graphed_gan_steps_equal_eager_steps_on_card(precision):
    """Three calls of 3 steps replayed from the two captured graphs against
    the same calls run eagerly, at a tiny width, cuDNN deterministic: the
    losses, the networks (spectral norm's vectors included) and both
    AdamWs' state bit for bit; the optimisers are capturable, their lrs
    device tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        raw = dict(tiny_train_config(), compute_dtype=precision)
        graphed, eager = gan_run(raw, (0, 3, 6), True, "cuda"), gan_run(raw, (0, 3, 6), False, "cuda")
    finally:
        torch.backends.cudnn.deterministic = saved
    graphs = graphed[2].graphs
    assert graphs.graphs is not None and not graphs.off
    assert all(g["capturable"] and torch.is_tensor(g["lr"]) for o in graphs.opts for g in o.param_groups)
    assert bool(torch.isfinite(graphed[0]).all())
    assert_same(graphed, eager)


def test_drop_weight_history_detaches_what_the_norm_hooks_left():
    """After a step, the generator's weight-normed weights hold the step's
    graph (their parameters' gradient accumulators with it; the
    discriminators' last pass ran frozen); the capture detaches them, and
    the next forward computes them anew."""
    raw = tiny_train_config()
    cfg, generator, disc, _, _ = networks(raw)
    data = corpus(cfg)
    multi = tv.make_vocoder_train_step(cfg, generator, disc, *tv.make_optimizers(cfg.vocoder_train, generator,
                                                                                  disc), attr(), 1)
    multi(data.packed, data.starts, 3, 0)

    def held():
        return [m for root in (generator, disc) for m in root.modules()
                if torch.is_tensor(m.__dict__.get("weight")) and m.__dict__["weight"].grad_fn is not None]

    gen_modules = set(generator.modules())
    assert held() and all(m in gen_modules for m in held())
    tv.drop_weight_history((generator, disc))
    assert held() == []
    assert torch.isfinite(multi(data.packed, data.starts, 3, 1)).all()
