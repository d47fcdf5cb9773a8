"""The HiFi-GAN training cell on the CPU at a tiny size: a run of
``train_hifigan`` comes out correct, and a run with the program broken
underneath, or with the bfloat16 control in its place, does not, under the
cell's own limits:

- feature matching weighted 1 in place of 2;
- the largest period's sub-discriminator left out (period 11 in the
  published configuration, 3 in the tiny one);
- the first scale discriminator's spectral norm dropped, its weight taken
  as it is stored, as weight norm takes it at initialisation;
- y_hat not detached in the discriminators' update: their backward then
  frees the generator's graph and the run fails at the generator's update.

The training step's cost model against a count of the plain reference's
convolutions by ``FlopCounterMode``, and the new files against the
benchmark's contract."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import adaptive_voice_conversion_tpu_torch.data.chunked as chunked
import adaptive_voice_conversion_tpu_torch.models.hifigan_disc as hd
import vc_bench.drivers.train_hifigan as cell_code
from vc_bench import run
from vc_bench.reference import hifigan_flops
from vc_bench.reference import hifigan_train as ref
from vc_bench.reference import hifigan_train_flops as cost
from vc_bench.tests import test_vcbench_files as files
from vc_bench.tests.faults import patched
from vc_bench.tests.tiny_vocoder import CELL, tiny_train_config, tiny_train_run

SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def fm_weight_one():
    """The program's configuration weighs feature matching 1, not 2."""
    def make(old):
        def parse(raw):
            cfg = old(raw)
            return dataclasses.replace(cfg, vocoder_train=dataclasses.replace(cfg.vocoder_train, lambda_fm=1.0))
        return parse
    return patched(cell_code, "config_from_dict", make)


def last_period_left_out():
    """The multi-period discriminator skips its last sub-discriminator."""
    return patched(hd.MultiPeriodDiscriminator, "inputs", lambda old: lambda self, y: old(self, y)[:-1])


def spectral_norm_dropped():
    """The spectral-norm layers use their stored weight as it is (through
    a differentiable copy: the parameter itself would register as a second
    one)."""
    def make(old):
        def call(self, module, inputs):
            module.weight = module.weight_orig.clone()
        return call
    return patched(hd._SpectralNorm, "__call__", make)


FAULTS = {"fm_weight_one": fm_weight_one, "last_period_left_out": last_period_left_out,
          "spectral_norm_dropped": spectral_norm_dropped}


def test_a_tiny_run_is_correct():
    res = tiny_train_run(SEED)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"loss1_gap", "loss_gap", "grad_gap", "grad_dist", "change_gap"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    with FAULTS[fault]():
        res = tiny_train_run(SEED)
    assert not res["correct"], res["checks"]


def test_the_control_is_not_correct():
    res = tiny_train_run(SEED, control=True)
    assert not res["correct"], res["checks"]


def test_y_hat_not_detached_fails_the_run():
    """Every ``detach`` a no-op: the discriminators' backward frees the
    generator's graph, and the generator's update cannot run."""
    with patched(torch.Tensor, "detach", lambda old: lambda self: self):
        with pytest.raises(RuntimeError, match="backward through the graph a second time"):
            tiny_train_run(SEED)


def test_a_traced_tiny_run_reads_every_per_layer_metric():
    res = tiny_train_run(SEED, trace=True)
    bench = run.load_json(run.BENCHMARK_JSON)
    wanted = {m["name"] for m in run.cell_metrics(bench, CELL, "per_layer")}
    assert wanted == {"mfu.train_hifigan", "disc_ms.train_hifigan", "gen_ms.train_hifigan",
                      "launches.train_hifigan", "idle_share.train_hifigan"}
    assert set(res["metrics"]) == wanted


def _conv_flops(fn) -> int:
    """Operations of the convolutions ``fn`` runs forward."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(sum(v for k, v in counter.get_flop_counts()["Global"].items() if "convolution" in str(k)))


def test_the_cost_model_counts_what_the_reference_runs():
    """Every forward is counted by ``FlopCounterMode`` on the reference, sub-
    discriminator by sub-discriminator; the backward parts are the forward's
    once for the weights and once for the inputs that need a gradient
    (``FlopCounterMode`` counts a strided convolution's weight gradient at
    the input's length, so it is not asked)."""
    raw = tiny_train_config()
    vt, voc, sig = raw["vocoder_train"], raw["vocoder"], raw["signal"]
    t, b = vt["segment_samples"], 3
    frames = t // sig["hop_length"]
    parts = cost.segment_flops(voc, vt, sig["hop_length"])
    gen = ref.make_gen_params(voc, 1, "cpu")
    disc = ref.make_disc_params(vt, 2, "cpu")
    mel = torch.randn(b, voc["in_channels"], frames)
    y = torch.randn(b, 1, t)
    assert _conv_flops(lambda: ref.generate(mel, gen, voc)) == b * parts["gen_forward"]
    assert parts["gen_forward"] == hifigan_flops.generator_flops(voc, frames)
    lays = ref.disc_layers(vt)
    n_p, n_s = len(vt["mpd_channels"]) + 1, len(vt["msd_channels"]) + 1
    subs = [(lays[i * n_p:(i + 1) * n_p], p, y) for i, p in enumerate(vt["mpd_periods"])]
    base, x = len(vt["mpd_periods"]) * n_p, y
    for i in range(vt["msd_scales"]):
        x = x if i == 0 else torch.nn.functional.avg_pool1d(x, 4, 2, padding=2)
        subs.append((lays[base + i * n_s: base + (i + 1) * n_s], 0, x))
    model = cost.disc_layer_flops(vt, t)
    for (sub, period, wav), layer_flops in zip(subs, model, strict=True):
        assert _conv_flops(lambda: ref.sub_discriminator(wav, dict(disc), sub, period)) == b * sum(layer_flops)
        assert _conv_flops(lambda: ref.sub_discriminator(wav, dict(disc), sub[:1], period)) == b * layer_flops[0]
    assert _conv_flops(lambda: ref.discriminators(y, y.clone(), dict(disc), vt)) == \
        2 * b * cost.disc_pass_flops(vt, t)
    first_gen = _conv_flops(lambda: torch.nn.functional.conv1d(
        mel, ref._wn(gen, "input_conv"), gen["input_conv.bias"], padding=(voc["kernel_size"] - 1) // 2))
    pass_ = cost.disc_pass_flops(vt, t)
    assert parts["gen_backward"] * b == 2 * b * parts["gen_forward"] - first_gen
    assert parts["disc_backward"] == 2 * (2 * pass_ - sum(f[0] for f in model))
    assert parts["disc_passes"] == 4 * pass_ and parts["disc_to_y_hat"] == pass_
    assert cost.step_flops(raw) == vt["batch_size"] * sum(parts.values())


def test_the_published_step_counts_three_tflop():
    cfg = run.load_json(run.HERE / "configs" / "adain_vc_hifigan_train.json")
    assert round(cost.step_flops(cfg) / 1e12, 3) == 3.044
    assert round(cost.disc_pass_flops(cfg["vocoder_train"], 8400) / 1e9, 2) == 17.6


def test_the_new_files_keep_the_contract():
    files.test_names_units_and_keys()
    files.test_cell_files_found_by_name(CELL)
    files.test_cell_files_found_by_name("train_chunked")
    files.test_every_config_is_used_and_keeps_the_published_widths()
    files.test_metric_files_all_listed()
    cfg = run.load_json(run.HERE / "configs" / "adain_vc_hifigan_train.json")
    base = run.load_json(run.HERE / "configs" / "adain_vc_hifigan.json")
    assert {k: v for k, v in cfg.items() if k not in ("source", "assumed", "vocoder_train")} == \
        {k: v for k, v in base.items() if k not in ("source", "assumed")}
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200


def test_the_new_cells_load_no_jax():
    """Tiny runs of both new cells in a fresh process: no jax, jaxlib, flax
    or JAX package; the reference imports nothing of the program."""
    from vc_bench.tests.test_vcbench_imports import python

    out = python("""
        import json, sys, torch
        torch.set_num_threads(2)
        import vc_bench.reference.hifigan_train, vc_bench.reference.hifigan_train_flops
        assert not [m for m in sys.modules if m.startswith("adaptive_voice_conversion_tpu")]
        from vc_bench import run
        from vc_bench.tests.tiny import load, tiny_config
        from vc_bench.tests.tiny_vocoder import tiny_train_run
        assert tiny_train_run(5)["correct"]
        cell = dict(load("workloads", "train_chunked"), corpus_frames=4000, utt_frames=[20, 80], inner_steps=4,
                    warmup_calls=1, trace_units=1, chunk_bytes=64000)
        res = run.run_cell("train_chunked", 5, 0.2, True, device="cpu", cell=cell, cfg=tiny_config(),
                           log=lambda s: None)
        assert res["correct"] and "chunk_wait_ms.train_chunked" in res["metrics"], res
        print(json.dumps(run.forbidden_modules()))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("program_stream", [True, False])
def test_train_chunked_times_the_programs_stream(monkeypatch, program_stream):
    """The chunked cell draws its visits and chunks from the program's
    ``stream_visits`` (the Solver's), and runs correct on a program without
    it (its own copy of the loop, no chunk-wait span there)."""
    from vc_bench.tests.tiny import load, tiny_config

    seen = []
    if program_stream:
        real = chunked.stream_visits
        monkeypatch.setattr(chunked, "stream_visits", lambda *a: seen.append(1) or real(*a))
    else:
        monkeypatch.delattr(chunked, "stream_visits")
    cell = dict(load("workloads", "train_chunked"), corpus_frames=4000, utt_frames=[20, 80], inner_steps=4,
                warmup_calls=1, trace_units=1, chunk_bytes=64000)
    res = run.run_cell("train_chunked", 5, 0.2, True, device="cpu", cell=cell, cfg=tiny_config(),
                       log=lambda s: None)
    assert res["correct"], res["checks"]
    assert seen == ([1] if program_stream else [])
    wait = res["metrics"].get("chunk_wait_ms.train_chunked", {}).get("value")
    assert (wait is not None) == program_stream, res["metrics"]
    listed = {m["name"] for m in run.load_json(run.BENCHMARK_JSON)["per_layer"]
              if "train_chunked" in m.get("workloads", [])}
    read = {k for k, v in res["metrics"].items() if v["value"] is not None}
    assert read == listed - ({"chunk_wait_ms.train_chunked"} if not program_stream else set()), read ^ listed
