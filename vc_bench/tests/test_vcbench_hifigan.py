"""The HiFi-GAN cell on the CPU at a tiny size: a run of ``grid_neural``
comes out correct, and a run with the generator broken underneath (a
dilation of 1 in place of 3, the length masks dropped, one residual block's
output left out of the mean) or with the bfloat16 control in the program's
place comes out not correct, under the cell's own limits, whose unit is the
reference's own distance at the configuration's precision. The generator's
cost model against an independent count of the plain reference's
convolutions, and the new files against the benchmark's contract."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import adaptive_voice_conversion_tpu_torch.models.hifigan as hifigan
from vc_bench import run
from vc_bench.reference import hifigan as ref
from vc_bench.reference import hifigan_flops
from vc_bench.tests import test_vcbench_files as files
from vc_bench.tests.faults import patched
from vc_bench.tests.tiny import tiny_cell, tiny_config

CELL = "convert_grid8x16_hifigan"
SEED = 2**31 + 99


def tiny_hifigan_config() -> dict:
    """The tiny AdaIN-VC (16 mels, hop 40) and a 32-channel generator at
    scales [5, 8]: every kind of layer of the published one."""
    cfg = tiny_config()
    cfg["vocoder"] = dict(run.load_json(run.HERE / "configs" / "adain_vc_hifigan.json")["vocoder"],
                          in_channels=16, channels=32, upsample_scales=[5, 8], upsample_kernel_sizes=[10, 16])
    return cfg


def dilation_one():
    """Every dilation of 3 runs at 1 (the weights load unchanged)."""
    def make(old):
        def init(self, channels, kernel_size, dilations, slope):
            old(self, channels, kernel_size, [1 if d == 3 else d for d in dilations], slope)
        return init
    return patched(hifigan.ResidualBlock, "__init__", make)


def masks_dropped():
    """The generator runs the padded batch without its length masks."""
    return patched(hifigan.Generator, "generate", lambda old: lambda self, mel, lengths=None: old(self, mel))


def block_left_out():
    """The kernel-11 block of each stage adds nothing to the mean."""
    def make(old):
        def masked(self, x, mask):
            y = old(self, x, mask)
            return torch.zeros_like(y) if self.convs1[0][1].kernel_size[0] == 11 else y
        return masked
    return patched(hifigan.ResidualBlock, "masked", make)


FAULTS = {"dilation_one": dilation_one, "masks_dropped": masks_dropped, "block_left_out": block_left_out}


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny_run(**kw) -> dict:
    return run.run_cell(CELL, SEED, 0.2, False, device="cpu", cell=tiny_cell(CELL), cfg=tiny_hifigan_config(),
                        log=lambda s: None, **kw)


def test_a_tiny_run_is_correct():
    res = tiny_run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    # no TF32 on the CPU: the unit is UNIT_FLOOR (1e-5) of the varying part
    assert res["checks"]["wav_gap"]["value"] <= 1.0
    assert res["metrics"]["conversions_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [*FAULTS, "bf16_control"])
def test_a_fault_makes_the_run_incorrect(fault):
    if fault == "bf16_control":
        res = tiny_run(control=True)
    else:
        with FAULTS[fault]():
            res = tiny_run()
    assert not res["correct"], res["checks"]


def test_a_traced_tiny_run_reads_the_new_metrics():
    res = run.run_cell(CELL, SEED, 0.2, True, device="cpu", cell=tiny_cell(CELL), cfg=tiny_hifigan_config(),
                       log=lambda s: None)
    m = res["metrics"]
    assert res["correct"]
    assert m["generator_ms.grid_hifigan"]["value"] > 0 and m["model_ms.grid_hifigan"]["value"] > 0
    # lengths 12-40 padded to multiples of 32
    assert 0 < m["pad_share.grid_hifigan"]["value"] < 100
    # no device in a CPU run: nothing for the roofline to divide by
    assert "gen_roofline.grid_hifigan" not in m


@pytest.mark.parametrize("precision", [None, "default", "high", "highest"])
def test_the_units_precision_is_the_programs(precision):
    from adaptive_voice_conversion_tpu_torch.core.device import set_precision
    from vc_bench.drivers import grid_neural

    with grid_neural.tf32_switches(False, True):
        set_precision(precision)
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    assert flags == grid_neural.stated_switches(precision)


def test_the_unit_is_the_references_own_distance_at_the_configs_precision(monkeypatch):
    """A wav off the reference by twice what the reference's own TF32 run
    is off reads 2; with the two references one (no TF32), the floor."""
    from vc_bench.drivers import grid_neural

    rng = np.random.default_rng(3)
    ref = (0.3 + 0.01 * rng.standard_normal(4000)).astype(np.float32)
    noise = 1e-4 * rng.standard_normal(4000).astype(np.float32)
    ctx = type("Ctx", (), {"cell": {"n_src": 1, "n_tar": 1}, "cfg": {"precision": None}})
    monkeypatch.setattr(grid_neural, "_mels", lambda state, picks, lens, ns: ([None], [None]))
    monkeypatch.setattr(grid_neural.ref_feat, "trim", lambda y, top_db: (y, 0, len(y)))

    def judged(at_precision, w):
        monkeypatch.setattr(grid_neural, "reference_wav",
                            lambda ctx, net, gp, s, t, dtype=None, tf32=False: at_precision if tf32 else ref)
        return grid_neural.judge_call(ctx, None, None, None, None, None, [w])[0]

    assert judged(ref + noise, ref + 2 * noise) == pytest.approx(2.0, rel=1e-3)
    floor = grid_neural.UNIT_FLOOR * np.linalg.norm(ref - ref.mean())
    assert judged(ref, ref + noise) == pytest.approx(np.linalg.norm(noise) / floor, rel=1e-3)
    assert judged(ref, ref[:-1]) == float("inf")


@pytest.mark.parametrize("frames", [1, 7, 20])
def test_the_cost_model_counts_what_the_reference_computes(frames):
    voc = tiny_hifigan_config()["vocoder"]
    params = ref.make_params(voc, 1, "cpu")
    mel = torch.randn(frames, voc["in_channels"])
    with FlopCounterMode(display=False) as counter:
        ref.generate(mel, params, voc)
    assert counter.get_total_flops() == hifigan_flops.generator_flops(voc, frames)
    costs = hifigan_flops.layer_costs(voc, frames)
    assert [c["name"] + ".weight" for c in costs] == [n for n, _ in ref.param_shapes(voc) if n.endswith("weight")]


def test_the_published_cost():
    voc = run.load_json(run.HERE / "configs" / "adain_vc_hifigan.json")["vocoder"]
    assert hifigan_flops.weight_count(voc) == 14_528_129
    # 381.9 MFLOP a mel frame, 30.5 GFLOP a second of audio at 80 frames/s
    assert round(hifigan_flops.generator_flops(voc, 1) / 1e6, 1) == 381.9
    assert round(hifigan_flops.generator_flops(voc, 80) / 1e9, 1) == 30.5
    frames = 128 * 300
    assert hifigan_flops.gen_least_seconds(voc, frames) == pytest.approx(
        hifigan_flops.generator_flops(voc, frames) / 495e12)


def test_the_new_files_keep_the_benchmarks_contract():
    bench = run.load_json(run.BENCHMARK_JSON)
    assert {"convert_grid8x16_hifigan", "convert_oneshot_exact"} <= set(files.CELLS)
    assert "adain_vc_hifigan" in {c["name"] for c in bench["configs"]}
    files.test_top_level_keys_and_command()
    files.test_names_units_and_keys()
    files.test_every_config_is_used_and_keeps_the_published_widths()
    files.test_metric_files_all_listed()
    for cell in ("convert_grid8x16_hifigan", "convert_oneshot_exact"):
        files.test_cell_files_found_by_name(cell)
    exact = run.load_json(run.HERE / "workloads" / "convert_oneshot_exact.json")
    shot = copy.deepcopy(run.load_json(run.HERE / "workloads" / "convert_oneshot.json"))
    for key in ("why", "gl_method", "limits"):
        shot.pop(key), exact.pop(key)
    assert exact == shot


def test_the_cell_loads_no_jax_and_its_reference_nothing_of_the_program():
    from vc_bench.tests.test_vcbench_imports import python

    out = python("""
        import json, sys, torch
        torch.set_num_threads(2)
        import vc_bench.reference.hifigan, vc_bench.reference.hifigan_flops
        plain = sorted({m.split(".")[0] for m in sys.modules})
        from vc_bench import run
        from vc_bench.tests.test_vcbench_hifigan import CELL, SEED, tiny_hifigan_config
        from vc_bench.tests.tiny import tiny_cell
        res = run.run_cell(CELL, SEED, 0.2, True, device="cpu", cell=tiny_cell(CELL),
                           cfg=tiny_hifigan_config(), log=lambda s: None)
        assert res["correct"], res
        print(json.dumps([plain, run.forbidden_modules()]))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, forbidden = json.loads(out.stdout.strip().splitlines()[-1])
    assert forbidden == []
    assert not set(plain) & {"adaptive_voice_conversion_tpu_torch", "adaptive_voice_conversion_tpu", "jax"}
