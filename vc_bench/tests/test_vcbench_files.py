"""BENCHMARK.json and the files it names: every cell, configuration,
driver and per-layer metric is a file the harness finds by its name, and
the file keeps to the benchmark's contract."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from vc_bench import run
from vc_bench.reference import flops

BENCH = run.load_json(run.BENCHMARK_JSON)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vc_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    groups = [BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vc_bench/") and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"] if "workloads" in m else CELLS) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = run.load_json(run.HERE / "workloads" / f"{cell}.json")
    assert w["config"] == spec["config"] and w["chips"] == spec["chips"] and w["why"] == spec["why"]
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = run.load_json(run.HERE.parent / cfg_entry["file"])
    assert cfg["source"] == cfg_entry["source"] and cfg["reduced"] == cfg_entry["reduced"]
    driver = importlib.import_module(f"vc_bench.drivers.{w['driver']}")
    assert all(callable(getattr(driver, f)) for f in ("setup", "unit", "finish", "check"))
    e2e = run.cell_metrics(BENCH, cell, "end_to_end")
    per = run.cell_metrics(BENCH, cell, "per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
    for m in per:
        assert callable(run.load_module(run.metric_file(m["name"])).read)
    assert w["limits"] and all(v >= 0 for v in w["limits"].values())


def test_every_config_is_used_and_keeps_the_published_widths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = run.load_json(run.HERE.parent / c["file"])
        for enc in ("SpeakerEncoder", "ContentEncoder"):
            assert (cfg[enc]["c_in"], cfg[enc]["c_h"], cfg[enc]["c_bank"], cfg[enc]["bank_size"]) == (512, 128, 128, 8)
            assert cfg[enc]["n_conv_blocks"] == 6 and cfg[enc]["subsample"] == [1, 2, 1, 2, 1, 2]
        assert cfg["Decoder"]["upsample"] == [2, 1, 2, 1, 2, 1] and cfg["Decoder"]["c_h"] == 128
        assert (cfg["data_loader"]["batch_size"], cfg["data_loader"]["segment_size"]) == (128, 128)


def test_metric_files_all_listed():
    """Every listed metric has a reader, and every reader reads a listed metric."""
    used = {run.metric_file(m["name"]) for m in BENCH["per_layer"]}
    assert all(p.exists() for p in used)
    assert set((run.HERE / "metrics").glob("*.py")) == used


def test_the_collector_comes_back_after_the_window():
    import gc

    with run.collector_off():
        assert not gc.isenabled() and gc.get_freeze_count() > 0
    assert gc.isenabled() and gc.get_freeze_count() == 0


def test_a_metrics_own_file_comes_before_its_first_parts(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    for name in ("mfu.py", "mfu.grid.py"):
        (tmp_path / "metrics" / name).write_text("")
    monkeypatch.setattr(run, "HERE", tmp_path)
    assert run.metric_file("mfu.grid").name == "mfu.grid.py"
    assert run.metric_file("mfu.train").name == "mfu.py"
    assert run.metric_file("mfu").name == "mfu.py"


@pytest.mark.parametrize("config", ["adain_vc", "adain_vc_sn"])
def test_train_step_flops_equal_the_programs_cost_model(config):
    from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
    from adaptive_voice_conversion_tpu_torch.utils.roofline import train_step_cost

    cfg = run.load_json(run.HERE / "configs" / f"{config}.json")
    ours = flops.train_step_flops(cfg, 128, 128)
    theirs = train_step_cost(config_from_dict(cfg))["flops_total"]
    assert round(theirs / 1e9, 1) == 658.0
    assert ours - flops.sn_step_flops(cfg) == theirs
    assert (flops.sn_step_flops(cfg) > 0) == (config == "adain_vc_sn")


@pytest.mark.parametrize("frames,gflop", [(340, 3.343), (3840, 37.754)])
def test_griffin_lim_flops_per_iteration(frames, gflop):
    sig = run.load_json(run.HERE / "configs" / "adain_vc.json")["signal"]
    assert round(flops.gl_flops(sig, frames, n_iter=1) / 1e9, 3) == gflop
    least = flops.gl_least_seconds(sig, frames)
    assert least == pytest.approx(flops.gl_flops(sig, frames) / flops.PEAK_BF16)


def test_cell_metrics_selects_by_workloads_and_moves():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["y"]}],
             "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in run.cell_metrics(bench, "x", "end_to_end")] == ["a"]
    assert [m["name"] for m in run.cell_metrics(bench, "x", "per_layer")] == ["p"]
    assert [m["name"] for m in run.cell_metrics(bench, "y", "per_layer")] == ["p", "q", "r"]
