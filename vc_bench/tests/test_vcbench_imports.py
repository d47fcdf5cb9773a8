"""What a run loads, and how a run fails: nothing the benchmark runs
imports JAX or the JAX package; the reference imports nothing of the
program; a run fails without a card and without the program. Module names
are compared by their whole top-level name (the part before the first
dot), so the port, whose name begins with the JAX package's, is told apart
from it."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from vc_bench import run

ROOT = run.HERE.parent


def python(code: str, cwd: Path = ROOT, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2", **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "adaptive_voice_conversion_tpu_torch_extra", sys)
    assert "adaptive_voice_conversion_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "adaptive_voice_conversion_tpu.core", sys)
    assert "adaptive_voice_conversion_tpu" in run.forbidden_modules()


def test_a_whole_run_loads_no_jax():
    """Every driver, metric and reference module, and a tiny run of each
    kind of cell, in a fresh process: no jax, jaxlib, flax or JAX package."""
    out = python("""
        import json, sys, torch
        torch.set_num_threads(2)
        from vc_bench import run
        from vc_bench.tests.tiny import tiny_cell, tiny_config
        for cell in ("train_b128", "convert_oneshot", "convert_grid4x8"):
            res = run.run_cell(cell, 3, 0.2, cell == "convert_grid4x8", device="cpu",
                               cell=tiny_cell(cell), cfg=tiny_config(), log=lambda s: None)
            assert res["correct"], res
        for p in (run.HERE / "metrics").glob("*.py"):
            run.load_module(p)
        print(json.dumps(run.forbidden_modules()))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    out = python("""
        import json, sys
        import vc_bench.reference.model, vc_bench.reference.train
        import vc_bench.reference.featurize, vc_bench.reference.vocoder, vc_bench.reference.flops
        import vc_bench.traffic
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"adaptive_voice_conversion_tpu_torch", "adaptive_voice_conversion_tpu", "jax", "jaxlib", "flax"}


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "vc_bench.run", "--workload", "train_b128", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_run_with_only_the_benchmarks_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.HERE, tmp_path / "vc_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = python("""
        from vc_bench import run
        from vc_bench.tests.tiny import tiny_cell, tiny_config
        print(run.run_cell("train_b128", 3, 0.2, False, device="cpu", cell=tiny_cell("train_b128"),
                           cfg=tiny_config()))
    """, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "adaptive_voice_conversion_tpu_torch" in out.stderr
