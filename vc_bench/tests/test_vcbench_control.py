"""The lower-precision control, at each cell's own size on the card: put
in the program's place, it comes out not correct, on three seeds.

    python3 -m pytest -p no:cacheprovider -m cuda vc_bench/tests/test_vcbench_control.py -s

Skips without a CUDA device."""

from __future__ import annotations

import json

import pytest
import torch

from vc_bench import run

CELLS = [w["name"] for w in run.load_json(run.BENCHMARK_JSON)["workloads"]]
SEEDS = [2**31 + 301, 2**31 + 302, 2**31 + 303]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cells' own size")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell, seed):
    res = run.run_cell(cell, seed, 3.0, False, control=True, log=lambda s: None)
    print("CONTROL", cell, seed, json.dumps({k: v["value"] for k, v in res["checks"].items()}))
    assert not res["correct"], res["checks"]
