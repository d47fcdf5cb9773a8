"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have, a whole run (the harness's look for a card
skipped) on the CPU at a tiny size, with the cells' own limits."""

from __future__ import annotations

import pytest
import torch

from vc_bench import run
from vc_bench.tests.faults import FAULTS
from vc_bench.tests.tiny import tiny_cell, tiny_config

CASES = [(cell, fault) for cell, driver in (("train_b128", "train_device"), ("train_sn_b128", "train_device"),
                                            ("convert_oneshot", "oneshot"), ("convert_grid4x8", "grid"))
         for fault in [None, *FAULTS[driver]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_makes_the_run_incorrect(cell, fault):
    torch.set_num_threads(2)
    c = tiny_cell(cell)
    cfg = tiny_config(sn=cell == "train_sn_b128")
    if fault is None:
        res = run.run_cell(cell, 2**31 + 99, 0.2, False, device="cpu", cell=c, cfg=cfg, log=lambda s: None)
        assert res["correct"], res["checks"]
        return
    with FAULTS[c["driver"]][fault]():
        res = run.run_cell(cell, 2**31 + 99, 0.2, False, device="cpu", cell=c, cfg=cfg, log=lambda s: None)
    assert not res["correct"], res["checks"]
