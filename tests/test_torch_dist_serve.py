"""Multi-process serving (``Inferencer(mesh=...)``) on 2 gloo ranks on the
CPU: a 3 x 3 mixed-length grid (9 pairs, so the pair batch is padded by one
copy of pair 0) and 3 explicit pairs, split over the ranks, against the
same calls with no mesh in one process. Mirrors the JAX package's
tests/test_distributed.py::test_convert_grid_sharded_over_mesh_matches_single
and tests/test_multihost_fast.py's serving test.

Tolerances (the JAX tests'): converted mels atol 1e-5; wavs atol 1e-2 x
their peak at 2 Griffin-Lim iterations (the vocoder amplifies last-bit
differences of the mel); every rank returns every pair, and the ranks'
results equal each other bit for bit.
"""

import pickle

import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters

from test_torch_solver import AUDIO_SIGNAL, N_MELS, one_intra_op_thread, tiny  # noqa: F401
from torch_dist_worker import RankGroup

CFG = tiny(signal=AUDIO_SIGNAL)
METHODS = ("exact", "fused", "pallas")


def request():
    rng = np.random.default_rng(11)
    mel = lambda n: rng.standard_normal((n, N_MELS)).astype(np.float32)
    srcs = [mel(n) for n in (40, 29, 33)]
    tars = [mel(n) for n in (24, 31, 20)]
    pairs = [(mel(n), mel(m)) for n, m in ((26, 18), (40, 22), (17, 30))]
    return srcs, tars, pairs


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_serve")
    with open(d / "attr.pkl", "wb") as f:
        pickle.dump({"mean": np.full(N_MELS, 0.4, np.float32),
                     "std": np.full(N_MELS, 0.2, np.float32)}, f)
    model = AE(CFG.model)
    init_parameters(model, torch.Generator().manual_seed(5))
    srcs, tars, pairs = request()
    torch.save({"cfg": CFG, "state_dict": model.state_dict(), "attr": str(d / "attr.pkl"),
                "srcs": srcs, "tars": tars, "pairs": pairs}, d / "in_serve.pt")
    group = RankGroup("serve", d)
    one = Inferencer(CFG, model, str(d / "attr.pkl"), device="cpu")
    want = {m: one.convert_grid(srcs, tars, gl_iters=2, gl_method=m, trim=False, return_mels=True)
            for m in METHODS}
    want["pairs"] = one.convert_pairs(pairs, gl_iters=2, trim=False, return_mels=True)
    return group.results(), want


@pytest.mark.parametrize("call", METHODS + ("pairs",))
def test_every_rank_returns_every_pair(served, call):
    ranks, want = served
    n = len(want[call][0])
    assert n == (3 if call == "pairs" else 9)
    for out in ranks:
        wavs, mels = out[call]
        assert len(wavs) == len(mels) == n
        for w, m, w1, m1 in zip(wavs, mels, *want[call]):
            assert w.shape == w1.shape and m.shape == m1.shape
    for a, b in zip(ranks[0][call][0] + ranks[0][call][1], ranks[1][call][0] + ranks[1][call][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("call", METHODS + ("pairs",))
def test_mesh_serving_equals_one_process(served, call):
    ranks, want = served
    wavs, mels = ranks[0][call]
    for a, b in zip(mels, want[call][1]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(wavs, want[call][0]):
        peak = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a, b, atol=1e-2 * peak)


def test_mesh_pallas_is_fused_bit_for_bit(served):
    ranks, _ = served
    for out in ranks:
        for a, b in zip(out["pallas"][0], out["fused"][0]):
            np.testing.assert_array_equal(a, b)
