"""The port's Solver on 2 gloo ranks on the CPU, in every input mode, at the
tiny width of tests/test_torch_solver.py: the data mode each resolves to
(the JAX Solver's rule over a 2-device data axis), the ranks against each
other and against one process, the sharded corpus against the JAX
package's, the chunk copy split over the ranks, and a resume across a
restart of both processes (tests/test_multihost_fast.py's checks, which the
JAX package runs only outside Tier-1).

Tolerances:
- the ranks' metrics and parameters equal each other bit for bit (the
  losses are all-reduced, so every rank reports the same numbers);
- the ranks against one process on the global batch: the summary rows'
  loss terms and ``grad_norm`` rtol 1e-5 over 8 steps; in ``device_sharded``
  mode the one process steps on the per-shard draws concatenated in
  data-index order, with ``eps`` from the step generator at the global shape;
- ``plan_shards`` and each rank's shard arrays equal the JAX package's
  exactly (bf16 bit for bit);
- a run of 4 + 4 steps restarted in between equals the straight 8 steps
  bit for bit.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu.core.mesh import make_mesh as j_make_mesh
from adaptive_voice_conversion_tpu.data.dataset import SegmentDataset as JSegmentDataset
from adaptive_voice_conversion_tpu.data.sharded import ShardedDeviceDataset as JSharded
from adaptive_voice_conversion_tpu.data.sharded import plan_shards as j_plan_shards
from adaptive_voice_conversion_tpu_torch.data.dataset import SegmentDataset
from adaptive_voice_conversion_tpu_torch.data.device_sampler import draw_indices, gather_rows
from adaptive_voice_conversion_tpu_torch.data.sharded import plan_shards, shard_arrays, shard_seed
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.train.optim import kl_lambda, make_optimizer
from adaptive_voice_conversion_tpu_torch.train.solver import Solver, SolverArgs
from adaptive_voice_conversion_tpu_torch.train.step import make_train_step, step_seed

from test_torch_solver import one_intra_op_thread, read_log, tiny, write_split  # noqa: F401
from test_torch_solver_modes import CORPUS_F32_BYTES, jax_twin
from torch_dist_worker import RankGroup

N_STEPS = 8
KEYS = ("loss", "loss_rec", "loss_kl", "grad_norm")
BASE = dataclasses.replace(tiny(), inner_steps=4, chunk_bytes=100 * 8 * 4)
RUNS = {
    "host": dataclasses.replace(BASE, input_mode="host"),
    "device": dataclasses.replace(BASE, input_mode="device"),
    "device_sharded": dataclasses.replace(BASE, input_mode="device_sharded"),
    "chunked": dataclasses.replace(BASE, input_mode="chunked"),
    # over one rank's budget, within two ranks': the JAX rule shards it
    "auto": dataclasses.replace(BASE, device_data_budget_bytes=CORPUS_F32_BYTES - 1),
}
WANT_MODE = {"host": "host", "device": "device", "device_sharded": "device_sharded",
             "chunked": "chunked", "auto": "device_sharded"}


def solver_args(d, name, **kw):
    return dict(data_dir=str(d), train_set="train_128", train_index_file="train_samples_128.json",
                summary_steps=1, save_steps=1000, seed=0, **kw)


def summaries(d, name):
    return {r["step"]: [r[f"init/ae_train/{k}"] for k in KEYS]
            for r in read_log(d, f"log_{name}") if "init/ae_train/loss" in r}


def one_process_sharded(d, cfg):
    """The 2-rank sharded run's math in one process: each step's batch is
    the two shards' draws concatenated, then the ordinary step."""
    ds = SegmentDataset(str(d / "train_128.pkl"), str(d / "train_samples_128.json"),
                        cfg.data_loader.segment_size)
    plan = plan_shards(ds, 2)
    shards = [[torch.from_numpy(a) for a in shard_arrays(ds, plan, s, "float32")] for s in range(2)]
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, model, make_optimizer(cfg.optimizer, model.parameters()))
    b_local = cfg.data_loader.batch_size // 2
    gen = torch.Generator()
    rows = {}
    for it in range(N_STEPS):
        xs = []
        for s, (packed, starts) in enumerate(shards):
            g = torch.Generator().manual_seed(shard_seed(0, it, s))
            xs.append(gather_rows(packed, starts, draw_indices(len(starts), b_local, g), 16))
        gen.manual_seed(step_seed(0, it))
        m = step(torch.cat(xs), kl_lambda(it, cfg.loss.lambda_kl, cfg.annealing_iters), generator=gen)
        rows[it] = [float(m[k]) for k in KEYS]
    return rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups, and the one-process runs made while they train."""
    d = tmp_path_factory.mktemp("dist_solver")
    write_split(d, "train_128", 6, 0, "train_samples_128.json")
    spec = {"runs": RUNS, "args": solver_args(d, None), "n_steps": N_STEPS}
    torch.save(spec, d / "in_solver.pt")
    torch.save(spec, d / "in_resume.pt")
    group = RankGroup("solver", d)
    one = {}
    for name in ("host", "device", "chunked"):
        args = SolverArgs(**solver_args(d, name), logdir=str(d / f"log_one_{name}"),
                          store_model_path=str(d / f"one_{name}"))
        s = Solver(RUNS[name], args, device="cpu")
        m = s.train(N_STEPS, log_every_print=False)
        one[name] = {"final": m, "rows": summaries(d, f"one_{name}")}
    one["device_sharded"] = {"rows": one_process_sharded(d, RUNS["device_sharded"])}
    ranks = group.results()
    resumed = RankGroup("resume", d).results()
    return {"dir": d, "ranks": ranks, "resumed": resumed, "one": one}


@pytest.mark.parametrize("name", list(RUNS))
def test_data_mode_resolves_as_jax_over_two_devices(runs, name):
    for out in runs["ranks"]:
        assert out[name]["data_mode"] == WANT_MODE[name]
    args = SolverArgs(**solver_args(runs["dir"], name))
    twin = jax_twin(RUNS[name], args, mesh=j_make_mesh(2, devices=jax.devices()[:2]))
    assert twin.data_mode == WANT_MODE[name]


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_equal_each_other_bit_for_bit(runs, name):
    a, b = (out[name] for out in runs["ranks"])
    assert [a["metrics"][k] for k in KEYS] == [b["metrics"][k] for k in KEYS]
    for k, v in a["params"].items():
        torch.testing.assert_close(b["params"][k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("name", ["host", "device", "device_sharded", "chunked"])
def test_two_ranks_equal_one_process(runs, name):
    got = summaries(runs["dir"], name)  # rank 0's log
    want = runs["one"][name]["rows"]
    if name == "host":
        assert sorted(got) == list(range(N_STEPS))
    else:
        assert sorted(got) == [3, 7]  # one summary per call of inner_steps=4
    for step, row in got.items():
        np.testing.assert_allclose(row, want[step], rtol=1e-5, err_msg=f"step {step}")
    if "final" in runs["one"][name]:
        for k in KEYS:
            np.testing.assert_allclose(
                runs["ranks"][0][name]["metrics"][k], runs["one"][name]["final"][k], rtol=1e-5)


def test_only_rank_zero_logs_saves_and_writes_the_config(runs):
    d = runs["dir"]
    lines = [json.loads(line) for line in open(d / "log_device" / "metrics.jsonl")]
    steps = [r["step"] for r in lines if "init/ae_train/loss" in r]
    assert steps == [3, 7]  # one writer, not two
    assert (d / "device.config.yaml").exists()
    assert sorted(os.listdir(d / "device.ckpts")) == ["step_8.pt"]
    assert sorted(os.listdir(d / "resume.ckpts")) == ["step_4.pt"]


def test_chunk_copy_is_split_over_the_ranks(runs):
    for out in runs["ranks"]:
        c = out["chunked"]
        assert c["R"] == 100 and c["h2d_rows"] * 2 == c["R"]


def test_resume_across_a_restart_equals_the_straight_run(runs):
    straight = runs["ranks"][0]["device"]
    for out in runs["resumed"]:
        assert out["start"] == N_STEPS // 2 and out["data_mode"] == "device"
        assert [out["metrics"][k] for k in KEYS] == [straight["metrics"][k] for k in KEYS]
        for k, v in straight["params"].items():
            torch.testing.assert_close(out["params"][k], v, rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def datasets(runs):
    d = runs["dir"]
    paths = (str(d / "train_128.pkl"), str(d / "train_samples_128.json"), 16)
    return JSegmentDataset(*paths), SegmentDataset(*paths)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_plan_shards_equals_jax(datasets, n_shards):
    jds, ds = datasets
    want, got = j_plan_shards(jds, n_shards), plan_shards(ds, n_shards)
    assert (got.n_rows, got.n_starts, got.dropped_segments) == (
        want.n_rows, want.n_starts, want.dropped_segments)
    for a, b in zip(got.utt_rows, want.utt_rows):
        np.testing.assert_array_equal(a, b)


def test_plan_shards_refuses_an_empty_shard(datasets):
    with pytest.raises(ValueError, match="a shard would be empty"):
        plan_shards(datasets[1], 7)  # 6 utterances


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rank_shards_equal_jax(runs, datasets, dtype):
    jds, _ = datasets
    mesh2 = j_make_mesh(2, devices=jax.devices()[:2])
    ref = JSharded(jds, mesh2, dtype=dtype)
    j_packed, j_starts = np.asarray(ref.packed), np.asarray(ref.starts)
    for r, out in enumerate(runs["ranks"]):
        shard, packed, starts, dropped = out["device_sharded"]["shard"]
        assert shard == r and dropped == ref.dropped_segments
        np.testing.assert_array_equal(starts.numpy(), j_starts[r])
        if dtype == "float32":
            np.testing.assert_array_equal(packed.numpy(), j_packed[r])
        else:
            np.testing.assert_array_equal(out["shard_bf16"].numpy(), j_packed[r].view(np.int16))
