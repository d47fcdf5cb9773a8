"""The training CLI under torchrun: two gloo ranks on the CPU, started as a
user starts a data-parallel run,

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m adaptive_voice_conversion_tpu_torch.cli.train ... --device cpu --multihost

train at the tiny width of tests/test_torch_solver.py, rank 0 alone logs,
saves the config and writes the checkpoint, and a second such run resumes
from it. The data-parallel math is held in tests/test_torch_dist_solver.py;
this file holds the entry point.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from test_torch_solver import REPO, cli_argv, read_log, tiny, with_eval_split, write_config, write_split

CFG = dataclasses.replace(tiny(), input_mode="device", inner_steps=2)


def torchrun(d, *argv):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "adaptive_voice_conversion_tpu_torch.cli.train",
         *cli_argv(d, str(d / "config.yaml"), "--device", "cpu", "--multihost", *argv)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_cli")
    write_split(d, "train_128", 6, 0, "train_samples_128.json")
    with_eval_split(d)
    write_config(d, CFG)
    first = torchrun(d, "--n_data", "2", "-iters", "4", "-save_steps", "4", "-eval_set", "in_test")
    steps_first = [r["step"] for r in read_log(d) if "init/ae_train/loss" in r]
    ckpts_first = sorted(os.listdir(d / "model.ckpts"))
    resumed = torchrun(d, "-iters", "2", "--load_model")
    return d, first, steps_first, ckpts_first, resumed


def test_torchrun_trains_and_rank_zero_writes(trained):
    d, first, steps, ckpts, _ = trained
    assert steps == [1, 3]  # -summary_steps 1, two calls of inner_steps=2, one writer
    assert ckpts == ["step_4.pt"]
    assert (d / "model.config.yaml").exists()
    # the post-training eval runs on every rank and is printed by rank 0 alone
    evals = [line for line in first.splitlines() if line.startswith("eval in_test")]
    assert len(evals) == 1
    assert set(json.loads(evals[0].split(" ", 2)[2])) == {"loss", "loss_rec", "loss_kl"}


def test_torchrun_resumes_from_the_checkpoint(trained):
    d, *_ = trained
    steps = [r["step"] for r in read_log(d) if "init/ae_train/loss" in r]
    assert steps == [1, 3, 5]  # the resumed run's call of 2 steps logs once more
    assert sorted(os.listdir(d / "model.ckpts")) == ["step_4.pt", "step_6.pt"]
