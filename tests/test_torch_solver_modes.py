"""The port's Solver in ``input_mode`` device and chunked, on the CPU at the
tiny width of tests/test_torch_solver.py, against the JAX package's Solver:
the mode ``auto`` resolves to, the cadence of summaries, saves and evals
(the JAX Solver's own loop, driven with its multi-step replaced by a stub
so that nothing is compiled), bit-exact resume, and ``chunk_repeats: auto``.

Tolerances: exact throughout (every op on the CPU is deterministic and each
step's draws are a function of (seed, step)).
"""

import dataclasses

import numpy as np
import pytest
import torch

import adaptive_voice_conversion_tpu.train.solver as jsolver
from adaptive_voice_conversion_tpu.core.config import config_from_dict as j_config_from_dict
from adaptive_voice_conversion_tpu.data.chunked import ChunkedDeviceStreamer as JChunked
from adaptive_voice_conversion_tpu_torch.core.config import config_to_dict
from adaptive_voice_conversion_tpu_torch.train.checkpoint import CheckpointManager
from adaptive_voice_conversion_tpu_torch.train.solver import Solver

from test_torch_solver import make_args, one_intra_op_thread, read_log, tiny, write_split  # noqa: F401

# write_split(6 utterances): 390 frames x 8 mels
CORPUS_F32_BYTES = 390 * 8 * 4


@pytest.fixture
def data_dir(tmp_path):
    write_split(tmp_path, "train_128", 6, 0, "train_samples_128.json")
    return tmp_path


def jax_twin(cfg, args, mesh=None):
    """A JAX Solver over the same config and arguments (and JAX mesh), set
    up only as far as its data (``_load_data``): no model is built."""
    js = jsolver.Solver.__new__(jsolver.Solver)
    js.config = j_config_from_dict(config_to_dict(cfg))
    js.args = jsolver.SolverArgs(**dataclasses.asdict(args))
    js.mesh = mesh
    js.iteration = 0
    js._load_data()
    return js


@pytest.mark.parametrize(
    "input_mode,data_dtype,compute_dtype,budget",
    [
        ("auto", "float32", "float32", 6_000_000_000),
        ("auto", "float32", "float32", CORPUS_F32_BYTES),
        ("auto", "float32", "float32", CORPUS_F32_BYTES - 1),
        ("auto", "float32", "bfloat16", CORPUS_F32_BYTES // 2),
        ("auto", "bfloat16", "bfloat16", CORPUS_F32_BYTES // 2 - 1),
        ("device_sharded", "float32", "float32", 6_000_000_000),
        ("device_sharded", "float32", "float32", 1),
        ("host", "float32", "float32", 1),
        ("chunked", "float32", "float32", 6_000_000_000),
    ],
)
def test_input_mode_resolves_as_jax(data_dir, input_mode, data_dtype, compute_dtype, budget):
    cfg = dataclasses.replace(
        tiny(), input_mode=input_mode, data_dtype=data_dtype, compute_dtype=compute_dtype,
        device_data_budget_bytes=budget, chunk_bytes=100 * 8 * 4,
    )
    args = make_args(data_dir)
    ours = Solver(cfg, args, device="cpu")
    assert ours.data_mode == jax_twin(cfg, args).data_mode
    assert (ours.device_data is not None) == (ours.data_mode == "device")
    assert (ours.chunked is not None) == (ours.data_mode == "chunked")
    if ours.device_data is not None:
        bf16 = "bfloat16" in (data_dtype, compute_dtype)
        assert ours.device_data.packed.dtype == (torch.bfloat16 if bf16 else torch.float32)
    with pytest.raises(ValueError, match="input_mode"):
        Solver(dataclasses.replace(cfg, input_mode="disk"), args, device="cpu")


@pytest.mark.parametrize("mode", ["device", "chunked"])
def test_loss_falls_over_15_steps(data_dir, mode):
    cfg = dataclasses.replace(tiny(), input_mode=mode, inner_steps=5, chunk_bytes=100 * 8 * 4)
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, lr=5e-3))
    solver = Solver(cfg, make_args(data_dir, summary_steps=1), device="cpu")
    assert solver.data_mode == mode
    m = solver.train(15, log_every_print=False)
    assert set(m) == {"loss", "loss_rec", "loss_kl", "grad_norm", "audio_sec_per_sec"}
    rows = {r["step"]: r["init/ae_train/loss_rec"] for r in read_log(data_dir) if "init/ae_train/loss_rec" in r}
    assert sorted(rows) == [4, 9, 14]  # one summary per call of 5 steps
    assert rows[14] < rows[4] and all(np.isfinite(v) for v in rows.values())
    assert solver.iteration == 15


class Recorder:
    """Stands in for the logger, save_model and the eval hook: the steps
    each is called at."""

    def __init__(self):
        self.summaries, self.saves, self.evals = [], [], []

    def scalars_summary(self, tag, m, step):
        self.summaries.append(step)

    def attach(self, solver):
        solver.logger = self
        solver.save_model = self.saves.append
        solver._eval_hook = self.evals.append


def jax_cadence(cfg, args, mode, start, n, monkeypatch):
    """The JAX Solver's _train_device / _train_chunked loop as it is, with
    a multi-step that returns zeros in place of the compiled one."""
    js = jax_twin(cfg, args)
    assert js.data_mode == mode
    fake = lambda params, opt_state, *rest: (params, opt_state, np.zeros((1, 4), np.float32))
    monkeypatch.setattr(jsolver, "make_device_data_train_step", lambda *a, **k: (None, fake))
    js.multi_step_fn, js.params, js.opt_state = fake, {}, {}
    js.iteration = start
    rec = Recorder()
    rec.attach(js)
    js.train(n, log_every_print=False)
    return rec


@pytest.mark.parametrize("mode", ["device", "chunked"])
@pytest.mark.parametrize("start,n", [(0, 17), (3, 13)])
def test_summary_save_eval_cadence_equals_jax(data_dir, mode, start, n, monkeypatch):
    """inner_steps 5 with remainders (at the run's end, and inside chunk
    visits), from step 0 and from a resumed step 3."""
    cfg = dataclasses.replace(
        tiny(), input_mode=mode, inner_steps=5, chunk_bytes=100 * 8 * 4
    )
    args = make_args(data_dir, summary_steps=3, save_steps=4, eval_steps=6, eval_set="in_test")
    want = jax_cadence(cfg, args, mode, start, n, monkeypatch)
    ours = Solver(cfg, args, device="cpu")
    ours.iteration = start
    rec = Recorder()
    rec.attach(ours)
    ours.train(n, log_every_print=False)
    assert rec.summaries == want.summaries
    assert rec.saves == want.saves
    assert rec.evals == want.evals
    assert rec.summaries[-1] == rec.saves[-1] == rec.evals[-1] == start + n - 1
    assert ours.iteration == start + n


def params_of(solver):
    return {k: v.clone() for k, v in solver.model.state_dict().items()}


@pytest.mark.parametrize(
    "mode,dtype", [("device", "float32"), ("device", "bfloat16"), ("chunked", "bfloat16")]
)
def test_resume_equals_continuous_bit_for_bit(data_dir, mode, dtype):
    """7 steps, a checkpoint, then 7 more from it equal 14 steps in one run
    (inner_steps 5, so the two runs split the steps into calls
    differently)."""
    cfg = dataclasses.replace(
        tiny(), input_mode=mode, inner_steps=5, chunk_bytes=100 * 8 * 4,
        data_dtype=dtype, compute_dtype=dtype,
    )
    cont = Solver(cfg, make_args(data_dir, store_model_path=str(data_dir / "cont")), device="cpu")
    m_cont = cont.train(14, log_every_print=False)
    first = Solver(cfg, make_args(data_dir, store_model_path=str(data_dir / "half")), device="cpu")
    first.train(7, log_every_print=False)
    resumed = Solver(
        cfg,
        make_args(data_dir, store_model_path=str(data_dir / "rest"),
                  load_model=True, load_model_path=str(data_dir / "half")),
        device="cpu",
    )
    assert resumed.iteration == 7
    m_res = resumed.train(7, log_every_print=False)
    for k in ("loss", "loss_rec", "loss_kl", "grad_norm"):
        assert m_res[k] == m_cont[k], k
    for (name, a), b in zip(params_of(cont).items(), params_of(resumed).values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)


def test_chunk_repeats_auto_is_persisted_and_replayed(data_dir, monkeypatch):
    """The measured value is kept in the checkpoints and a resumed run
    replays it without measuring; the probe leaves the training state
    untouched."""
    cfg = dataclasses.replace(
        tiny(), input_mode="chunked", chunk_bytes=100 * 8 * 4, chunk_repeats="auto", inner_steps=4
    )
    s = Solver(cfg, make_args(data_dir, save_steps=8), device="cpu")
    before = params_of(s)
    s._resolve_chunk_repeats()
    r = s._chunk_repeats_resolved
    assert isinstance(r, int) and r >= 1 and s.chunked.repeats == r
    assert not s.optimizer.state
    for k, v in params_of(s).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    s.train(8, log_every_print=False)
    assert s._chunk_repeats_resolved == r
    _, _, extra = CheckpointManager(str(data_dir / "model.ckpts")).restore(8)
    assert extra == {"iteration": 8, "seed": 0, "chunk_repeats": r}

    args2 = make_args(data_dir, load_model=True, store_model_path=str(data_dir / "model2"),
                      load_model_path=str(data_dir / "model"), logdir=str(data_dir / "log2"))
    s2 = Solver(cfg, args2, device="cpu")
    assert s2._chunk_repeats_resolved == r
    monkeypatch.setattr(s2.chunked, "choose_repeats", lambda *a, **k: pytest.fail("measured again"))
    s2.train(4, log_every_print=False)
    assert s2.chunked.repeats == r
    _, _, extra = CheckpointManager(str(data_dir / "model2.ckpts")).restore()
    assert extra["chunk_repeats"] == r and extra["iteration"] == 12


def test_jax_twin_streamer_is_the_jax_one(data_dir):
    """The chunked twin the cadence test drives is the JAX package's own
    streamer, planned like ours."""
    cfg = dataclasses.replace(tiny(), input_mode="chunked", inner_steps=5, chunk_bytes=100 * 8 * 4)
    js = jax_twin(cfg, make_args(data_dir))
    ours = Solver(cfg, make_args(data_dir), device="cpu")
    assert isinstance(js.chunked, JChunked)
    assert (js.chunked.R, js.chunked.n_chunks, js.chunked.epoch_steps) == (
        ours.chunked.R, ours.chunked.n_chunks, ours.chunked.epoch_steps)
    assert ours.chunked.device == torch.device("cpu")


@pytest.mark.parametrize("mode", ["device", "chunked"])
def test_cli_train_in_each_data_mode(data_dir, mode):
    """The training CLI takes the mode from the config (no flag of its
    own); ``--compute_dtype bfloat16`` puts a bf16 corpus on the device."""
    from adaptive_voice_conversion_tpu_torch.cli import train as cli_train

    from test_torch_solver import cli_argv, write_config

    cfg = dataclasses.replace(tiny(), input_mode=mode, inner_steps=2, chunk_bytes=100 * 8 * 4)
    argv = cli_argv(data_dir, write_config(data_dir, cfg), "--device", "cpu", "-iters", "5",
                    "--compute_dtype", "bfloat16")
    cli_train.main(argv)
    rows = [r["step"] for r in read_log(data_dir) if "init/ae_train/loss" in r]
    assert rows == [1, 3, 4]  # -summary_steps 1: one summary per call of 2, 2, 1 steps
    _, _, extra = CheckpointManager(str(data_dir / "model.ckpts")).restore(5)
    assert extra["iteration"] == 5
    solver = Solver(dataclasses.replace(cfg, compute_dtype="bfloat16"), make_args(data_dir), device="cpu")
    if mode == "device":
        assert solver.device_data.packed.dtype == torch.bfloat16
    else:
        assert solver.chunked.packed.dtype == np.float32  # streamed as stored, cast by the model
