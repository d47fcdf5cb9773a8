"""The port's Solver, checkpoints, training CLI and train -> serve loop, on
the CPU at the tiny width of tests/test_e2e.py.

Tolerances: resume against the continuous run rtol 1e-6 (on the CPU every
op is deterministic; the step's draws are a function of (seed, step));
``from_train_checkpoint`` against the solver's own model exact; the masked
serving path with spectral norm against one-at-a-time conversion 1e-5.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from adaptive_voice_conversion_tpu_torch.cli import train as cli_train
from adaptive_voice_conversion_tpu_torch.core.config import (
    AEConfig,
    ContentEncoderConfig,
    DataLoaderConfig,
    DecoderConfig,
    SignalConfig,
    SpeakerEncoderConfig,
    TrainConfig,
    config_to_dict,
    load_config,
)
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.train.checkpoint import CheckpointManager
from adaptive_voice_conversion_tpu_torch.train.solver import Solver, SolverArgs, step_seed
from adaptive_voice_conversion_tpu_torch.train.step import make_device_data_train_step

REPO = Path(__file__).resolve().parents[1]
N_MELS = 8


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny models train as fast on one thread, and one thread per test
    worker keeps the parallel test workers from oversubscribing the cores
    (every step here is a few hundred small kernels)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(sn=False, **top):
    return TrainConfig(
        model=AEConfig(
            speaker_encoder=SpeakerEncoderConfig(
                c_in=N_MELS, c_h=8, c_out=8, kernel_size=5, bank_size=4, bank_scale=1,
                c_bank=4, n_conv_blocks=2, n_dense_blocks=1, subsample=(1, 2),
            ),
            content_encoder=ContentEncoderConfig(
                c_in=N_MELS, c_h=8, c_out=8, kernel_size=5, bank_size=4, bank_scale=1,
                c_bank=4, n_conv_blocks=2, subsample=(1, 2),
            ),
            decoder=DecoderConfig(
                c_in=8, c_cond=8, c_h=8, c_out=N_MELS, kernel_size=5,
                n_conv_blocks=2, upsample=(2, 1), sn=sn,
            ),
        ),
        data_loader=DataLoaderConfig(segment_size=16, batch_size=8),
        **top,
    )


TINY = tiny()
AUDIO_SIGNAL = SignalConfig(
    sr=8000, n_fft=256, hop_length=64, win_length=192, n_mels=N_MELS, n_iter=2
)


def write_split(d, name, n_utts, seed, index_name, per_utt=30):
    rng = np.random.default_rng(seed)
    data, index = {}, []
    for i in range(n_utts):
        n = 40 + 10 * i
        data[f"{name}{i}"] = rng.standard_normal((n, N_MELS)).astype(np.float32)
        for _ in range(per_utt):
            index.append([f"{name}{i}", int(rng.integers(0, n - 16))])
    with open(d / f"{name}.pkl", "wb") as f:
        pickle.dump(data, f)
    with open(d / index_name, "w") as f:
        json.dump(index, f)


@pytest.fixture
def data_dir(tmp_path):
    write_split(tmp_path, "train_128", 6, 0, "train_samples_128.json")
    return tmp_path


def with_eval_split(d):
    write_split(d, "in_test", 3, 1, "in_test_samples_16.json", per_utt=14)
    attr = {"mean": np.full(N_MELS, 0.4, np.float32), "std": np.full(N_MELS, 0.2, np.float32)}
    with open(d / "attr.pkl", "wb") as f:
        pickle.dump(attr, f)


def make_args(d, **kw):
    base = dict(
        data_dir=str(d), train_set="train_128", train_index_file="train_samples_128.json",
        logdir=str(d / "log"), store_model_path=str(d / "model"),
        summary_steps=5, save_steps=1000,
    )
    base.update(kw)
    return SolverArgs(**base)


def read_log(d, sub="log"):
    return [json.loads(l) for l in open(d / sub / "metrics.jsonl")]


@pytest.mark.parametrize(
    "input_mode,data_mode,summary_steps",
    # auto: the corpus fits the default budget, so device mode (the JAX
    # Solver's rule), with one summary per call of inner_steps=10 steps
    [("auto", "device", [9, 19, 29, 39]), ("host", "host", list(range(0, 40, 5)))],
)
def test_solver_trains_and_loss_decreases(data_dir, input_mode, data_mode, summary_steps):
    cfg = dataclasses.replace(TINY, input_mode=input_mode)
    solver = Solver(cfg, make_args(data_dir), device="cpu")
    assert solver.data_mode == data_mode
    m = solver.train(40, log_every_print=False)
    assert set(m) == {"loss", "loss_rec", "loss_kl", "grad_norm", "audio_sec_per_sec"}
    assert np.isfinite(m["loss"]) and m["loss_rec"] > 0 and m["audio_sec_per_sec"] > 0
    rows = [r for r in read_log(data_dir) if "init/ae_train/loss_rec" in r]
    assert [r["step"] for r in rows] == summary_steps
    assert rows[-1]["init/ae_train/loss_rec"] < rows[0]["init/ae_train/loss_rec"]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert load_config(str(data_dir / "model.config.yaml")) == cfg
    # the final step was saved
    assert CheckpointManager(str(data_dir / "model.ckpts")).latest_step() == 40


@pytest.mark.parametrize("sn,opt_state_dtype", [(False, "float32"), (True, "bfloat16")])
def test_solver_checkpoint_resume_is_deterministic(data_dir, sn, opt_state_dtype):
    cfg = tiny(sn=sn, opt_state_dtype=opt_state_dtype, input_mode="host")
    s1 = Solver(cfg, make_args(data_dir, tag="a"), device="cpu")
    s1.train(10, log_every_print=False)  # saves step 10 at its end

    a2 = make_args(data_dir, tag="b", load_model=True, logdir=str(data_dir / "log_b"))
    a2.load_model_path = str(data_dir / "model")
    a2.store_model_path = str(data_dir / "model_b")
    s2 = Solver(cfg, a2, device="cpu")
    assert s2.iteration == 10
    if sn:
        torch.testing.assert_close(
            s2.model.decoder.in_conv_layer.weight_u,
            s1.model.decoder.in_conv_layer.weight_u, rtol=0, atol=0,
        )
    if opt_state_dtype == "bfloat16":
        assert all(st["exp_avg"].dtype == torch.bfloat16 for st in s2.optimizer.state.values())
    m_cont = s1.train(5, log_every_print=False)
    m_res = s2.train(5, log_every_print=False)
    for k in ("loss", "loss_rec", "loss_kl", "grad_norm"):
        np.testing.assert_allclose(m_res[k], m_cont[k], rtol=1e-6)
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_step_seed_is_a_function_of_seed_and_step():
    assert step_seed(0, 7) == step_seed(0, 7)
    assert len({step_seed(s, it) for s in range(3) for it in range(50)}) == 150
    assert 0 <= step_seed(5, 10**9) < 2**64


def test_in_training_eval_and_audio(data_dir):
    with_eval_split(data_dir)
    cfg = dataclasses.replace(TINY, signal=AUDIO_SIGNAL, annealing_iters=8, input_mode="host")
    args = make_args(data_dir, eval_steps=5, eval_set="in_test")
    args.eval_audio_gl_iters = 2
    solver = Solver(cfg, args, device="cpu")
    solver.train(10, log_every_print=False)

    lines = read_log(data_dir)
    eval_rows = [l for l in lines if any("ae_eval_in_test" in k for k in l)]
    assert [l["step"] for l in eval_rows] == [4, 9]
    assert all(np.isfinite(v) for l in eval_rows for k, v in l.items() if "loss" in k)

    # lambda_KL follows the current step: 5/8 at step 4, 1 at step 9
    def implied_lam(row):
        g = lambda suffix: [v for k, v in row.items() if k.endswith(suffix)][0]
        return (g("/loss") - 10.0 * g("loss_rec")) / max(g("loss_kl"), 1e-9)

    assert implied_lam(eval_rows[0]) == pytest.approx(5.0 / 8.0, rel=1e-3)
    assert implied_lam(eval_rows[1]) == pytest.approx(1.0, rel=1e-3)
    audio_rows = [l for l in lines if any("audio_n_samples" in k for k in l)]
    assert [l["step"] for l in audio_rows] == [4, 9]  # one record per eval
    n = [v for k, v in audio_rows[0].items() if "audio_n_samples" in k][0]
    assert n == 64 * (40 - 1)  # utterance in_test0: 40 frames, hop 64
    # the same weights, the same held-out losses, and training mode restored
    idx = "in_test_samples_16.json"
    assert solver.evaluate("in_test", idx, iteration=9) == solver.evaluate("in_test", idx, iteration=9)
    assert solver.model.training
    # denormalised before mel_to_mag: finite and not silent
    wav = solver._audio_convert(torch.zeros(1, 16, N_MELS), torch.zeros(1, 16, N_MELS)).numpy()
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_solver_zero_iterations(data_dir):
    solver = Solver(TINY, make_args(data_dir), device="cpu")
    m = solver.train(0, log_every_print=False)
    assert isinstance(m, dict) and solver.iteration == 0


def test_rolling_checkpoints_keep_three_and_ignore_torn_files(data_dir):
    host = dataclasses.replace(TINY, input_mode="host")
    solver = Solver(host, make_args(data_dir, save_steps=2), device="cpu")
    solver.train(9, log_every_print=False)  # saves 2, 4, 6, 8 and the end, 9
    ckpts = data_dir / "model.ckpts"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_6.pt", "step_8.pt", "step_9.pt"]
    mngr = CheckpointManager(str(ckpts))
    assert mngr.latest_step() == 9
    # what a killed writer leaves behind: a temporary name, half a file
    whole = (ckpts / "step_9.pt").read_bytes()
    (ckpts / "step_12.pt.tmp4242").write_bytes(whole[: len(whole) // 2])
    assert mngr.latest_step() == 9 and mngr.all_steps() == [6, 8, 9]
    model_state, opt_state, extra = mngr.restore()
    assert extra == {"iteration": 9, "seed": 0}
    assert set(model_state) == set(solver.model.state_dict())
    for k, v in solver.model.state_dict().items():
        torch.testing.assert_close(model_state[k], v, rtol=0, atol=0)
    assert opt_state["state"][0]["step"] == 9
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(data_dir / "empty.ckpts")).restore()
    args = make_args(data_dir, load_model=True, load_model_path=str(data_dir / "nothing"))
    with pytest.raises(FileNotFoundError):
        Solver(TINY, args, device="cpu")


def write_config(d, cfg, name="config.yaml"):
    with open(d / name, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f)
    return str(d / name)


def cli_argv(d, cfg_path, *extra):
    return [
        "-config", cfg_path, "-data_dir", str(d), "-train_set", "train_128",
        "-train_index_file", "train_samples_128.json", "-logdir", str(d / "log"),
        "-store_model_path", str(d / "model"), "-summary_steps", "1", *extra,
    ]


def test_cli_train_on_cpu(data_dir, capsys):
    with_eval_split(data_dir)
    cfg = dataclasses.replace(TINY, signal=AUDIO_SIGNAL, input_mode="host")
    cfg_path = write_config(data_dir, cfg)
    cli_train.main(cli_argv(data_dir, cfg_path, "--device", "cpu", "-iters", "3",
                            "-eval_set", "in_test", "--compute_dtype", "bfloat16"))
    out = capsys.readouterr().out
    assert "eval in_test" in out  # no cadence given: evaluated after training
    rows = [r for r in read_log(data_dir) if "init/ae_train/loss" in r]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert load_config(str(data_dir / "model.config.yaml")).compute_dtype == "bfloat16"
    assert (data_dir / "model.ckpts" / "step_3.pt").exists()
    # resume through the CLI, with a trace of the steps
    cli_train.main(cli_argv(data_dir, cfg_path, "--device", "cpu", "-iters", "2", "--load_model",
                            "--compute_dtype", "bfloat16", "--profile_dir", str(data_dir / "prof"),
                            "--debug_nans"))
    torch.autograd.set_detect_anomaly(False)
    rows = [r for r in read_log(data_dir) if "init/ae_train/loss" in r]
    assert [r["step"] for r in rows] == [0, 1, 2, 3, 4]
    assert (data_dir / "prof" / "trace.json").stat().st_size > 0
    assert (data_dir / "model.ckpts" / "step_5.pt").exists()


def test_defaults_need_a_gpu_and_unported_paths_raise(data_dir):
    cfg_path = write_config(data_dir, TINY)
    with_eval_split(data_dir)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Solver(TINY, make_args(data_dir))
        with pytest.raises(RuntimeError, match="cuda"):
            cli_train.main(cli_argv(data_dir, cfg_path, "-iters", "1"))
        with pytest.raises(RuntimeError, match="cuda"):
            Inferencer.from_train_checkpoint(TINY, str(data_dir / "model"), str(data_dir / "attr.pkl"))
    assert cli_train.build_parser().parse_args([]).device == "cuda"
    # the data modes construct; device_sharded falls back to device without
    # a data axis of 2 or more (the JAX rule), and a sharded multi-step
    # needs a mesh
    for mode, want in (("device", "device"), ("device_sharded", "device"), ("chunked", "chunked")):
        solver = Solver(dataclasses.replace(TINY, input_mode=mode), make_args(data_dir), device="cpu")
        assert solver.data_mode == want
    with pytest.raises(ValueError, match="requires a mesh"):
        make_device_data_train_step(TINY, solver.model, solver.optimizer, sharded_data=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        Solver(dataclasses.replace(TINY, opt_fused="bucketed4"), make_args(data_dir), device="cpu")
    # one process is one rank: more needs torchrun, and --multihost without
    # torchrun's environment raises before any process group starts
    with pytest.raises(ValueError, match="torchrun"):
        cli_train.main(cli_argv(data_dir, cfg_path, "--device", "cpu", "--n_data", "2"))
    with pytest.raises(RuntimeError, match="torchrun"):
        cli_train.main(cli_argv(data_dir, cfg_path, "--device", "cpu", "--multihost"))
    assert not torch.distributed.is_initialized()
    with pytest.raises(FileNotFoundError):
        Inferencer.from_train_checkpoint(
            TINY, str(data_dir / "never_trained"), str(data_dir / "attr.pkl"), device="cpu"
        )


@pytest.mark.parametrize("sn", [False, True])
def test_from_train_checkpoint_serves_the_trained_model(data_dir, sn):
    """Train, checkpoint, reload through Inferencer.from_train_checkpoint
    (and through the CLIs' -m rule): the converted mel equals the solver's
    own model's exactly; with sn the masked serving path agrees with
    one-at-a-time conversion."""
    with_eval_split(data_dir)
    cfg = dataclasses.replace(tiny(sn=sn), signal=AUDIO_SIGNAL)
    solver = Solver(cfg, make_args(data_dir), device="cpu")
    solver.train(4, log_every_print=False)
    attr = str(data_dir / "attr.pkl")
    inf = Inferencer.from_train_checkpoint(cfg, str(data_dir / "model"), attr, device="cpu")
    assert not inf.model.training
    rng = np.random.default_rng(4)
    src = rng.standard_normal((24, N_MELS)).astype(np.float32)
    tar = rng.standard_normal((19, N_MELS)).astype(np.float32)
    own = Inferencer(cfg, solver.model, attr, device="cpu")
    np.testing.assert_array_equal(inf.convert_mel(src, tar), own.convert_mel(src, tar))
    via_rule = Inferencer.from_model_path(cfg, str(data_dir / "model"), attr, device="cpu")
    np.testing.assert_array_equal(via_rule.convert_mel(src, tar), inf.convert_mel(src, tar))
    if sn:
        u = inf.model.decoder.in_conv_layer.weight_u.clone()
        src2 = rng.standard_normal((16, N_MELS)).astype(np.float32)
        _, mels = inf.convert_pairs([(src, tar), (src2, src)], gl_iters=1, trim=False, return_mels=True)
        np.testing.assert_allclose(inf.normalize(mels[0]), inf.convert_mel(src, tar), atol=1e-5)
        np.testing.assert_allclose(inf.normalize(mels[1]), inf.convert_mel(src2, src), atol=1e-5)
        torch.testing.assert_close(inf.model.decoder.in_conv_layer.weight_u, u, rtol=0, atol=0)


def test_reference_format_sn_checkpoint_loads_strictly():
    """A decoder built the reference's way (torch.nn.utils.spectral_norm on
    every layer) has the state_dict an sn=True port decoder loads with
    strict=True."""
    from torch import nn
    from torch.nn.utils import spectral_norm

    from adaptive_voice_conversion_tpu_torch.models.modules import Decoder

    cfg = tiny(sn=True).model.decoder
    ours = Decoder(cfg)

    class Ref(nn.Module):
        def __init__(self):
            super().__init__()
            c = cfg
            sn = spectral_norm
            self.in_conv_layer = sn(nn.Conv1d(c.c_in, c.c_h, 1))
            self.first_conv_layers = nn.ModuleList(
                [sn(nn.Conv1d(c.c_h, c.c_h, c.kernel_size)) for _ in range(c.n_conv_blocks)])
            self.second_conv_layers = nn.ModuleList(
                [sn(nn.Conv1d(c.c_h, c.c_h * up, c.kernel_size)) for up in c.upsample])
            self.conv_affine_layers = nn.ModuleList(
                [sn(nn.Linear(c.c_cond, c.c_h * 2)) for _ in range(2 * c.n_conv_blocks)])
            self.out_conv_layer = sn(nn.Conv1d(c.c_h, c.c_out, 1))

    ref = Ref()
    ours.load_state_dict(ref.state_dict(), strict=True)
    torch.testing.assert_close(
        ours.in_conv_layer.weight_orig, ref.in_conv_layer.weight_orig, rtol=0, atol=0
    )
    torch.testing.assert_close(ours.in_conv_layer.weight_u, ref.in_conv_layer.weight_u, rtol=0, atol=0)
    # and the normalised weight is torch's own training-mode one
    ref.train()
    ref.in_conv_layer(torch.zeros(1, cfg.c_in, 8))
    torch.testing.assert_close(ours.in_conv_layer.weight, ref.in_conv_layer.weight, rtol=1e-5, atol=1e-6)


def test_port_imports_without_jax():
    """Every module of the port imports in a process where jax, optax,
    orbax, chex and ml_dtypes cannot be imported."""
    pkg = REPO / "adaptive_voice_conversion_tpu_torch"
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )
    assert len(modules) > 40 and "adaptive_voice_conversion_tpu_torch.train.solver" in modules
    code = (
        "import importlib, sys\n"
        "blocked = ('jax', 'jaxlib', 'optax', 'orbax', 'chex', 'ml_dtypes', 'flax')\n"
        "for name in blocked:\n"
        "    sys.modules[name] = None\n"
        "for m in sys.argv[1:]:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in blocked and sys.modules[m] is not None]\n"
        "bad += [m for m in sys.modules if m.split('.')[0] == 'adaptive_voice_conversion_tpu']\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.argv) - 1)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code, *modules], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"imported {len(modules)}" in proc.stdout
