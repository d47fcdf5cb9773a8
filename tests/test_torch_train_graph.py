"""The device-mode training step as a CUDA graph (train/step.py
``StepGraph``): the device scalars it reads, when it engages, and that its
steps are the eager steps.

On the CPU there is no graph to capture. The optimiser's and the step's
tensor inputs are held bit for bit against the floats the eager path passes;
``step_scalars`` against ``kl_lambda`` and ``1 - b**t``; the CPU, a mesh and
``sharded_data`` against the multi-step's loop as it was before the graph;
and the replay path itself (the scalar table, the seeds, the step counts,
the keys, the profiler and hook rules) with the capture stood in for by a
stand-in whose "replay" runs the captured step's code again on the captured
inputs. The tests marked ``cuda`` capture and replay on the card against
eager steps (chip_smoke.py phase 13's comparison, at a narrow width) and
skip without one. The file imports nothing of JAX, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graph.py
"""

import contextlib
import dataclasses
import importlib.util
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.core.mesh import Mesh, make_mesh
from adaptive_voice_conversion_tpu_torch.data.device_sampler import sample_segments
from adaptive_voice_conversion_tpu_torch.data.sharded import sample_segments_sharded
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.train import step as step_mod
from adaptive_voice_conversion_tpu_torch.train.optim import (
    TorchAdam,
    bias_correction_operands,
    kl_lambda,
    make_optimizer,
)
from adaptive_voice_conversion_tpu_torch.train.step import (
    StepGraph,
    graph_eligible,
    make_device_data_train_step,
    make_train_step,
    step_scalars,
    step_seed,
)
from adaptive_voice_conversion_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
N_MELS, SEG, BATCH = 8, 16, 4
CPU = torch.device("cpu")


def tiny(sn=False):
    return tcfg.TrainConfig(
        model=tcfg.AEConfig(
            speaker_encoder=tcfg.SpeakerEncoderConfig(
                c_in=N_MELS, c_h=8, c_out=8, bank_size=4, c_bank=4, n_conv_blocks=2,
                n_dense_blocks=1, subsample=(1, 2),
            ),
            content_encoder=tcfg.ContentEncoderConfig(
                c_in=N_MELS, c_h=8, c_out=8, bank_size=4, c_bank=4, n_conv_blocks=2,
                subsample=(1, 2),
            ),
            decoder=tcfg.DecoderConfig(
                c_in=8, c_cond=8, c_h=8, c_out=N_MELS, n_conv_blocks=2, upsample=(2, 1), sn=sn,
            ),
        ),
        data_loader=tcfg.DataLoaderConfig(segment_size=SEG, batch_size=BATCH),
        annealing_iters=10,
    )


def model_and_opt(cfg, seed=0):
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model, make_optimizer(cfg.optimizer, model.parameters(), state_dtype=cfg.opt_state_dtype)


def corpus(seed=0, frames=300):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(frames, N_MELS, generator=g), torch.arange(0, frames - SEG, 5)


def assert_same_state(m1, o1, m2, o2):
    for a, b in zip(m1.state_dict().values(), m2.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    s1, s2 = o1.state_dict()["state"], o2.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for k in s1:
        assert s1[k]["step"] == s2[k]["step"]
        for name, v in s1[k].items():
            if torch.is_tensor(v):
                torch.testing.assert_close(v, s2[k][name], rtol=0, atol=0)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the device scalars: tensors where the eager path passes floats --------


def assert_adam_paths_equal(device, amsgrad, state_dtype, fused=False, steps=5):
    """``steps`` optimiser steps with the bias corrections given as 0-dim f32
    tensors (``bias_correction_operands``) equal as many that take them as
    floats from the step count, bit for bit: the parameters, every moment,
    the step counts and the returned norms."""
    g = torch.Generator(device=device).manual_seed(1)
    shapes = [(6, 5), (7,), (3, 2, 4)] if device.type == "cpu" else [(512, 128, 5), (128,), (64, 64)]
    base = [torch.randn(s, generator=g, device=device) for s in shapes]
    cfg = dataclasses.replace(tcfg.OptimizerConfig(), amsgrad=amsgrad, lr=1e-2)
    sides = []
    for _ in range(2):
        params = [torch.nn.Parameter(b.clone()) for b in base]
        sides.append((params, make_optimizer(cfg, params, state_dtype=state_dtype, fused=fused)))
    betas = (cfg.beta1, cfg.beta2)
    for t in range(1, steps + 1):
        scale = 8 if t == 3 else 1e-3 if t % 2 else 1  # step 3 clips
        grads = [torch.randn(s, generator=g, device=device) * scale for s in shapes]
        norms = []
        for k, (params, opt) in enumerate(sides):
            for p, gr in zip(params, grads):
                p.grad = gr.clone()
            if k == 0:
                norms.append(opt.step())
            else:
                bc = torch.tensor(bias_correction_operands(betas, t, device), dtype=torch.float32,
                                  device=device)
                norms.append(opt.step(bias_corrections=(bc[0], bc[1])))
        assert torch.equal(norms[0], norms[1])
    (p1, o1), (p2, o2) = sides
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert o1.step_count() == o2.step_count() == steps
    s1, s2 = o1.state_dict()["state"], o2.state_dict()["state"]
    for k in s1:
        for name, v in s1[k].items():
            if torch.is_tensor(v):
                assert v.dtype == getattr(torch, state_dtype)
                torch.testing.assert_close(v, s2[k][name], rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, "bucketed2"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amsgrad", [True, False])
def test_adam_with_tensor_bias_corrections_equals_the_float_path(amsgrad, state_dtype, fused):
    assert_adam_paths_equal(CPU, amsgrad, state_dtype, fused)


@pytest.mark.parametrize("sn", [False, True])
def test_train_step_with_a_tensor_lambda_kl_equals_the_float(sn):
    cfg = tiny(sn=sn)
    packed, starts = corpus()
    (m1, o1), (m2, o2) = model_and_opt(cfg), model_and_opt(cfg)
    s1, s2 = make_train_step(cfg, m1, o1), make_train_step(cfg, m2, o2)
    for it in range(3):
        lam = kl_lambda(it, 0.7, 4)
        rows = []
        for step, lam_in in ((s1, lam), (s2, torch.tensor(lam, dtype=torch.float32))):
            g = torch.Generator().manual_seed(step_seed(5, it))
            x = sample_segments(packed, starts, SEG, BATCH, g)
            m = step(x, lam_in, generator=g)
            rows.append(torch.stack([m["loss"], m["loss_rec"], m["loss_kl"], m["grad_norm"]]))
        assert torch.equal(rows[0], rows[1])
    assert_same_state(m1, o1, m2, o2)


@pytest.mark.parametrize("device", [CPU, torch.device("cuda", 0)], ids=["cpu", "cuda"])
@pytest.mark.parametrize("it0,t0", [(0, 0), (7, 7), (1000, 123)])
def test_step_scalars_are_kl_lambda_and_the_bias_corrections_in_f32(it0, t0, device):
    """Rows at, across and past ``annealing_iters`` (10): the KL weight
    grows to ``lambda_kl`` and stays; ``t`` counts from ``t0 + 1``; the bias
    corrections as the float path applies them there: divisors on the CPU,
    their reciprocals taken in double on CUDA (the table is made on the
    host either way)."""
    b1, b2 = 0.9, 0.999
    table = step_scalars(it0, t0, 10, 0.7, 10, (b1, b2), device)
    assert table.shape == (10, 3) and table.dtype == torch.float32 and table.device == CPU
    for i in range(10):
        t = t0 + 1 + i
        bc = [1.0 - b1 ** t, 1.0 - b2 ** t]
        if device.type == "cuda":
            bc = [1.0 / c for c in bc]
        want = np.array([kl_lambda(it0 + i, 0.7, 10), *bc], dtype=np.float32)
        np.testing.assert_array_equal(table[i].numpy(), want)
    if it0 >= 9:
        assert (table[:, 0] == np.float32(0.7)).all()


# -- where it engages --------------------------------------------------------


CUDA = torch.device("cuda", 0)
MESH = Mesh(2, 1, 0, 2, None, CPU)


@pytest.mark.parametrize("device,mesh,padded,want", [
    (CUDA, None, False, True),
    (CUDA, MESH, False, False),
    (CUDA, None, True, False),
    (CPU, None, False, False),
])
def test_graph_eligible_only_on_a_card_without_a_mesh_or_padded_starts(device, mesh, padded, want):
    assert graph_eligible(device, mesh, padded) is want


def old_multi_step(cfg, model, opt, inner, mesh=None, sharded=False):
    """The multi-step's loop as it was before the graph: a new generator a
    call, the KL weight as a float, the optimiser's own bias corrections."""
    step = make_train_step(cfg, model, opt, mesh)

    def run(packed, starts, seed, it0):
        gen = torch.Generator()
        out = []
        for it in range(it0, it0 + inner):
            gen.manual_seed(step_seed(seed, it))
            if sharded:
                x = sample_segments_sharded(packed, starts, SEG, BATCH, seed, it, mesh)
            else:
                x = sample_segments(packed, starts, SEG, BATCH, gen, None, mesh)
            m = step(x, kl_lambda(it, cfg.loss.lambda_kl, cfg.annealing_iters), generator=gen)
            out.append(torch.stack([m["loss"], m["loss_rec"], m["loss_kl"], m["grad_norm"]]))
        return torch.stack(out)

    return run


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo process group in this process, and its mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1, rank=0)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["cpu", "mesh", "sharded"])
def test_cpu_mesh_and_sharded_runs_stay_eager_with_todays_numbers(case, request):
    mesh = request.getfixturevalue("world_of_one") if case != "cpu" else None
    cfg = tiny(sn=True)
    packed, starts = corpus(1)
    (m1, o1), (m2, o2) = model_and_opt(cfg), model_and_opt(cfg)
    multi = make_device_data_train_step(cfg, m1, o1, inner_steps=3, sharded_data=case == "sharded",
                                        mesh=mesh)
    assert multi.step_graph is None
    old = old_multi_step(cfg, m2, o2, 3, mesh, case == "sharded")
    for it0 in (0, 3, 6):
        torch.testing.assert_close(multi(packed, starts, 11, it0), old(packed, starts, 11, it0),
                                   rtol=0, atol=0)
    assert_same_state(m1, o1, m2, o2)


# -- the replay path, its capture stood in for on the CPU -------------------


class Stand:
    """Stands in for the capture: records each "capture" and "replays" the
    captured step by running its code again on the captured inputs, with
    the optimiser's host step count and the spans left as a real replay,
    which runs no host code of the step, leaves them."""

    def __init__(self, monkeypatch):
        self.captured = []
        monkeypatch.setattr(step_mod, "graph_eligible", lambda *a: True)
        monkeypatch.setattr(StepGraph, "_capture", self.capture_for(self))

    @staticmethod
    def capture_for(stand):
        def capture(graph, packed, starts):
            stand.captured.append(packed)
            row, out = torch.zeros(3), torch.zeros(4)

            def replay():
                steps = [(st, st["step"]) for st in graph.opt.state.values()]
                span = step_mod.span
                step_mod.span = lambda name: contextlib.nullcontext()
                try:
                    out.copy_(graph.body(packed, starts, row[0], (row[1], row[2])))
                finally:
                    step_mod.span = span
                for st, n in steps:
                    st["step"] = n

            graph.graph, graph.row, graph.out = types.SimpleNamespace(replay=replay), row, out
            return True

        return capture


@pytest.mark.parametrize("sn", [False, True])
def test_replayed_steps_equal_eager_steps_and_the_step_count(sn, monkeypatch):
    stand = Stand(monkeypatch)
    cfg = tiny(sn=sn)
    packed, starts = corpus(2)
    (m1, o1), (m2, o2) = model_and_opt(cfg), model_and_opt(cfg)
    graphed = make_device_data_train_step(cfg, m1, o1, inner_steps=4)
    eager = old_multi_step(cfg, m2, o2, 4)
    assert isinstance(graphed.step_graph, StepGraph)
    for it0 in (0, 4, 8):  # the anneal ends at 10, inside the third call
        torch.testing.assert_close(graphed(packed, starts, 9, it0), eager(packed, starts, 9, it0),
                                   rtol=0, atol=0)
        assert_same_state(m1, o1, m2, o2)
    assert len(stand.captured) == 1 and graphed.step_graph.key is not None


def test_a_graph_is_never_replayed_on_another_corpus(monkeypatch):
    """The second call captures on corpus A; a call on corpus B (same shape,
    other values and address) captures anew; back on A, with the one
    recapture spent, every call runs eagerly. Each equals the eager run."""
    stand = Stand(monkeypatch)
    cfg = tiny()
    (pa, starts), (pb, _) = corpus(3), corpus(4)
    (m1, o1), (m2, o2) = model_and_opt(cfg), model_and_opt(cfg)
    graphed = make_device_data_train_step(cfg, m1, o1, inner_steps=2)
    eager = old_multi_step(cfg, m2, o2, 2)
    plan = [(pa, 0), (pa, 1), (pb, 2), (pb, 2), (pa, 2), (pb, 2)]
    for k, (packed, captures) in enumerate(plan):
        torch.testing.assert_close(graphed(packed, starts, 1, 2 * k), eager(packed, starts, 1, 2 * k),
                                   rtol=0, atol=0)
        assert len(stand.captured) == captures
    assert [p is pa for p in stand.captured] == [True, False]
    assert graphed.step_graph.off
    assert_same_state(m1, o1, m2, o2)


def test_no_capture_under_a_profiler_and_a_replay_is_one_span(monkeypatch):
    """A call that would capture while a profiler records runs eagerly (its
    spans are the eager step's); the next captures; a replayed call under
    the profiler is one ``train.replay`` span a step, which
    ``graphed_share`` reads as 100 %."""
    stand = Stand(monkeypatch)
    log = profiling.SpanLog(cap=1000)
    monkeypatch.setattr(profiling, "SPAN_LOG", log)
    cfg = tiny()
    packed, starts = corpus(5)
    model, opt = model_and_opt(cfg)
    multi = make_device_data_train_step(cfg, model, opt, inner_steps=3)
    multi(packed, starts, 0, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        multi(packed, starts, 0, 3)
    assert not stand.captured
    assert [n for n, _, _ in log.spans[:4]] == ["train.sample", "train.forward", "train.backward",
                                                 "train.update"]
    multi(packed, starts, 0, 6)
    assert len(stand.captured) == 1
    del log.spans[:]
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        multi(packed, starts, 0, 9)
        t1 = time.time_ns()
    assert [n for n, _, _ in log.spans] == ["train.replay"] * 3
    spec = importlib.util.spec_from_file_location("graphed_share", REPO / "vc_bench/metrics/graphed_share.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    record = {"units": [{"steps": 3}], "trace": types.SimpleNamespace(window_ns=(t0, t1))}
    assert reader.read(record) == 100.0
    record["units"] = [{"steps": 3}, {"steps": 3}]
    assert reader.read(record) == 50.0
    record["trace"].window_ns = (t1, t1 + 1)
    assert reader.read(record) is None


def test_an_optimiser_hook_keeps_the_call_eager(monkeypatch):
    """A step hook runs host code each step, which a replay would skip: a
    call with one registered runs eagerly, and replays resume once it is
    gone."""
    stand = Stand(monkeypatch)
    cfg = tiny()
    packed, starts = corpus(6)
    model, opt = model_and_opt(cfg)
    multi = make_device_data_train_step(cfg, model, opt, inner_steps=2)
    seen = []
    handle = opt.register_step_post_hook(lambda *a: seen.append(1))
    multi(packed, starts, 0, 0)
    multi(packed, starts, 0, 2)
    assert len(seen) == 4 and not stand.captured
    handle.remove()
    multi(packed, starts, 0, 4)
    assert len(stand.captured) == 1 and len(seen) == 4


def test_the_step_count_is_none_until_every_parameter_has_stepped():
    cfg = tiny()
    model, opt = model_and_opt(cfg)
    assert isinstance(opt, TorchAdam) and opt.step_count() is None
    packed, starts = corpus(7)
    make_device_data_train_step(cfg, model, opt, inner_steps=2)(packed, starts, 0, 0)
    assert opt.step_count() == 2
    opt.advance(3)
    assert opt.step_count() == 5
    first = next(iter(opt.state.values()))
    first["step"] += 1
    assert opt.step_count() is None


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = saved


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amsgrad", [True, False])
def test_adam_with_tensor_bias_corrections_equals_the_float_path_on_card(card, amsgrad, state_dtype):
    """As on the CPU, over 60 steps at the model's widths, where CUDA's float
    path multiplies by the reciprocal."""
    assert_adam_paths_equal(card, amsgrad, state_dtype, steps=60)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "sn", "bf16", "bucketed4"])
def test_graphed_steps_equal_eager_steps_on_card(card, variant):
    """3 calls of 10 steps replayed from one captured step against the same
    calls run eagerly, at a narrow width, cuDNN deterministic, TF32 on, for
    each configuration that shares the graphed step: the metrics,
    parameters, buffers and moments bit for bit, and a run resumed after
    the first graphed call bit for bit with the continuous one
    (chip_smoke.py phase 13's comparison)."""
    smoke = chip_smoke()
    narrow = dataclasses.replace(tiny(), data_loader=tcfg.DataLoaderConfig(segment_size=32, batch_size=16))
    cfg = smoke.graph_variants(narrow)[variant]
    r = smoke.graph_vs_eager(cfg, seed=3, n_frames=4000)
    assert r["replayed"] and r["finite"] and len(set(r["steps"])) == 1
    assert r["graph"]["exact"], r["graph"]
    assert r["resume"]["exact"], r["resume"]
