"""The port's recorded experiments against the JAX package's, on the CPU:
the concat-free and the dual conv bank, the encoders' ``bank_out``, and
the flat / bucketed optimiser
(``opt_fused``), the last also in the Solver and over a model axis.

Tolerances, each the JAX package's own test's:
- ``conv_bank_in`` against JAX ``conv_bank_in`` and against the port's
  ``conv_bank`` then ``conv1d``: rtol 1e-5, atol 1e-5
  (tests/test_ops.py:246-275, a reordered sum);
- ``dual_conv_bank`` against JAX ``dual_conv_bank``: 1e-4, the bound of
  test_torch_ops.py's bank; against two port ``conv_bank`` calls bit for
  bit (the CPU sums each output channel of the wider conv in the same
  order), as the JAX test holds its own;
- ``bank_out`` from ``dual_conv_bank`` against the encoders' own bank:
  atol 1e-6 (tests/test_ops.py:212-245);
- every ``opt_fused`` mode against JAX ``make_optimizer(fused=mode)``
  after the first and the second update: the parameters at rtol 1e-5,
  atol 1e-7 (tests/test_train.py:202-252), the update itself within one
  f32 unit of the parameter (the rounding of p + u on either side) plus
  1e-7, the stored moments bucket for bucket at rtol 1e-5, atol 1e-7
  (f32; the clip's scale differs in its last bits between the two
  formulas) or within one bf16 unit in the last place (bf16);
- a Solver resumed from a ``bucketed4`` checkpoint equals the continuous
  run bit for bit (the CPU is deterministic);
- dp1 x tp2 gloo ranks with ``bucketed4`` against one process with the
  per-leaf chain: per-step losses and ``grad_norm`` rtol 1e-5
  (test_torch_tp.py's bound for these steps), the gathered parameters
  atol 5e-6 rtol 1e-5 (its bound for gathered parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu.core import config as jcfg
from adaptive_voice_conversion_tpu.models import init_ae
from adaptive_voice_conversion_tpu.ops import conv_bank_in as j_conv_bank_in
from adaptive_voice_conversion_tpu.ops.conv import dual_conv_bank as j_dual_conv_bank
from adaptive_voice_conversion_tpu.train import make_optimizer as j_make_optimizer
from adaptive_voice_conversion_tpu.train.optim import bucketed_flatten
from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.ops import conv1d, conv_bank, conv_bank_in
from adaptive_voice_conversion_tpu_torch.ops.conv import dual_conv_bank
from adaptive_voice_conversion_tpu_torch.ops.norm import act_fn
from adaptive_voice_conversion_tpu_torch.train.optim import (
    FlatAdam,
    TorchAdam,
    bucket_plan,
    kl_lambda,
    make_optimizer,
    make_train_optimizer,
)
from adaptive_voice_conversion_tpu_torch.train.solver import Solver
from adaptive_voice_conversion_tpu_torch.train.step import make_train_step, step_seed

from test_torch_solver import data_dir, make_args, one_intra_op_thread  # noqa: F401
from test_torch_solver import tiny as solver_tiny
from test_torch_train import tiny
from torch_dist_worker import RankGroup

RELU = lambda y: jnp.maximum(y, 0)
LRELU = lambda y: jnp.where(y > 0, y, 0.01 * y)
MODES = (True, "bucketed", "bucketed2", "bucketed8")


def torch_bank(ws, bs):
    """JAX bank weights (k, C_in, C_bank) -> the port's (C_bank, C_in, k)."""
    return ([torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))) for w in ws],
            [torch.from_numpy(b) for b in bs])


def nct(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def ntc(x):
    return x.detach().numpy().transpose(0, 2, 1)


# -- the two banks -------------------------------------------------------------


@pytest.mark.parametrize("group_size", [1, 2, 3])
def test_conv_bank_in_matches_jax_and_concat_then_conv1d(group_size):
    rng = np.random.default_rng(0)
    B, T, C_IN, C_BANK, C_H = 3, 16, 24, 8, 12
    ks = [1, 2, 3, 4]
    bank_ws = [rng.standard_normal((k, C_IN, C_BANK)).astype(np.float32) for k in ks]
    bank_bs = [rng.standard_normal(C_BANK).astype(np.float32) for _ in ks]
    w_in = rng.standard_normal((1, C_BANK * len(ks) + C_IN, C_H)).astype(np.float32)
    b_in = rng.standard_normal(C_H).astype(np.float32)
    x = rng.standard_normal((B, T, C_IN)).astype(np.float32)

    want = j_conv_bank_in(jnp.asarray(x), [jnp.asarray(w) for w in bank_ws],
                          [jnp.asarray(b) for b in bank_bs], ks, RELU, jnp.asarray(w_in),
                          jnp.asarray(b_in), group_size=group_size)
    ws, bs = torch_bank(bank_ws, bank_bs)
    w_t = torch.from_numpy(np.ascontiguousarray(w_in.transpose(2, 1, 0)))
    b_t = torch.from_numpy(b_in)
    relu = act_fn("relu")
    ours = conv_bank_in(nct(x), ws, bs, ks, relu, w_t, b_t, group_size=group_size)
    concat = conv1d(conv_bank(nct(x), ws, bs, ks, relu, group_size=group_size), w_t, b_t)
    assert ours.shape == (B, C_H, T)
    np.testing.assert_allclose(ntc(ours), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), concat.numpy(), rtol=1e-5, atol=1e-5)
    # the 1x1 weight without its tap axis, and no bias
    flat = conv_bank_in(nct(x), ws, bs, ks, relu, w_t[..., 0], None, group_size=group_size)
    np.testing.assert_allclose(flat.numpy(), (ours - b_t[:, None]).numpy(), rtol=1e-5, atol=1e-5)


def test_conv_bank_in_compute_dtype_against_concat():
    """bf16 compute: the same function as the concat path, at the port's
    bf16 bound for one conv (tests/test_torch_ops.py)."""
    rng = np.random.default_rng(1)
    ks = [1, 2, 3, 4]
    ws, bs = torch_bank([rng.standard_normal((k, 16, 4)).astype(np.float32) * 0.3 for k in ks],
                        [rng.standard_normal(4).astype(np.float32) for _ in ks])
    w_in = torch.from_numpy(rng.standard_normal((8, 32, 1)).astype(np.float32) * 0.2)
    x = nct(rng.standard_normal((2, 16, 16)).astype(np.float32))
    relu = act_fn("relu")
    bf = torch.bfloat16
    ours = conv_bank_in(x, ws, bs, ks, relu, w_in, None, compute_dtype=bf)
    concat = conv1d(conv_bank(x, ws, bs, ks, relu, compute_dtype=bf), w_in, compute_dtype=bf)
    assert ours.dtype == bf
    scale = float(concat.float().abs().max())
    np.testing.assert_allclose(ours.float().numpy(), concat.float().numpy(), atol=2 ** -6 * scale)


@pytest.mark.parametrize("group_size", [1, 2, 4, 8])
def test_dual_conv_bank_matches_jax_and_two_banks(group_size):
    rng = np.random.default_rng(0)
    b, t, ci, cb = 2, 32, 8, 4
    ks = list(range(1, 9))
    x = rng.standard_normal((b, t, ci)).astype(np.float32)
    mk = lambda: ([rng.standard_normal((k, ci, cb)).astype(np.float32) * 0.2 for k in ks],
                  [rng.standard_normal((cb,)).astype(np.float32) for _ in ks])
    (ws_a, bs_a), (ws_b, bs_b) = mk(), mk()
    j = lambda l: [jnp.asarray(v) for v in l]
    want_a, want_b = j_dual_conv_bank(jnp.asarray(x), ((j(ws_a), j(bs_a)), (j(ws_b), j(bs_b))), ks,
                                      (RELU, LRELU), group_size=group_size)
    ta, tb = torch_bank(ws_a, bs_a), torch_bank(ws_b, bs_b)
    relu, lrelu = act_fn("relu"), act_fn("lrelu")
    out_a, out_b = dual_conv_bank(nct(x), (ta, tb), ks, (relu, lrelu), group_size=group_size)
    np.testing.assert_allclose(ntc(out_a), np.asarray(want_a), atol=1e-4)
    np.testing.assert_allclose(ntc(out_b), np.asarray(want_b), atol=1e-4)
    torch.testing.assert_close(out_a, conv_bank(nct(x), *ta, ks, relu, group_size=group_size),
                               rtol=0, atol=0)
    torch.testing.assert_close(out_b, conv_bank(nct(x), *tb, ks, lrelu, group_size=group_size),
                               rtol=0, atol=0)


def test_bank_out_from_dual_bank_equals_the_encoders_own_bank():
    cfg = tiny(tcfg)
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    spk, cnt = model.speaker_encoder, model.content_encoder
    assert spk.kernel_sizes == cnt.kernel_sizes
    x = nct(np.random.default_rng(2).standard_normal((4, 16, 8)).astype(np.float32))
    bank = lambda enc: ([c.weight for c in enc.conv_bank], [c.bias for c in enc.conv_bank])
    with torch.no_grad():
        out_s, out_c = dual_conv_bank(x, (bank(spk), bank(cnt)), spk.kernel_sizes, (spk.act, cnt.act))
        np.testing.assert_allclose(spk(x, bank_out=out_s).numpy(), spk(x).numpy(), atol=1e-6)
        for a, b in zip(cnt(x, bank_out=out_c), cnt(x)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        # the given bank is what the encoder uses: another one changes it
        assert not torch.equal(spk(x, bank_out=out_s * 2), spk(x))


# -- the flat and bucketed optimiser ---------------------------------------------


def jax_tree(rng):
    """tests/test_train.py:217-229's parameters and gradients."""
    params = {
        "a": {"w": rng.standard_normal((7, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)},
        "c": [rng.standard_normal((3, 3)).astype(np.float32),
              rng.standard_normal((11,)).astype(np.float32)],
    }
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(2)]
    return params, grads


def moment_buckets(state, name):
    """The stored moment ``name`` of a flat / bucketed JAX chain's state:
    one array per bucket (optax.flatten: one)."""
    v = getattr(state[2], name)
    return list(v) if isinstance(v, (list, tuple)) else [v]


def bits(x):
    return x.detach().view(torch.int16).numpy().astype(np.int32)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amsgrad", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_fused_modes_match_jax(mode, amsgrad, state_dtype):
    kw = dict(amsgrad=amsgrad)
    params, grads = jax_tree(np.random.default_rng(0))
    j_opt = j_make_optimizer(jcfg.OptimizerConfig(**kw), state_dtype=state_dtype, fused=mode)
    jp = jax.tree.map(jnp.asarray, params)
    j_state = j_opt.init(jp)
    leaves = jax.tree_util.tree_leaves(params)
    tp = [torch.nn.Parameter(torch.from_numpy(l.copy())) for l in leaves]
    opt = make_optimizer(tcfg.OptimizerConfig(**kw), tp, state_dtype=state_dtype, fused=mode)
    assert isinstance(opt, FlatAdam)
    for g in grads:
        upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        before = [p.detach().clone() for p in tp]
        for p, gl in zip(tp, jax.tree_util.tree_leaves(g)):
            p.grad = torch.from_numpy(gl.copy())
        norm = opt.step()
        want_norm = np.sqrt(sum(float((gl.astype(np.float64) ** 2).sum()) for gl in jax.tree_util.tree_leaves(g)))
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        assert want_norm > opt.defaults["clip_norm"]  # clipping is active
        for p, p0, jl, ul in zip(tp, before, jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(upd)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-7)
            ours = p.detach().double() - p0.double()
            ulp = np.spacing(np.abs(p.detach().numpy()))
            assert (np.abs(ours.numpy() - np.asarray(ul, np.float64)) <= ulp + 1e-7).all()
    names = [("mu", "exp_avg"), ("nu", "exp_avg_sq")] + ([("nu_max", "max_exp_avg_sq")] if amsgrad else [])
    for j_name, t_name in names:
        ref = moment_buckets(j_state, j_name)
        assert len(ref) == len(opt.fill)
        for k, r in enumerate(ref):
            got = opt.state[f"bucket{k}"][t_name]
            assert got.shape == (opt.fill[k],) and opt.state[f"bucket{k}"]["step"] == 2
            if state_dtype == "bfloat16":
                assert got.dtype == torch.bfloat16
                assert np.abs(bits(got) - np.asarray(r).view(np.int16).astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_buckets", [1, 2, 4, 8, 1000])
def test_bucket_plan_fills_equal_jax(n_buckets):
    """The greedy plan over the TINY model's leaves: the JAX chain's bucket
    sizes (its moment vectors) equal the port's fills."""
    params = init_ae(jax.random.PRNGKey(0), tiny(jcfg).model)
    sizes = [int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(params)]
    ours = [p.numel() for p in AE(tiny(tcfg).model).parameters()]
    assert sorted(ours) == sorted(sizes)
    inner = j_make_optimizer(jcfg.OptimizerConfig())
    state = bucketed_flatten(inner, n_buckets).init(params)
    want = [int(v.size) for v in moment_buckets(state, "mu")]
    assign, fill = bucket_plan(ours, n_buckets)
    assert fill == want
    assert len(fill) == min(n_buckets, len(ours))
    assert [sum(s for s, a in zip(ours, assign) if a == k) for k in range(len(fill))] == fill


def test_fused_modes_raise_where_jax_raises():
    params = [torch.nn.Parameter(torch.ones(3))]
    cfg = tcfg.OptimizerConfig()
    with pytest.raises(ValueError):
        j_make_optimizer(jcfg.OptimizerConfig(), fused="nope")
    with pytest.raises(ValueError, match="unknown fused mode 'nope'"):
        make_optimizer(cfg, params, fused="nope")
    with pytest.raises(ValueError):
        j_make_optimizer(jcfg.OptimizerConfig(), sn=True, fused="bucketed4")
    for mode in MODES:
        with pytest.raises(ValueError, match="sn"):
            make_optimizer(cfg, params, fused=mode, sn=True)
        with pytest.raises(ValueError, match="sn"):
            make_train_optimizer(tiny(tcfg, sn=True, opt_fused=mode), params)
    with pytest.raises(ValueError, match="opt_fused"):
        tcfg.config_from_dict({"opt_fused": "bucketed0"})
    assert tcfg.config_from_dict({"opt_fused": "bucketed"}).opt_fused == "bucketed"
    assert type(make_optimizer(cfg, params, fused=False)) is TorchAdam
    # K defaults to 4 and is capped at the number of leaves
    many = [torch.nn.Parameter(torch.ones(i + 1)) for i in range(6)]
    assert len(make_optimizer(cfg, many, fused="bucketed").fill) == 4
    assert len(make_optimizer(cfg, many, fused="bucketed8").fill) == 6
    assert len(make_optimizer(cfg, many, fused=True).fill) == 1


@pytest.mark.parametrize("input_mode", ["host", "device"])
def test_solver_resume_with_bucketed4_is_bit_exact(data_dir, input_mode):
    cfg = solver_tiny(opt_fused="bucketed4", input_mode=input_mode)
    s1 = Solver(cfg, make_args(data_dir, tag="a"), device="cpu")
    assert isinstance(s1.optimizer, FlatAdam) and len(s1.optimizer.fill) == 4
    s1.train(10, log_every_print=False)  # saves step 10 at its end
    a2 = make_args(data_dir, tag="b", load_model=True, logdir=str(data_dir / "log_b"))
    a2.load_model_path = str(data_dir / "model")
    a2.store_model_path = str(data_dir / "model_b")
    s2 = Solver(cfg, a2, device="cpu")
    assert s2.iteration == 10
    for k in range(4):
        for key, v in s1.optimizer.state[f"bucket{k}"].items():
            w = s2.optimizer.state[f"bucket{k}"][key]
            assert torch.equal(w, v) if torch.is_tensor(v) else w == v
    m_cont = s1.train(10, log_every_print=False)
    m_res = s2.train(10, log_every_print=False)
    for k in ("loss", "loss_rec", "loss_kl", "grad_norm"):
        assert m_res[k] == m_cont[k], k
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("saved,resumed,loads", [
    (False, "bucketed4", False), ("bucketed4", False, False), ("bucketed4", "bucketed8", False),
    (True, "bucketed4", False), ("bucketed", "bucketed4", True), (True, "bucketed1", True),
])
def test_loading_another_opt_fused_state(data_dir, saved, resumed, loads):
    """A state loads only into the same buckets; otherwise it raises with
    opt_fused named (the JAX package fails there on its tree's structure)."""
    s1 = Solver(solver_tiny(opt_fused=saved, input_mode="host"), make_args(data_dir), device="cpu")
    s1.train(2, log_every_print=False)
    args = make_args(data_dir, load_model=True, logdir=str(data_dir / "log_b"))
    args.load_model_path = str(data_dir / "model")
    cfg = solver_tiny(opt_fused=resumed, input_mode="host")
    if loads:
        s2 = Solver(cfg, args, device="cpu")
        assert s2.iteration == 2 and s2.optimizer.state["bucket0"]["step"] == 2
    else:
        with pytest.raises(ValueError, match="opt_fused"):
            Solver(cfg, args, device="cpu")


# -- over a model axis -------------------------------------------------------------


def per_leaf_run(v) -> dict:
    """The draws case's steps in one process with the per-leaf chain: the
    metric rows and the final parameters."""
    model = AE(v["cfg"].model)
    init_parameters(model, torch.Generator().manual_seed(v["seed"]))
    step = make_train_step(v["cfg"], model, make_optimizer(v["cfg"].optimizer, model.parameters()))
    gen = torch.Generator()
    rows = []
    for it, x in enumerate(v["batches"]):
        gen.manual_seed(step_seed(v["seed"], it))
        m = step(torch.from_numpy(x), kl_lambda(it, 1.0, 4), generator=gen)
        rows.append([float(m[k]) for k in ("loss", "loss_rec", "loss_kl", "grad_norm")])
    return {"rows": rows, "params": model.state_dict()}


@pytest.fixture(scope="module")
def tp_bucketed(tmp_path_factory):
    """Two gloo ranks (dp1 x tp2) run 3 steps of the draws case
    (tests/torch_dist_worker.py) with ``bucketed4``, while this process
    runs them with the per-leaf chain."""
    rng = np.random.default_rng(7)
    v = {"name": "bucketed4", "cfg": tiny(tcfg, opt_fused="bucketed4"), "seed": 11,
         "batches": [rng.standard_normal((8, 16, 8)).astype(np.float32) for _ in range(3)],
         "eval_batch": rng.standard_normal((8, 16, 8)).astype(np.float32)}
    work = tmp_path_factory.mktemp("tp_bucketed")
    torch.save({"variants": [v], "n_model": 2}, work / "in_bank_out.pt")
    group = RankGroup("bank_out", work, 2)
    want = per_leaf_run({**v, "cfg": tiny(tcfg)})
    return {"want": want, "outs": group.results()}


def test_tp_bucketed4_equals_one_process_per_leaf(tp_bucketed):
    want = tp_bucketed["want"]
    for out in tp_bucketed["outs"]:
        got = out["bucketed4"]
        np.testing.assert_allclose(got["rows"], want["rows"], rtol=1e-5)
        assert set(got["params"]) == set(want["params"])
        for k, t in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), t.numpy(), atol=5e-6, rtol=1e-5,
                                       err_msg=k)


def test_bank_out_under_a_model_axis_raises(tp_bucketed):
    for out in tp_bucketed["outs"]:
        assert out["bank_out_error"] is not None and "model axis" in out["bank_out_error"]
