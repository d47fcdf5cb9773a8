"""The port's tensor parallelism (parallel/tp.py) on gloo ranks on the CPU,
against the JAX package's split table and step, and against one process of
the port.

Ranks run in their own processes (tests/torch_dist_worker.py); a
module-scoped fixture starts every group of ranks once and the tests below
assert on what they wrote.

Tolerances:
- the split table: equal, layer by layer, to the JAX ``tp_param_specs``
  (weights and biases; ``u`` of the column-parallel layers). The JAX rule
  also shards the 1-D ``u`` of a row-parallel layer (``_leaf_spec`` takes
  the last axis of a 1-D leaf for its input axis); the port keeps that
  ``u`` whole, as the power iteration on a row split needs it;
- Megatron's four operators on 2 ranks against autograd on one process:
  rtol 1e-6 (a sum of two f32 values in either order);
- split then gathered, the state_dict bit for bit;
- dp2 x tp2 on 4 ranks against the JAX step on the global batch of 8 rows,
  each rank fed its rows of the JAX ``eps``: the JAX package's own bounds
  for its tensor-parallel step (tests/test_distributed.py:146-153): loss
  rtol 1e-5, ``grad_norm`` rtol 1e-4, every gathered parameter atol 5e-6
  rtol 1e-5; with and without spectral norm (seed 3, for the reason
  tests/test_torch_dist_step.py gives); the gathered gradient against one
  process's gradient of the global batch, relative Frobenius 1e-5 over all
  tensors, the data axis's bound;
- dp1 x tp2 and dp1 x tp4 with every draw from the step's generator, at
  dropout 0 and 0.1, against one process: per-step loss terms and
  ``grad_norm`` rtol 1e-5 over 3 steps, the eval step rtol 1e-5;
- one bf16 case (compute_dtype bfloat16, dp1 x tp2) against one process:
  losses rtol 3e-2, the port's bf16 step bound (tests/test_torch_train.py);
- replicated parameters and their gradients equal bit for bit on every
  rank of a model group (nothing averages them).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu.core import config as jcfg
from adaptive_voice_conversion_tpu.models import init_ae
from adaptive_voice_conversion_tpu.parallel.tp import tp_param_specs as j_tp_param_specs
from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.models.weights import (
    _layer_names,
    jax_params_from_state_dict,
)
from adaptive_voice_conversion_tpu_torch.parallel import tp_param_specs
from adaptive_voice_conversion_tpu_torch.parallel.tp import split_part, unsplit

from test_torch_dist_step import (
    jax_reference,
    one_process_draws,
    one_process_grads,
    step_variant,
    with_dropout,
)
from test_torch_solver import one_intra_op_thread  # noqa: F401
from test_torch_train import tiny
from torch_dist_worker import RankGroup

DRAW_STEPS = 3


def full(mod, sn=False):
    """The full-width default config in either package."""
    cfg = mod.TrainConfig()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, decoder=dataclasses.replace(cfg.model.decoder, sn=sn)))


def jax_dim(spec, is_conv: bool):
    """A JAX PartitionSpec of a weight -> the torch dim it splits (conv
    (k, in, out) and dense (in, out): the last axis is torch dim 0, the one
    before it dim 1), or None."""
    axes = [i for i, a in enumerate(spec) if a == "model"]
    if not axes:
        return None
    (axis,) = axes
    return {len(spec) - 1: 0, len(spec) - 2: 1}[axis]


def split_tables(make, sn, n_model):
    """(port spec, JAX spec) of every layer's w, b (and a column layer's u),
    under the port's state_dict keys."""
    j, t = make(jcfg, sn), make(tcfg, sn)
    params = init_ae(jax.random.PRNGKey(0), j.model)
    j_specs = j_tp_param_specs(params, n_model)
    ours = tp_param_specs(AE(t.model), n_model)
    rows = []
    for name, path, is_conv in _layer_names(t.model):
        node = j_specs
        for key in path:
            node = node[key]
        w_key = f"{name}.weight_orig" if f"{name}.weight_orig" in ours else f"{name}.weight"
        rows.append((w_key, ours[w_key], jax_dim(node["w"], is_conv)))
        rows.append((f"{name}.bias", ours[f"{name}.bias"], jax_dim(node["b"], False)))
        if "u" in node and ours[w_key] != 1:  # the u of a column layer
            rows.append((f"{name}.weight_u", ours[f"{name}.weight_u"], jax_dim(node["u"], False)))
    return rows, ours


@pytest.mark.parametrize("sn", [False, True])
@pytest.mark.parametrize("make", [tiny, full], ids=["tiny", "full"])
def test_split_table_matches_jax(make, sn):
    rows, ours = split_tables(make, sn, 2)
    assert len(rows) >= 2 * len(_layer_names(make(tcfg, sn).model))
    for key, got, want in rows:
        assert got == want, (key, got, want)
    assert any(d is not None for d in ours.values())
    if sn:  # the spectral-norm vectors follow their weight
        assert ours["decoder.first_conv_layers.0.weight_u"] == 0
        assert ours["decoder.first_conv_layers.0.weight_v"] is None
        assert ours["decoder.second_conv_layers.0.weight_u"] is None
        assert ours["decoder.second_conv_layers.0.weight_v"] == 0


def test_split_table_megatron_pairing():
    """tests/test_distributed.py:155-163 under the port's names."""
    specs = tp_param_specs(AE(tiny(tcfg).model), 2)
    assert specs["content_encoder.first_conv_layers.0.weight"] == 0
    assert specs["content_encoder.second_conv_layers.0.weight"] == 1
    assert specs["content_encoder.second_conv_layers.0.bias"] is None
    assert specs["speaker_encoder.second_dense_layers.0.weight"] == 1
    assert specs["decoder.conv_affine_layers.0.weight"] == 0


def test_split_table_indivisible_stays_replicated():
    """3 ranks at c_h 8: no axis of TINY divides, in either package."""
    rows, ours = split_tables(tiny, False, 3)
    assert all(d is None for d in ours.values())
    assert all(want is None for _, _, want in rows)


def test_split_part_and_unsplit_are_inverse():
    t = torch.arange(2 * 12 * 3).reshape(2, 12, 3)
    for groups in (1, 2, 3):
        parts = [split_part(t, 1, 2, r, groups) for r in range(2)]
        assert torch.equal(unsplit(torch.cat(parts, 1), 1, 2, groups), t)
    # groups 2: each rank holds its slice of the first half, then of the second
    assert split_part(torch.arange(8), 0, 2, 1, 2).tolist() == [2, 3, 6, 7]


# -- the ranks -------------------------------------------------------------------


OPS = ("copy", "reduce", "gather", "gather2", "scatter")


def ops_spec():
    """Each operator's per-rank inputs and upstream weights: the inputs of
    a replicated operand (copy, scatter) are the same on both ranks; the
    weights that multiply a replicated output (reduce, gather) too."""
    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).float()
    x_rep, x_part = r(2, 4, 3), [r(2, 4, 3) for _ in range(2)]
    x = {"copy": [x_rep, x_rep], "scatter": [x_rep, x_rep], "reduce": x_part,
         "gather": x_part, "gather2": x_part}
    w_rep8 = r(2, 8, 3)
    w = {"copy": [r(2, 4, 3) for _ in range(2)], "scatter": [r(2, 2, 3) for _ in range(2)],
         "reduce": [r(2, 4, 3)] * 2, "gather": [w_rep8] * 2, "gather2": [w_rep8] * 2}
    cfg = tiny(tcfg, sn=True)
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(3))
    return {"x": x, "w": w, "cfg": cfg, "state_dict": model.state_dict(), "n_model": 2}


def one_process_ops(spec, op):
    """The operator's one-process function of both ranks' inputs, its
    output and each rank's input gradient (the loss is the sum of both
    ranks' weighted outputs)."""
    xs = [t.clone().requires_grad_(True) for t in spec["x"][op]]
    ws = spec["w"][op]
    if op == "copy":  # x replicated, each rank its own consumer
        ys = [xs[0], xs[0]]
        loss = sum((y * w).sum() for y, w in zip(ys, ws))
    elif op == "scatter":
        ys = [xs[0][:, :2], xs[0][:, 2:]]
        loss = sum((y * w).sum() for y, w in zip(ys, ws))
    elif op == "reduce":
        ys = [xs[0] + xs[1]] * 2
        loss = (ys[0] * ws[0]).sum()
    else:
        y = torch.cat(xs, 1)
        if op == "gather2":  # rank r's [a_r | b_r] -> [a_0 a_1 | b_0 b_1]
            y = torch.cat([xs[0][:, :2], xs[1][:, :2], xs[0][:, 2:], xs[1][:, 2:]], 1)
        ys = [y, y]
        loss = (y * ws[0]).sum()
    loss.backward()
    grads = [xs[0].grad] * 2 if op in ("copy", "scatter") else [x.grad for x in xs]
    return [y.detach() for y in ys], grads


def tp_draw_variants(world):
    rng = np.random.default_rng(7)
    batches = lambda: [rng.standard_normal((8, 16, 8)).astype(np.float32) for _ in range(DRAW_STEPS)]
    out = [
        {"name": f"dropout={rate}", "cfg": with_dropout(tiny(tcfg, sn=True), rate), "seed": 11,
         "batches": batches(), "eval_batch": rng.standard_normal((8, 16, 8)).astype(np.float32)}
        for rate in (0.0, 0.1)
    ]
    if world == 2:
        out.append({"name": "bf16", "cfg": tiny(tcfg, compute_dtype="bfloat16"), "seed": 11,
                    "batches": batches(), "eval_batch": out[0]["eval_batch"]})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank groups run while this process computes the JAX steps."""
    groups, specs = {}, {}
    for name, case, world, spec in (
        ("ops", "tp_ops", 2, ops_spec()),
        ("step", "step", 4, {"variants": [step_variant(sn) for sn in (False, True)], "n_model": 2}),
        ("draws2", "draws", 2, {"variants": tp_draw_variants(2), "n_model": 2}),
        ("draws4", "draws", 4, {"variants": tp_draw_variants(4), "n_model": 4}),
    ):
        work = tmp_path_factory.mktemp(f"tp_{name}")
        torch.save(spec, work / f"in_{case}.pt")
        specs[name] = spec
        groups[name] = RankGroup(case, work, world)
    refs = {sn: jax_reference(sn) for sn in (False, True)}
    out = {name: g.results() for name, g in groups.items()}
    return {"refs": refs, "specs": specs, **out}


def test_model_axis_layout(runs):
    assert [o["fields"] for o in runs["ops"]] == [(1, 2, 0, 0), (1, 2, 0, 1)]


@pytest.mark.parametrize("op", OPS)
def test_megatron_operator_matches_autograd(runs, op):
    ys, grads = one_process_ops(runs["specs"]["ops"], op)
    for r, out in enumerate(runs["ops"]):
        y, g = out[op]
        np.testing.assert_allclose(y.numpy(), ys[r].numpy(), rtol=1e-6, err_msg=f"{op} rank {r}")
        np.testing.assert_allclose(g.numpy(), grads[r].numpy(), rtol=1e-6, err_msg=f"{op} grad rank {r}")


def test_split_then_gathered_is_bit_exact(runs):
    want = runs["specs"]["ops"]["state_dict"]
    specs = tp_param_specs(want, 2)
    for r, out in enumerate(runs["ops"]):
        assert set(out["gathered"]) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(out["gathered"][k], v, rtol=0, atol=0, msg=k)
            local = out["local"][k]
            if specs[k] is None:
                assert torch.equal(local, v), k
            else:  # a shard: half the split axis
                assert local.shape[specs[k]] * 2 == v.shape[specs[k]], k
    # the paired AdaIN affine holds its channels' mean rows, then their std rows
    w = want["decoder.conv_affine_layers.0.weight_orig"]
    c = w.shape[0] // 2
    for r, out in enumerate(runs["ops"]):
        local = out["local"]["decoder.conv_affine_layers.0.weight_orig"]
        lo, hi = r * c // 2, (r + 1) * c // 2
        assert torch.equal(local, torch.cat([w[lo:hi], w[c + lo:c + hi]]))


@pytest.mark.parametrize(
    "name,kind,match",
    [("uncovered", "ValueError", "does not cover 2 ranks"),
     ("scatter", "ValueError", "3 channels over 2 ranks")],
)
def test_tp_errors(runs, name, kind, match):
    for out in runs["ops"]:
        got = out["errors"][name]
        assert got is not None and got[0] == kind and match in got[1], got


@pytest.mark.parametrize("sn", [False, True])
def test_dp2_tp2_equals_the_jax_step(runs, sn):
    variant, ref_params, ref_m = runs["refs"][sn]
    for out in runs["step"]:
        got = out[variant["name"]]
        np.testing.assert_allclose(got["metrics"]["loss"], ref_m["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], ref_m["grad_norm"], rtol=1e-4)
        ours = jax_params_from_state_dict(got["params"], variant["cfg"].model)
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref_params)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree_util.tree_leaves(ref_params)):
            np.testing.assert_allclose(a, b, atol=5e-6, rtol=1e-5, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("sn", [False, True])
def test_dp2_tp2_gathered_gradient_is_the_global_batch_gradient(runs, sn):
    """Relative Frobenius 1e-5 over all tensors, as for the data axis alone
    (tests/test_torch_dist_step.py)."""
    variant = runs["refs"][sn][0]
    want = one_process_grads(variant)
    flat = lambda gs: torch.cat([gs[k].reshape(-1) for k in sorted(gs)])
    for out in runs["step"]:
        grads = out[variant["name"]]["grads_whole"]
        assert set(grads) == set(want)
        rel = float(torch.linalg.norm(flat(grads) - flat(want)) / torch.linalg.norm(flat(want)))
        assert rel <= 1e-5, rel


def replicated_keys(state_dict, n_model):
    return [k for k, d in tp_param_specs(state_dict, n_model).items() if d is None]


@pytest.mark.parametrize("sn", [False, True])
def test_dp2_tp2_replicated_gradients_equal_on_model_ranks(runs, sn):
    name = runs["refs"][sn][0]["name"]
    sd = runs["refs"][sn][0]["state_dict"]
    keys = replicated_keys(sd, 2)
    grads = [dict(out[name]["grads"]) for out in runs["step"]]
    assert any(k.endswith("bias") for k in keys)  # the row layers' biases
    for a, b in ((0, 1), (2, 3)):  # the model groups
        for k in keys:
            if k in grads[a]:
                assert torch.equal(grads[a][k], grads[b][k]), k
        assert runs["step"][a][name]["metrics"] == runs["step"][b][name]["metrics"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tp_equals_one_process_with_generator_draws(runs, world, rate):
    v = next(v for v in runs["specs"][f"draws{world}"]["variants"] if v["name"] == f"dropout={rate}")
    want = one_process_draws(v)
    for out in runs[f"draws{world}"]:
        got = out[v["name"]]
        np.testing.assert_allclose(got["rows"], want["rows"], rtol=1e-5)
        for k in ("loss_rec", "loss_kl", "loss"):
            np.testing.assert_allclose(got["eval"][k], want["eval"][k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_replicated_parameters_equal_bit_for_bit(runs, world):
    outs = runs[f"draws{world}"]
    for v in runs["specs"][f"draws{world}"]["variants"]:
        keys = replicated_keys(outs[0][v["name"]]["params"], world)
        rows0 = outs[0][v["name"]]["rows"]
        for out in outs[1:]:
            got = out[v["name"]]
            assert got["rows"] == rows0
            for k in keys:
                assert torch.equal(got["local"][k], outs[0][v["name"]]["local"][k]), k
            for k, t in got["params"].items():
                assert torch.equal(t, outs[0][v["name"]]["params"][k]), k


def test_tp_bf16_step_matches_one_process(runs):
    v = next(v for v in runs["specs"]["draws2"]["variants"] if v["name"] == "bf16")
    want = one_process_draws(v)
    for out in runs["draws2"]:
        got = np.asarray(out["bf16"]["rows"])
        np.testing.assert_allclose(got[:, :3], np.asarray(want["rows"])[:, :3], rtol=3e-2)
        assert np.isfinite(got).all()
