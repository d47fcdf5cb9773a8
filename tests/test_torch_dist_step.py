"""The port's data-parallel step (train/step.py with a mesh) on gloo ranks on
the CPU, against the JAX package's step and against one process of the port
on the global batch.

Ranks run in their own processes (tests/torch_dist_worker.py); a
module-scoped fixture starts each group of ranks once and the tests below
assert on what they wrote.

Tolerances, the JAX package's own for its sharded step
(tests/test_distributed.py:58-65 and :91-102):
- 2 ranks against the JAX step on the global batch, each rank fed its rows
  of the JAX ``eps``: loss and ``grad_norm`` rtol 1e-5, every parameter atol
  2e-6, with and without spectral norm. (The batch is seeded 3: with
  spectral norm and seed 0 one decoder weight has ``g + wd * p`` within
  rounding of zero, and Adam's first step, lr x g / (|g| + 1e-8), turns
  that rounding into 6.9e-4 between the two packages in one process
  already; the step's parity then says nothing about the data axis.)
- the all-reduced gradient against one process's gradient of the global
  batch: relative Frobenius 1e-5 over all tensors (not tensor by tensor: a
  convolution bias that an instance norm follows has a gradient of exactly
  zero, so its computed value is rounding noise);
- 2 and 4 ranks with every draw from the step's generator (``eps`` and the
  dropout masks at the global shape), dropout 0 and 0.1, against one
  process: per-step loss terms and ``grad_norm`` rtol 1e-5 over 3 steps,
  then the mesh eval step rtol 1e-5;
- the ranks' metrics and parameters equal each other bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.models.weights import jax_params_from_state_dict
from adaptive_voice_conversion_tpu_torch.train.optim import kl_lambda, make_optimizer
from adaptive_voice_conversion_tpu_torch.train.step import make_eval_step, make_train_step, step_seed

from test_torch_solver import one_intra_op_thread  # noqa: F401
from test_torch_train import batch, both, j_make_train_step, jax_eps, tiny
from torch_dist_worker import RankGroup

SEED = 3
LAM = 0.7
DRAW_STEPS = 3


def with_dropout(cfg, rate):
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m,
        speaker_encoder=dataclasses.replace(m.speaker_encoder, dropout_rate=rate),
        content_encoder=dataclasses.replace(m.content_encoder, dropout_rate=rate),
        decoder=dataclasses.replace(m.decoder, dropout_rate=rate),
    ))


def step_variant(sn):
    """The port's inputs: the JAX package's weights (as a state_dict), the
    global batch of 8 and the JAX step's ``eps`` for it."""
    _, _, t, model = both(sn=sn)
    rng = jax.random.PRNGKey(SEED)
    return {"name": f"sn={sn}", "cfg": t, "state_dict": model.state_dict(),
            "x": batch(SEED, b=8), "eps": jax_eps(rng, (8, 8, 8)), "lam": LAM}


def jax_reference(sn):
    """The JAX step on the global batch: (the port's inputs, parameters
    after the step, metrics)."""
    j, params, _, _ = both(sn=sn)
    variant = step_variant(sn)
    init_fn, step = j_make_train_step(j)
    p1, _, m1 = step(params, init_fn(params), jnp.asarray(variant["x"]),
                     jax.random.PRNGKey(SEED), jnp.float32(LAM))
    return variant, jax.tree_util.tree_map(np.asarray, p1), {k: float(v) for k, v in m1.items()}


def one_process_grads(v):
    model = AE(v["cfg"].model)
    model.load_state_dict(v["state_dict"], strict=True)
    opt = make_optimizer(v["cfg"].optimizer, model.parameters())
    make_train_step(v["cfg"], model, opt)(torch.from_numpy(v["x"]), LAM, eps=torch.from_numpy(v["eps"]))
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def draw_variants():
    rng = np.random.default_rng(7)
    return [
        {"name": f"dropout={rate}", "cfg": with_dropout(tiny(tcfg), rate), "seed": 11,
         "batches": [rng.standard_normal((8, 16, 8)).astype(np.float32) for _ in range(DRAW_STEPS)],
         "eval_batch": rng.standard_normal((8, 16, 8)).astype(np.float32)}
        for rate in (0.0, 0.1)
    ]


def one_process_draws(v):
    """case_draws of the worker with no mesh: the whole batch, one process."""
    cfg = v["cfg"]
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(v["seed"]))
    opt = make_optimizer(cfg.optimizer, model.parameters())
    step = make_train_step(cfg, model, opt)
    gen = torch.Generator()
    rows = []
    for it, x in enumerate(v["batches"]):
        gen.manual_seed(step_seed(v["seed"], it))
        m = step(torch.from_numpy(x), kl_lambda(it, 1.0, 4), generator=gen)
        rows.append([float(m[k]) for k in ("loss", "loss_rec", "loss_kl", "grad_norm")])
    ev = make_eval_step(cfg, model)(torch.from_numpy(v["eval_batch"]), 0.5)
    return {"rows": rows, "eval": {k: float(t) for k, t in ev.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank groups run while this process computes the JAX steps."""
    work = tmp_path_factory.mktemp("dist_step")
    torch.save({"variants": [step_variant(sn) for sn in (False, True)]}, work / "in_step.pt")
    variants = draw_variants()
    torch.save({"variants": variants}, work / "in_draws.pt")
    torch.save({}, work / "in_mesh.pt")
    step, draws2, mesh = (RankGroup(c, work) for c in ("step", "draws", "mesh"))
    refs = {sn: jax_reference(sn) for sn in (False, True)}
    out = {"refs": refs, "draw_variants": variants, "step": step.results(),
           "mesh": mesh.results(), "draws": {2: draws2.results()}}
    out["draws"][4] = RankGroup("draws", work, world=4).results()
    return out


@pytest.mark.parametrize("sn", [False, True])
def test_two_ranks_equal_the_jax_step(runs, sn):
    variant, ref_params, ref_m = runs["refs"][sn]
    for out in runs["step"]:
        got = out[variant["name"]]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], ref_m[k], rtol=1e-5, err_msg=k)
        ours = jax_params_from_state_dict(got["params"], variant["cfg"].model)
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref_params)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree_util.tree_leaves(ref_params)):
            np.testing.assert_allclose(a, b, atol=2e-6, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("sn", [False, True])
def test_all_reduced_gradient_is_the_global_batch_gradient(runs, sn):
    variant = runs["refs"][sn][0]
    want = one_process_grads(variant)
    flat = lambda gs: torch.cat([gs[k].reshape(-1) for k in sorted(gs)])
    for out in runs["step"]:
        grads = out[variant["name"]]["grads"]
        assert set(grads) == set(want)
        rel = float(torch.linalg.norm(flat(grads) - flat(want)) / torch.linalg.norm(flat(want)))
        assert rel <= 1e-5, rel


def state_of(out, name):
    got = out[name]
    return got.get("metrics", got.get("rows")), got["params"]


@pytest.mark.parametrize(
    "group,name",
    [("step", "sn=False"), ("step", "sn=True"), ("draws2", "dropout=0.0"),
     ("draws2", "dropout=0.1"), ("draws4", "dropout=0.1")],
)
def test_ranks_hold_one_state_bit_for_bit(runs, group, name):
    outs = runs["draws"][int(group[-1])] if group.startswith("draws") else runs[group]
    m0, p0 = state_of(outs[0], name)
    for out in outs[1:]:
        m, p = state_of(out, name)
        assert m == m0
        for k, v in p.items():
            torch.testing.assert_close(v, p0[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ranks_equal_one_process_with_generator_draws(runs, world, rate):
    v = next(v for v in runs["draw_variants"] if v["name"] == f"dropout={rate}")
    want = one_process_draws(v)
    for out in runs["draws"][world]:
        got = out[v["name"]]
        np.testing.assert_allclose(got["rows"], want["rows"], rtol=1e-5)
        for k in ("loss_rec", "loss_kl", "loss"):
            np.testing.assert_allclose(got["eval"][k], want["eval"][k], rtol=1e-5, err_msg=k)
    if rate:
        # the masks took effect: the draws differ from a dropout-free run
        plain = next(p for p in runs["draw_variants"] if p["name"] == "dropout=0.0")
        assert one_process_draws(plain)["rows"][0][1] != want["rows"][0][1]


def test_mesh_layout(runs):
    for r, out in enumerate(runs["mesh"]):
        assert out["fields"] == (2, 1, r, 2, r, 0, "cpu")
        assert out["again"] == "gloo"
        assert out["local_batch"] == 4
        assert out["rows"] == list(range(4 * r, 4 * r + 4))
        assert out["window"] == (4 * r, 4 * r + 4, 8)


def test_mesh_collectives(runs):
    for out in runs["mesh"]:
        assert out["max"] == 13
        assert out["mean"] == [0.5, 0.5, 0.5]
        assert out["gathered"] == [[0.0] * 3, [0.0] * 3, [1.0] * 3, [1.0] * 3]
        assert out["gathered_bf16"] == [[1.5, 1.5], [2.5, 2.5]]
        assert out["replicated"] == [[0.0] * 4, [0.0]]  # rank 0's values


@pytest.mark.parametrize(
    "name,kind,match",
    [("uncovered", "ValueError", "does not cover 2 ranks"),
     ("n_model", "ValueError", "mesh 2x2 does not cover 2 ranks"),
     ("indivisible", "ValueError", "not divisible")],
)
def test_mesh_errors(runs, name, kind, match):
    for out in runs["mesh"]:
        got = out["errors"][name]
        assert got is not None and got[0] == kind and match in got[1], got
