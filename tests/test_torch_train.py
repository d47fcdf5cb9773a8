"""The port's training step (adaptive_voice_conversion_tpu_torch.train)
against the JAX package's on the same seeded numpy inputs, on the CPU.

Tolerances, each where it is used:
- optimiser vs the JAX chain, 10 steps with clipping active: atol 1e-5 after
  the first step, 1e-4 after the last (tests/test_train.py's own bounds);
  the f32 moments rtol 1e-3 (they take in wd * p of parameters that differ
  by then); with bf16 state the parameters to 2e-4 after 10 steps and the stored
  moments as bf16 bit patterns within 1 unit in the last place (a fused
  multiply-add on one side may flip a rounding);
- ``loss_terms`` with the JAX function's own ``eps``: rtol 1e-5;
- 20-step trajectories of the tiny AE: per-step ``loss`` rtol 2e-4 (the JAX
  package's bound for its sn trajectory), final parameters atol 2e-4, the
  spectral-norm ``u`` atol 1e-3;
- the spectrally normalised weight atol 1e-6 and its gradient rtol 1e-4;
- the bf16 compute path: losses rtol 3e-2 (bf16 has 8 bits of mantissa and
  the two packages' convolutions sum in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from adaptive_voice_conversion_tpu.core import config as jcfg
from adaptive_voice_conversion_tpu.models import init_ae
from adaptive_voice_conversion_tpu.models.modules import _sn_params
from adaptive_voice_conversion_tpu.train import kl_lambda as j_kl_lambda
from adaptive_voice_conversion_tpu.train import make_optimizer as j_make_optimizer
from adaptive_voice_conversion_tpu.train import make_train_step as j_make_train_step
from adaptive_voice_conversion_tpu.train.step import loss_terms as j_loss_terms
from adaptive_voice_conversion_tpu.train.step import make_eval_step as j_make_eval_step
from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import (
    SpectralNormConv1d,
    SpectralNormLinear,
    dropout,
    spectral_norm_update,
)
from adaptive_voice_conversion_tpu_torch.models.weights import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from adaptive_voice_conversion_tpu_torch.train.optim import TorchAdam, kl_lambda, make_optimizer
from adaptive_voice_conversion_tpu_torch.train.step import (
    loss_terms,
    make_eval_step,
    make_train_step,
)

TINY_KW = dict(
    speaker_encoder=dict(
        c_in=8, c_h=8, c_out=8, kernel_size=5, bank_size=4, bank_scale=1,
        c_bank=4, n_conv_blocks=2, n_dense_blocks=1, subsample=(1, 2),
    ),
    content_encoder=dict(
        c_in=8, c_h=8, c_out=8, kernel_size=5, bank_size=4, bank_scale=1,
        c_bank=4, n_conv_blocks=2, subsample=(1, 2),
    ),
    decoder=dict(
        c_in=8, c_cond=8, c_h=8, c_out=8, kernel_size=5,
        n_conv_blocks=2, upsample=(2, 1),
    ),
)


def tiny(mod, sn=False, **top):
    """The TINY config of tests/test_train.py in either package."""
    return mod.TrainConfig(
        model=mod.AEConfig(
            speaker_encoder=mod.SpeakerEncoderConfig(**TINY_KW["speaker_encoder"]),
            content_encoder=mod.ContentEncoderConfig(**TINY_KW["content_encoder"]),
            decoder=mod.DecoderConfig(**TINY_KW["decoder"], sn=sn),
        ),
        data_loader=mod.DataLoaderConfig(segment_size=16, batch_size=4),
        **top,
    )


def batch(seed=0, b=4, t=16, c=8):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)


def jax_eps(rng, shape):
    """The normal draw ae_forward makes from ``rng``."""
    return np.asarray(jax.random.normal(jax.random.split(rng, 4)[0], shape, jnp.float32))


def both(sn=False, seed=0, **top):
    """(JAX config, JAX params, port config, port model) on the same weights."""
    j, t = tiny(jcfg, sn, **top), tiny(tcfg, sn, **top)
    params = init_ae(jax.random.PRNGKey(seed), j.model)
    model = AE(t.model)
    model.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), t.model),
        strict=True,
    )
    return j, params, t, model


def flat(tree):
    return np.concatenate([np.ravel(np.asarray(l)) for l in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("it,want", [(0, 1 / 20000), (9999, 0.5), (19999, 1.0), (50000, 1.0)])
def test_kl_lambda_schedule(it, want):
    assert kl_lambda(it, 1.0, 20000) == pytest.approx(want)
    assert kl_lambda(it, 1.0, 20000) == pytest.approx(float(j_kl_lambda(it, 1.0, 20000)))


def bits(x):
    return x.detach().view(torch.int16).numpy().astype(np.int32)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amsgrad", [True, False])
def test_optimizer_matches_jax_chain(amsgrad, state_dtype):
    """10 steps on a small tree with clipping active (gradient norms ~4 to
    9 against a threshold of 0.5) and weight decay, against make_optimizer."""
    kw = dict(lr=0.1, weight_decay=0.1, grad_norm=0.5, amsgrad=amsgrad)
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 3, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (1.0 + i % 3) * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        for i in range(10)
    ]

    j_opt = j_make_optimizer(jcfg.OptimizerConfig(**kw), state_dtype=state_dtype)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    j_state = j_opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    t_opt = make_optimizer(tcfg.OptimizerConfig(**kw), tp.values(), state_dtype=state_dtype)
    assert isinstance(t_opt, TorchAdam)

    for i, g in enumerate(grads):
        upd, j_state = j_opt.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = t_opt.step()
        want_norm = np.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        assert want_norm > kw["grad_norm"]  # clipping is active
        for k, p in tp.items():  # the step leaves the gradients as they were
            np.testing.assert_array_equal(p.grad.numpy(), g[k])
        if i == 0:
            for k in shapes:
                np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-5)
    atol = 1e-4 if state_dtype == "float32" else 2e-4
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=atol)

    # the stored moments
    adam = j_state[2]
    names = [("mu", "exp_avg"), ("nu", "exp_avg_sq")] + ([("nu_max", "max_exp_avg_sq")] if amsgrad else [])
    for j_name, t_name in names:
        for k in shapes:
            ours = t_opt.state[tp[k]][t_name]
            ref = np.asarray(getattr(adam, j_name)[k])
            if state_dtype == "bfloat16":
                assert ours.dtype == torch.bfloat16 and ref.dtype.name == "bfloat16"
                assert np.abs(bits(ours) - ref.view(np.int16).astype(np.int32)).max() <= 1
            else:
                assert ours.dtype == torch.float32
                np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-3, atol=1e-6)
    assert ("max_exp_avg_sq" in t_opt.state[tp["a"]]) == amsgrad


def test_optimizer_state_dict_roundtrip_keeps_bf16():
    p = torch.nn.Parameter(torch.ones(4))
    opt = make_optimizer(tcfg.OptimizerConfig(), [p], state_dtype="bfloat16")
    p.grad = torch.full((4,), 0.3)
    opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = make_optimizer(tcfg.OptimizerConfig(), [q], state_dtype="bfloat16")
    opt2.load_state_dict(opt.state_dict())
    assert opt2.state[q]["exp_avg"].dtype == torch.bfloat16
    p.grad = torch.full((4,), -0.1)
    q.grad = torch.full((4,), -0.1)
    opt.step(), opt2.step()
    torch.testing.assert_close(q, p, rtol=0, atol=0)


def test_opt_fused_raises_and_buffers_are_not_optimised():
    """``opt_fused`` with spectral norm raises, naming ``sn``, as in the JAX
    package; the spectral-norm buffers are never given to the optimiser."""
    cfg = tiny(tcfg, sn=True)
    model = AE(cfg.model)
    for fused in ("bucketed4", True):
        with pytest.raises(ValueError, match="sn"):
            make_optimizer(cfg.optimizer, model.parameters(), fused=fused, sn=True)
        with pytest.raises(ValueError):
            j_make_optimizer(jcfg.OptimizerConfig(), sn=True, fused=fused)
    opt = make_optimizer(cfg.optimizer, model.parameters(), sn=True)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    buffers = dict(model.named_buffers())
    assert sum(k.endswith("weight_u") for k in buffers) == 2 + 4 * cfg.model.decoder.n_conv_blocks
    assert all(id(b) not in held for b in buffers.values())
    assert held == {id(p) for p in model.parameters()}
    # one step: no state is made for a buffer
    step = make_train_step(cfg, model, opt)
    step(torch.from_numpy(batch()), 0.1, generator=torch.Generator().manual_seed(0))
    assert len(opt.state) == len(held)


@pytest.mark.parametrize("sn", [False, True])
def test_loss_terms_match_jax(sn):
    j, params, t, model = both(sn=sn)
    x = batch(1)
    rng = jax.random.PRNGKey(7)
    j_rec, j_kl, (mu, ls, emb, dec) = j_loss_terms(j, params, jnp.asarray(x), rng)
    eps = jax_eps(rng, ls.shape)
    model.train()
    with torch.no_grad():
        rec, kl, (tmu, tls, temb, tdec) = loss_terms(
            model, t, torch.from_numpy(x), eps=torch.from_numpy(eps)
        )
    np.testing.assert_allclose(float(rec), float(j_rec), rtol=1e-5)
    np.testing.assert_allclose(float(kl), float(j_kl), rtol=1e-5)
    for ours, ref in ((tmu, mu), (tls, ls), (temb, emb), (tdec, dec)):
        assert tuple(ours.shape) == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


def run_trajectory(sn, n_steps=20, **top):
    j, params, t, model = both(sn=sn, **top)
    init_fn, j_step = j_make_train_step(j)
    opt_state = init_fn(params)
    opt = make_optimizer(t.optimizer, model.parameters(), state_dtype=t.opt_state_dtype)
    step = make_train_step(t, model, opt)
    t_c = 16 // 2
    rows = []
    for i in range(n_steps):
        x = batch(100 + i)
        rng = jax.random.PRNGKey(i)
        lam = float(kl_lambda(i, 1.0, 8))
        eps = jax_eps(rng, (4, t_c, 8))
        params, opt_state, jm = j_step(params, opt_state, jnp.asarray(x), rng, jnp.float32(lam))
        tm = step(torch.from_numpy(x), lam, eps=torch.from_numpy(eps))
        assert all(isinstance(v, torch.Tensor) for v in tm.values())
        rows.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()}))
    return params, model, t, rows


@pytest.mark.parametrize("sn", [False, True])
def test_trajectory_matches_jax(sn):
    """20 steps of the whole tiny AE from the same weights, batches, lambda
    and eps: per-step loss rtol 2e-4, the pre-clip grad_norm rtol 1e-3, the
    final parameters leaf by leaf atol 2e-4, and with sn the power-iteration
    vectors atol 1e-3."""
    params, model, t, rows = run_trajectory(sn)
    for i, (jm, tm) in enumerate(rows):
        assert set(tm) == {"loss", "loss_rec", "loss_kl", "grad_norm"}
        for k in ("loss", "loss_rec", "loss_kl"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, err_msg=f"{k} at step {i}")
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-3)
    ours = jax_params_from_state_dict(model.state_dict(), t.model)
    ref = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref)
    for (path, a), b in zip(
        jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves(ref)
    ):
        is_u = "'u'" in jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            a, b, atol=1e-3 if is_u else 2e-4, err_msg=jax.tree_util.keystr(path)
        )
    if sn:
        u = model.decoder.in_conv_layer.weight_u.numpy()
        np.testing.assert_allclose(u, ref["decoder"]["in_conv"]["u"], atol=1e-3)
        assert np.linalg.norm(u) == pytest.approx(1.0, abs=1e-5)


def test_weights_roundtrip_with_sn():
    """state_dict_from_jax_params takes sn=True trees; the inverse returns
    the tree; weight_v is W^T u normalised, as a reference-format sn
    checkpoint stores it."""
    j, params, t, model = both(sn=True, seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    back = jax_params_from_state_dict(model.state_dict(), t.model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(np_params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    layer = model.decoder.first_conv_layers[0]
    w = layer.weight_orig.detach().reshape(layer.weight_orig.shape[0], -1)
    v = w.t() @ layer.weight_u
    torch.testing.assert_close(layer.weight_v, v / v.norm(), rtol=1e-5, atol=1e-6)
    # the same key set torch.nn.utils.spectral_norm gives a layer
    ref = torch.nn.utils.spectral_norm(torch.nn.Conv1d(8, 8, 5))
    assert set(ref.state_dict()) == set(layer.state_dict())


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_spectral_norm_weight_and_gradient_match_jax(kind):
    """The normalised weight and d(sum(c * w/sigma))/dw, which carries the
    -W u v^T / sigma^2 term, against _sn_params."""
    rng = np.random.default_rng(5)
    if kind == "conv":
        k, ci, co = 5, 4, 6
        w = rng.standard_normal((k, ci, co)).astype(np.float32)
        layer = SpectralNormConv1d(ci, co, k)
        to_t = lambda a: np.ascontiguousarray(a.transpose(2, 1, 0))
    else:
        ci, co = 6, 5
        w = rng.standard_normal((ci, co)).astype(np.float32)
        layer = SpectralNormLinear(ci, co)
        to_t = lambda a: np.ascontiguousarray(a.T)
    u = rng.standard_normal(co).astype(np.float32)
    u /= np.linalg.norm(u)
    # w in the cotangent makes sum(c * W), the sigma term's factor, large
    c = (w + 0.3 * rng.standard_normal(w.shape)).astype(np.float32)
    p = {"w": jnp.asarray(w), "b": jnp.zeros((co,)), "u": jnp.asarray(u)}
    ref_w = np.asarray(_sn_params(p)["w"])
    ref_g = np.asarray(
        jax.grad(lambda ww: jnp.sum(jnp.asarray(c) * _sn_params({**p, "w": ww})["w"]))(p["w"])
    )
    with torch.no_grad():
        layer.weight_orig.copy_(torch.from_numpy(to_t(w)))
        layer.weight_u.copy_(torch.from_numpy(u))
    eff = layer.weight
    (torch.from_numpy(to_t(c)) * eff).sum().backward()
    np.testing.assert_allclose(eff.detach().numpy(), to_t(ref_w), atol=1e-6)
    g = layer.weight_orig.grad.numpy()
    np.testing.assert_allclose(g, to_t(ref_g), rtol=1e-4, atol=1e-6)
    # the closed form: c / sigma - (sum(c * W) / sigma^2) u' v^T
    wm = to_t(w).reshape(co, -1).astype(np.float64)
    v = wm.T @ u
    v /= np.linalg.norm(v)
    u2 = wm @ v
    u2 /= np.linalg.norm(u2)
    sigma = u2 @ wm @ v
    cm = to_t(c).reshape(co, -1)
    term = (cm * wm).sum() / sigma**2 * np.outer(u2, v)
    np.testing.assert_allclose(g.reshape(co, -1), cm / sigma - term, rtol=1e-4, atol=1e-6)
    assert np.abs(term).max() > 1e-2 * np.abs(g).max()  # and the term is not small
    # the forward left the stored u alone
    np.testing.assert_array_equal(layer.weight_u.numpy(), u)


def test_u_moves_once_per_train_step_and_never_in_eval():
    j, params, t, model = both(sn=True)
    u_of = lambda: model.decoder.in_conv_layer.weight_u.clone()
    x = torch.from_numpy(batch(2))
    u0 = u_of()
    model.eval()
    with torch.no_grad():
        model(x, generator=torch.Generator().manual_seed(0))
        model.inference(x, x)
    model.train()
    model(x, generator=torch.Generator().manual_seed(0))  # a training-mode forward alone
    torch.testing.assert_close(u_of(), u0, rtol=0, atol=0)

    eval_step = make_eval_step(t, model)
    a = eval_step(x, 0.5)
    b = eval_step(x, 0.5)
    torch.testing.assert_close(u_of(), u0, rtol=0, atol=0)
    assert model.training  # the mode is restored
    assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    assert set(a) == {"loss", "loss_rec", "loss_kl"}
    assert float(a["loss"]) == pytest.approx(
        10.0 * float(a["loss_rec"]) + 0.5 * float(a["loss_kl"]), rel=1e-6
    )

    # the step advances u from the weights it started with
    w0 = model.decoder.in_conv_layer.weight_orig.detach().clone()
    opt = make_optimizer(t.optimizer, model.parameters())
    make_train_step(t, model, opt)(x, 0.1, generator=torch.Generator().manual_seed(1))
    wm = w0.reshape(w0.shape[0], -1)
    v = wm.t() @ u0
    v = v / (v.norm() + 1e-12)
    want = wm @ v
    want = want / (want.norm() + 1e-12)
    torch.testing.assert_close(u_of(), want, rtol=1e-6, atol=1e-7)
    assert not torch.equal(model.decoder.in_conv_layer.weight_orig, w0)
    # and it matches the JAX step's u
    init_fn, j_step = j_make_train_step(j)
    p2, _, _ = j_step(params, init_fn(params), jnp.asarray(batch(2)), jax.random.PRNGKey(1), jnp.float32(0.1))
    np.testing.assert_allclose(u_of().numpy(), np.asarray(p2["decoder"]["in_conv"]["u"]), atol=1e-5)


def test_eval_step_matches_jax_formula():
    """The JAX eval step with its eps fed in gives the port's loss terms;
    the port's own draw comes from a generator seeded 0 on every call."""
    j, params, t, model = both()
    x = batch(4)
    jm = j_make_eval_step(j)(params, jnp.asarray(x), jnp.float32(0.3))
    eps = jax_eps(jax.random.PRNGKey(0), (4, 8, 8))
    model.eval()
    with torch.no_grad():
        rec, kl, _ = loss_terms(model, t, torch.from_numpy(x), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(rec), float(jm["loss_rec"]), rtol=1e-5)
    np.testing.assert_allclose(float(kl), float(jm["loss_kl"]), rtol=1e-5)
    np.testing.assert_allclose(
        10.0 * float(rec) + 0.3 * float(kl), float(jm["loss"]), rtol=1e-5
    )
    ours = make_eval_step(t, model)(torch.from_numpy(x), 0.3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        rec0, kl0, _ = loss_terms(model, t, torch.from_numpy(x), generator=gen)
    assert float(ours["loss_rec"]) == float(rec0) and float(ours["loss_kl"]) == float(kl0)


def test_grad_norm_metric_is_preclip():
    j, params, t, model = both()
    opt = make_optimizer(t.optimizer, model.parameters())
    x = batch() * 50
    m = make_train_step(t, model, opt)(
        torch.from_numpy(x), 1.0, eps=torch.zeros(4, 8, 8)
    )
    assert float(m["grad_norm"]) > t.optimizer.grad_norm
    want = np.sqrt(sum(float(p.grad.square().sum()) for p in model.parameters()))
    assert float(m["grad_norm"]) == pytest.approx(want, rel=1e-5)


def test_bfloat16_compute_path_matches_jax():
    """compute_dtype=bfloat16 in both packages, one step from the same
    weights with the same eps: losses rtol 3e-2; the parameters stay f32."""
    params, model, t, rows = run_trajectory(False, n_steps=3, compute_dtype="bfloat16")
    for jm, tm in rows:
        for k in ("loss", "loss_rec", "loss_kl"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=3e-2)
        assert np.isfinite(tm["grad_norm"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(batch(9))
    model.eval()
    with torch.no_grad():
        mu, ls, emb, dec = model(x, eps=torch.zeros(4, 8, 8), compute_dtype=torch.bfloat16)
        mu32, *_ = model(x, eps=torch.zeros(4, 8, 8))
    assert mu.dtype == ls.dtype == emb.dtype == dec.dtype == torch.bfloat16
    assert mu32.dtype == torch.float32


def test_bf16_optimizer_state_tracks_f32():
    """opt_state_dtype=bfloat16 in the whole step: moments stored in bf16,
    parameters f32, and 10 steps stay within 5e-4 of the f32-state run
    (the JAX package's own bound for this pair)."""
    _, _, t32, m32 = both()
    _, _, t16, m16 = both(opt_state_dtype="bfloat16")
    o32 = make_optimizer(t32.optimizer, m32.parameters(), state_dtype=t32.opt_state_dtype)
    o16 = make_optimizer(t16.optimizer, m16.parameters(), state_dtype=t16.opt_state_dtype)
    s32, s16 = make_train_step(t32, m32, o32), make_train_step(t16, m16, o16)
    for i in range(10):
        x = torch.from_numpy(batch(i))
        eps = torch.from_numpy(batch(50 + i, 4, 8, 8))
        a, b = s32(x, 0.5, eps=eps), s16(x, 0.5, eps=eps)
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in o16.state.values())
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    pa = torch.cat([p.detach().ravel() for p in m32.parameters()])
    pb = torch.cat([p.detach().ravel() for p in m16.parameters()])
    torch.testing.assert_close(pb, pa, rtol=0, atol=5e-4)
    assert abs(float(a["loss"]) - float(b["loss"])) < 1e-2


def test_dropout_is_seeded_scaled_and_off_in_eval():
    x = torch.ones(64, 64)
    g = lambda s: torch.Generator().manual_seed(s)
    a, b, c = dropout(x, 0.25, g(1), True), dropout(x, 0.25, g(1), True), dropout(x, 0.25, g(2), True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.unique().tolist() == pytest.approx([0.0, 1.0 / 0.75])
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.03
    assert dropout(x, 0.25, g(1), False) is x  # eval mode
    assert dropout(x, 0.0, g(1), True) is x  # rate 0
    assert dropout(x, 0.25, None, True) is x  # no generator, no dropout

    # through the modules: eval mode ignores the generator, training uses it
    cfg = tiny(tcfg)
    kw = {k: dict(v, dropout_rate=0.5) for k, v in TINY_KW.items()}
    model = AE(tcfg.AEConfig(
        speaker_encoder=tcfg.SpeakerEncoderConfig(**kw["speaker_encoder"]),
        content_encoder=tcfg.ContentEncoderConfig(**kw["content_encoder"]),
        decoder=tcfg.DecoderConfig(**kw["decoder"]),
    ))
    xb, eps = torch.from_numpy(batch(3)), torch.zeros(4, 8, 8)
    run = lambda seed: model(xb, eps=eps, generator=g(seed))[3]
    torch.manual_seed(0)
    state = torch.get_rng_state()
    model.train()
    with torch.no_grad():
        t1, t1b, t2 = run(1), run(1), run(2)
        model.eval()
        e1, e2 = run(1), run(2)
    assert torch.equal(t1, t1b) and not torch.equal(t1, t2)
    assert torch.equal(e1, e2) and not torch.equal(e1, t1)
    assert torch.equal(torch.get_rng_state(), state)  # the global generator is untouched


def test_uint16_wire_batch_gives_the_same_step():
    """A uint16 batch is the bf16 bit pattern, reinterpreted on arrival."""
    from adaptive_voice_conversion_tpu_torch.data.dataset import to_bf16_bits

    x = batch(6)
    wire = to_bf16_bits(x)
    out = []
    for xb in (torch.from_numpy(wire).view(torch.bfloat16), torch.from_numpy(wire)):
        _, _, t, model = both(compute_dtype="bfloat16")
        opt = make_optimizer(t.optimizer, model.parameters())
        m = make_train_step(t, model, opt)(xb, 0.5, eps=torch.zeros(4, 8, 8))
        out.append(([float(v) for v in m.values()], [p.detach().clone() for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
