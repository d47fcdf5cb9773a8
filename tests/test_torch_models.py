"""Port models (adaptive_voice_conversion_tpu_torch.models) against the JAX
package's modules on the same weights and seeded numpy inputs.

Weights cross through the reference state_dict format: the JAX parameter
tree goes through ``state_dict_from_jax_params`` and
``load_state_dict(strict=True)``. Small configs are those of
tests/test_models_parity.py (2e-4); the full examples/config.yaml model is
held to 1e-4 on the converted mel, the reference parity gate."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from adaptive_voice_conversion_tpu.core import config as jcfg
from adaptive_voice_conversion_tpu.models import (
    ae_inference,
    content_encoder_apply,
    decoder_apply,
    get_speaker_embedding,
    init_ae,
    speaker_encoder_apply,
)
from adaptive_voice_conversion_tpu.models.torch_export import params_to_torch_state_dict
from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.models.ae import AE, count_params
from adaptive_voice_conversion_tpu_torch.models.modules import Decoder, init_parameters
from adaptive_voice_conversion_tpu_torch.models.weights import (
    load_checkpoint,
    save_checkpoint,
    state_dict_from_jax_params,
)

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(42)

SMALL = dict(
    speaker_encoder=dict(
        c_in=16, c_h=8, c_out=8, kernel_size=5, bank_size=8, bank_scale=1, c_bank=4,
        n_conv_blocks=3, n_dense_blocks=2, subsample=(1, 2, 2), act="relu",
        dropout_rate=0.0,
    ),
    content_encoder=dict(
        c_in=16, c_h=8, c_out=8, kernel_size=5, bank_size=8, bank_scale=1, c_bank=4,
        n_conv_blocks=3, subsample=(1, 2, 2), act="relu", dropout_rate=0.0,
    ),
    decoder=dict(
        c_in=8, c_cond=8, c_h=8, c_out=16, kernel_size=5, n_conv_blocks=3,
        upsample=(2, 1, 2), act="relu", sn=False, dropout_rate=0.0,
    ),
)


def ae_configs(kw):
    """The same AEConfig in both packages."""
    def build(mod):
        return mod.AEConfig(
            speaker_encoder=mod.SpeakerEncoderConfig(**kw["speaker_encoder"]),
            content_encoder=mod.ContentEncoderConfig(**kw["content_encoder"]),
            decoder=mod.DecoderConfig(**kw["decoder"]),
        )
    return build(jcfg), build(tcfg)


def full_configs():
    path = str(REPO / "examples" / "config.yaml")
    return jcfg.load_config(path).model, tcfg.load_config(path).model


def jit_init(j_cfg, seed):
    """init_ae as one compiled program (eager init dispatches op by op)."""
    return jax.jit(lambda k: init_ae(k, j_cfg))(jax.random.PRNGKey(seed))


def port_model(params, j_cfg, t_cfg):
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = AE(t_cfg)
    model.load_state_dict(state_dict_from_jax_params(np_params, t_cfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def small():
    j_cfg, t_cfg = ae_configs(SMALL)
    params = jit_init(j_cfg, 0)
    return params, j_cfg, t_cfg, port_model(params, j_cfg, t_cfg)


def to_bct(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def test_config_loads_field_for_field():
    def port(cfg):
        # the port's vocoder sections, which the JAX schema lacks, read
        # Griffin-Lim and no vocoder training where the file has none
        d = dataclasses.asdict(cfg)
        assert d.pop("vocoder") == dataclasses.asdict(tcfg.VocoderConfig())
        assert d.pop("vocoder_train") is None
        return d

    j, t = (m.load_config(str(REPO / "examples" / "config.yaml")) for m in (jcfg, tcfg))
    assert port(t) == dataclasses.asdict(j)
    assert tcfg.config_from_dict({}) == tcfg.TrainConfig()
    raw = {"Decoder": {"upsample": [2, 2]}, "signal": {"n_iter": 7}, "opt_fused": "bucketed4"}
    assert port(tcfg.config_from_dict(raw)) == dataclasses.asdict(jcfg.config_from_dict(raw))
    with pytest.raises(ValueError):
        tcfg.config_from_dict({"chunk_repeats": 0})


def test_state_dict_matches_jax_exporter(small):
    """The port's copy of the exporter mapping equals JAX
    params_to_torch_state_dict key for key and value for value, and the
    port's module tree has exactly those keys and shapes."""
    params, j_cfg, t_cfg, model = small
    ref = params_to_torch_state_dict(params, j_cfg)
    ours = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), t_cfg)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in ref.items()
    }


@pytest.mark.parametrize("t", [32, 33])  # 33: odd length exercises ceil paths
def test_speaker_encoder_matches_jax(small, t):
    params, j_cfg, _, model = small
    x = RNG.standard_normal((2, t, 16)).astype(np.float32)
    ref = speaker_encoder_apply(params["speaker_encoder"], j_cfg.speaker_encoder, jnp.asarray(x))
    with torch.no_grad():
        ours = model.speaker_encoder(to_bct(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("t", [32, 33])
def test_content_encoder_matches_jax(small, t):
    params, j_cfg, _, model = small
    x = RNG.standard_normal((2, t, 16)).astype(np.float32)
    mu, ls = content_encoder_apply(params["content_encoder"], j_cfg.content_encoder, jnp.asarray(x))
    with torch.no_grad():
        tmu, tls = model.content_encoder(to_bct(x))
    np.testing.assert_allclose(tmu.numpy().transpose(0, 2, 1), np.asarray(mu), atol=2e-4)
    np.testing.assert_allclose(tls.numpy().transpose(0, 2, 1), np.asarray(ls), atol=2e-4)


def test_decoder_matches_jax(small):
    params, j_cfg, _, model = small
    z = RNG.standard_normal((2, 8, 8)).astype(np.float32)
    cond = RNG.standard_normal((2, 8)).astype(np.float32)
    ref = decoder_apply(params["decoder"], j_cfg.decoder, jnp.asarray(z), jnp.asarray(cond))
    with torch.no_grad():
        ours = model.decoder(to_bct(z), torch.from_numpy(cond))
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 1), np.asarray(ref), atol=2e-4)


def test_small_ae_inference_and_embedding_match_jax(small):
    params, j_cfg, _, model = small
    x = RNG.standard_normal((2, 24, 16)).astype(np.float32)
    xc = RNG.standard_normal((2, 19, 16)).astype(np.float32)
    with torch.no_grad():
        dec = model.inference(torch.from_numpy(x), torch.from_numpy(xc))
        emb = model.get_speaker_embedding(torch.from_numpy(xc))
    np.testing.assert_allclose(
        dec.numpy(), np.asarray(ae_inference(params, j_cfg, jnp.asarray(x), jnp.asarray(xc))),
        atol=2e-4,
    )
    np.testing.assert_allclose(
        emb.numpy(), np.asarray(get_speaker_embedding(params, j_cfg, jnp.asarray(xc))),
        atol=2e-4,
    )


def test_full_config_inference_matches_jax(tmp_path):
    """The full examples/config.yaml model: 9,040,512 parameters, strict
    load of a reference-format .ckpt exported from JAX parameters, and the
    converted mel against JAX ae_inference to 1e-4 at T=64."""
    j_cfg, t_cfg = full_configs()
    params = jit_init(j_cfg, 3)
    sd = params_to_torch_state_dict(params, j_cfg)
    ckpt = tmp_path / "model.ckpt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    model = load_checkpoint(str(ckpt), t_cfg, device="cpu")
    assert count_params(model) == 9_040_512
    x = RNG.standard_normal((1, 64, 512)).astype(np.float32)
    xc = RNG.standard_normal((1, 64, 512)).astype(np.float32)
    ref = np.asarray(ae_inference(params, j_cfg, jnp.asarray(x), jnp.asarray(xc)))
    with torch.no_grad():
        ours = model.inference(torch.from_numpy(x), torch.from_numpy(xc)).numpy()
    assert ours.shape == ref.shape == (1, 64, 512)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_odd_length_gives_padded_output():
    """T=201 in -> T=208 out: the content code is ceil(201/8) = 26 frames,
    upsampled x8, as in the reference."""
    _, t_cfg = full_configs()
    model = AE(t_cfg).eval()
    x = torch.from_numpy(RNG.standard_normal((1, 201, 512)).astype(np.float32))
    with torch.no_grad():
        assert tuple(model.inference(x, x).shape) == (1, 208, 512)


def test_init_parameters_is_seeded_and_bounded(tmp_path):
    j_cfg, t_cfg = ae_configs(SMALL)
    a, b = AE(t_cfg), AE(t_cfg)
    init_parameters(a, torch.Generator().manual_seed(7))
    init_parameters(b, torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    w = a.decoder.in_conv_layer.weight.detach()
    assert float(w.abs().max()) <= 1.0 / np.sqrt(w[0].numel())
    save_checkpoint(a, str(tmp_path / "a.ckpt"))
    c = load_checkpoint(str(tmp_path / "a.ckpt"), t_cfg, device="cpu")
    torch.testing.assert_close(c.state_dict(), a.state_dict(), rtol=0, atol=0)


def test_spectral_norm_raises():
    """Decoder(sn=True) constructs (it raised before the training slice);
    what still raises is a strict load of sn=False weights into it, whose
    layers hold weight_orig / weight_u / weight_v instead of weight."""
    plain = Decoder(tcfg.DecoderConfig(sn=False))
    sn = Decoder(tcfg.DecoderConfig(sn=True))
    assert "in_conv_layer.weight_orig" in sn.state_dict()
    assert "in_conv_layer.weight_u" in sn.state_dict()
    assert "in_conv_layer.weight_v" in sn.state_dict()
    with pytest.raises(RuntimeError):
        sn.load_state_dict(plain.state_dict(), strict=True)
