"""The port's length-masked ops, model passes, STFT/ISTFT and ragged
Griffin-Lim against the JAX package's, on the same seeded numpy inputs.

The port's activations are (B, C, T), the JAX package's (B, T, C); the
tests transpose at the boundary. Tolerances are those of
tests/test_masked.py: 2e-6 for the convolution and pooling ops, 1e-5 for
instance norm, the model and the exact Griffin-Lim; the gather-based
reflect pad is exact. The fused mode runs the kernel's plain version here
and the Pallas kernel in interpret mode on the JAX side; the two differ in
f32 summation order, so they are compared by spectral convergence (SC).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from adaptive_voice_conversion_tpu.core import config as jcfg
from adaptive_voice_conversion_tpu.dsp import stft as jstft
from adaptive_voice_conversion_tpu.dsp.vocoder import griffin_lim_jax_masked
from adaptive_voice_conversion_tpu.models import masked as JMM
from adaptive_voice_conversion_tpu.models.ae import init_ae
from adaptive_voice_conversion_tpu.ops import masked as jops
from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.dsp import stft as tstft
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import griffin_lim, griffin_lim_masked
from adaptive_voice_conversion_tpu_torch.models import masked as TMM
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.weights import state_dict_from_jax_params
from adaptive_voice_conversion_tpu_torch.ops import masked as tops
from adaptive_voice_conversion_tpu_torch.ops.conv import conv_bank
from adaptive_voice_conversion_tpu_torch.ops.norm import act_fn

N_MELS = 8
# the TINY model of tests/test_e2e.py
TINY = dict(
    speaker_encoder=dict(
        c_in=N_MELS, c_h=8, c_out=8, kernel_size=5, bank_size=4, bank_scale=1,
        c_bank=4, n_conv_blocks=2, n_dense_blocks=1, subsample=(1, 2),
    ),
    content_encoder=dict(
        c_in=N_MELS, c_h=8, c_out=8, kernel_size=5, bank_size=4, bank_scale=1,
        c_bank=4, n_conv_blocks=2, subsample=(1, 2),
    ),
    decoder=dict(
        c_in=8, c_cond=8, c_h=8, c_out=N_MELS, kernel_size=5, n_conv_blocks=2,
        upsample=(2, 1),
    ),
)
# the small signal geometry of tests/test_masked.py
SIGNAL = dict(sr=8000, n_fft=256, hop_length=64, win_length=192, n_mels=8, n_iter=2)


def tiny_model_configs():
    def build(mod):
        return mod.AEConfig(
            speaker_encoder=mod.SpeakerEncoderConfig(**TINY["speaker_encoder"]),
            content_encoder=mod.ContentEncoderConfig(**TINY["content_encoder"]),
            decoder=mod.DecoderConfig(**TINY["decoder"]),
        )
    return build(jcfg), build(tcfg)


def ragged(rng, lens, t, c):
    """Samples (L_i, c), their zero-padded (B, t, c) stack, and the lengths."""
    xs = [rng.standard_normal((L, c)).astype(np.float32) for L in lens]
    xb = np.stack([np.pad(x, ((0, t - x.shape[0]), (0, 0))) for x in xs])
    return xs, xb, np.array(lens, np.int32)


def bct(x):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))


def btc(x: torch.Tensor):
    return x.transpose(1, 2).numpy()


def tlen(lens):
    return torch.from_numpy(np.asarray(lens, np.int64))


def test_mask_and_lengths_match_jax():
    lens = np.array([3, 7, 5], np.int32)
    np.testing.assert_array_equal(
        tops.valid_mask(tlen(lens), 7).numpy(), np.asarray(jops.valid_mask(jnp.asarray(lens), 7))
    )
    for stride in (1, 2, 3):
        np.testing.assert_array_equal(
            tops.ceil_lengths(tlen(lens), stride).numpy(),
            np.asarray(jops.ceil_lengths(jnp.asarray(lens), stride)),
        )


@pytest.mark.parametrize("lens", [[11, 17, 8], [17, 2, 1]])  # the second: shorter than the pad
def test_reflect_pad_masked_matches_jax(lens):
    """A gather: exact, the ultra-short samples' folded indices included."""
    rng = np.random.default_rng(0)
    _, xb, ls = ragged(rng, lens, 17, 3)
    ref = np.asarray(jops.reflect_pad_time_masked(jnp.asarray(xb), jnp.asarray(ls), 4, 3))
    out = btc(tops.reflect_pad_time_masked(bct(xb), tlen(ls), 4, 3))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("k,stride", [(5, 1), (5, 2), (8, 1), (4, 2), (1, 1)])
def test_conv1d_masked_matches_jax(k, stride):
    rng = np.random.default_rng(1)
    lens = [19, 32, 25]
    _, xb, ls = ragged(rng, lens, 32, 6)
    w = rng.standard_normal((k, 6, 4)).astype(np.float32)  # JAX layout (K, I, O)
    b = rng.standard_normal(4).astype(np.float32)
    ref, ref_lens = jops.conv1d_masked(
        jnp.asarray(xb), jnp.asarray(ls), jnp.asarray(w), jnp.asarray(b), stride=stride
    )
    out, out_lens = tops.conv1d_masked(
        bct(xb), tlen(ls), torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))),
        torch.from_numpy(b), stride=stride,
    )
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    ref = np.asarray(ref)
    for i, L in enumerate(np.asarray(ref_lens)):
        np.testing.assert_allclose(btc(out)[i, :L], ref[i, :L], atol=2e-6)


def test_conv_bank_masked_matches_jax_and_per_sample():
    """30-tap sums of unit-variance products reach |y| ~ 15, where 2e-6 is
    two ulp: the relative term allows the f32 summation order its few ulp."""
    rng = np.random.default_rng(11)
    lens, ks = [19, 32, 25], [1, 2, 3, 4, 5]
    xs, xb, ls = ragged(rng, lens, 32, 6)
    ws = [rng.standard_normal((k, 6, 4)).astype(np.float32) for k in ks]
    bs = [rng.standard_normal(4).astype(np.float32) for _ in ks]
    ref = np.asarray(jops.conv_bank_masked(
        jnp.asarray(xb), jnp.asarray(ls), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs], ks, jax.nn.relu,
    ))
    tws = [torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))) for w in ws]
    tbs = [torch.from_numpy(b) for b in bs]
    out = btc(tops.conv_bank_masked(bct(xb), tlen(ls), tws, tbs, ks, act_fn("relu")))
    assert out.shape == ref.shape
    for i, L in enumerate(lens):
        np.testing.assert_allclose(out[i, :L], ref[i, :L], atol=2e-6, rtol=1e-6)
        solo = btc(conv_bank(bct(xs[i][None]), tws, tbs, ks, act_fn("relu")))[0]
        np.testing.assert_allclose(out[i, :L], solo, atol=2e-6, rtol=1e-6)


def test_instance_norm_masked_matches_jax():
    rng = np.random.default_rng(2)
    lens = [10, 23, 16]
    _, xb, ls = ragged(rng, lens, 23, 5)
    ref = np.asarray(jops.instance_norm_time_masked(jnp.asarray(xb), jnp.asarray(ls)))
    out = btc(tops.instance_norm_time_masked(bct(xb), tlen(ls)))
    for i, L in enumerate(lens):
        np.testing.assert_allclose(out[i, :L], ref[i, :L], atol=1e-5)


@pytest.mark.parametrize("kernel", [2, 3])
def test_avg_pool_masked_matches_jax(kernel):
    rng = np.random.default_rng(3)
    lens = [9, 16, 13]
    _, xb, ls = ragged(rng, lens, 16, 4)
    ref, ref_lens = jops.avg_pool_time_ceil_masked(jnp.asarray(xb), jnp.asarray(ls), kernel)
    out, out_lens = tops.avg_pool_time_ceil_masked(bct(xb), tlen(ls), kernel)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    ref = np.asarray(ref)
    for i, L in enumerate(np.asarray(ref_lens)):
        np.testing.assert_allclose(btc(out)[i, :L], ref[i, :L], atol=2e-6)


def test_global_avg_pool_masked_matches_jax():
    rng = np.random.default_rng(14)
    _, xb, ls = ragged(rng, [9, 16, 13], 16, 4)
    ref = np.asarray(jops.global_avg_pool_time_masked(jnp.asarray(xb), jnp.asarray(ls)))
    out = tops.global_avg_pool_time_masked(bct(xb), tlen(ls)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.fixture(scope="module")
def tiny():
    j_cfg, t_cfg = tiny_model_configs()
    params = jax.jit(lambda k: init_ae(k, j_cfg))(jax.random.PRNGKey(0))
    model = AE(t_cfg)
    model.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), t_cfg),
        strict=True,
    )
    return params, j_cfg, model.eval()


def port_masked(model, src_b, sl, tar_b, tl):
    with torch.no_grad():
        dec, lens = TMM.ae_inference_masked(
            model, torch.from_numpy(src_b), tlen(sl), torch.from_numpy(tar_b), tlen(tl)
        )
    return dec.numpy(), lens.numpy()


def test_masked_modules_match_jax(tiny):
    """Each masked module pass against its JAX counterpart, 1e-5."""
    params, j_cfg, model = tiny
    rng = np.random.default_rng(15)
    _, xb, ls = ragged(rng, [30, 41, 24], 42, N_MELS)
    jx, jl = jnp.asarray(xb), jnp.asarray(ls)
    with torch.no_grad():
        emb = TMM.speaker_encoder_apply_masked(model.speaker_encoder, bct(xb), tlen(ls))
        mu, log_sigma, c_lens = TMM.content_encoder_apply_masked(
            model.content_encoder, bct(xb), tlen(ls)
        )
        dec, d_lens = TMM.decoder_apply_masked(model.decoder, mu, emb, c_lens)
    j_emb = JMM.speaker_encoder_apply_masked(
        params["speaker_encoder"], j_cfg.speaker_encoder, jx, jl
    )
    j_mu, j_ls, j_cl = JMM.content_encoder_apply_masked(
        params["content_encoder"], j_cfg.content_encoder, jx, jl
    )
    j_dec, j_dl = JMM.decoder_apply_masked(params["decoder"], j_cfg.decoder, j_mu, j_emb, j_cl)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), atol=1e-5)
    np.testing.assert_array_equal(c_lens.numpy(), np.asarray(j_cl))
    np.testing.assert_array_equal(d_lens.numpy(), np.asarray(j_dl))
    for i, L in enumerate(np.asarray(j_cl)):
        np.testing.assert_allclose(btc(mu)[i, :L], np.asarray(j_mu)[i, :L], atol=1e-5)
        np.testing.assert_allclose(btc(log_sigma)[i, :L], np.asarray(j_ls)[i, :L], atol=1e-5)
    for i, L in enumerate(np.asarray(j_dl)):
        np.testing.assert_allclose(btc(dec)[i, :L], np.asarray(j_dec)[i, :L], atol=1e-5)


def test_ae_inference_masked_matches_jax_and_per_pair(tiny):
    """The mixed-length padded batch through the masked AE equals the JAX
    masked AE and the port's own per-pair ``AE.inference`` at true lengths,
    both to 1e-5 (the gate of tests/test_masked.py)."""
    params, j_cfg, model = tiny
    rng = np.random.default_rng(4)
    lens_s, lens_t = [30, 41, 24], [28, 19, 37]
    srcs, src_b, sl = ragged(rng, lens_s, 42, N_MELS)
    tars, tar_b, tl = ragged(rng, lens_t, 37, N_MELS)
    dec, out_lens = port_masked(model, src_b, sl, tar_b, tl)
    j_dec, j_lens = JMM.ae_inference_masked(
        params, j_cfg, jnp.asarray(src_b), jnp.asarray(sl), jnp.asarray(tar_b), jnp.asarray(tl)
    )
    np.testing.assert_array_equal(out_lens, np.asarray(j_lens))
    for i in range(3):
        with torch.no_grad():
            single = model.inference(
                torch.from_numpy(srcs[i][None]), torch.from_numpy(tars[i][None])
            )[0].numpy()
        assert out_lens[i] == single.shape[0] == -(-lens_s[i] // 2) * 2
        np.testing.assert_allclose(dec[i, : out_lens[i]], single, atol=1e-5)
        np.testing.assert_allclose(
            dec[i, : out_lens[i]], np.asarray(j_dec)[i, : out_lens[i]], atol=1e-5
        )


def test_masked_batch_with_ultra_short_sample(tiny):
    """A sample shorter than a layer's pad width has no single-sample
    behaviour to match (F.pad reflect raises there), but the batch must be
    finite, the other sample must equal its solo run (1e-5), and the whole
    output must equal the JAX package's, degenerate sample included."""
    params, j_cfg, model = tiny
    rng = np.random.default_rng(13)
    lens_s, lens_t = [40, 6], [30, 5]
    srcs, src_b, sl = ragged(rng, lens_s, 40, N_MELS)
    tars, tar_b, tl = ragged(rng, lens_t, 30, N_MELS)
    dec, out_lens = port_masked(model, src_b, sl, tar_b, tl)
    assert np.isfinite(dec).all()
    with torch.no_grad():
        single = model.inference(
            torch.from_numpy(srcs[0][None]), torch.from_numpy(tars[0][None])
        )[0].numpy()
    np.testing.assert_allclose(dec[0, : single.shape[0]], single, atol=1e-5)
    j_dec, _ = JMM.ae_inference_masked(
        params, j_cfg, jnp.asarray(src_b), jnp.asarray(sl), jnp.asarray(tar_b), jnp.asarray(tl)
    )
    for i in range(2):
        np.testing.assert_allclose(
            dec[i, : out_lens[i]], np.asarray(j_dec)[i, : out_lens[i]], atol=1e-5
        )
    dec2, _ = port_masked(model, src_b, sl, tar_b, tl)
    np.testing.assert_array_equal(dec[1], dec2[1])


# ---------------------------------------------------------------------------
# masked STFT / ISTFT / Griffin-Lim at the small signal geometry
# ---------------------------------------------------------------------------

J_SIG, T_SIG = jcfg.SignalConfig(**SIGNAL), tcfg.SignalConfig(**SIGNAL)
GEOM = (SIGNAL["n_fft"], SIGNAL["hop_length"], SIGNAL["win_length"])
# 63 and 62 lie within the mirror window of the longest sample: they pin the
# buffer extension of stft_masked
GL_LENS = [40, 64, 51, 63, 62]


def ragged_mags(rng, lens, t=64):
    f = SIGNAL["n_fft"] // 2 + 1
    mags = [np.abs(rng.standard_normal((f, L))).astype(np.float32) for L in lens]
    return mags, np.stack([np.pad(m, ((0, 0), (0, t - m.shape[1]))) for m in mags])


def test_istft_masked_and_envelope_match_jax():
    rng = np.random.default_rng(20)
    lens = np.array(GL_LENS, np.int32)
    _, mag_b = ragged_mags(rng, GL_LENS)
    spec = (mag_b * np.exp(1j * rng.uniform(-np.pi, np.pi, mag_b.shape))).astype(np.complex64)
    j_env = jstft.istft_env_inv_masked(jnp.asarray(lens), 64, *GEOM)
    t_env = tstft.istft_env_inv_masked(tlen(lens), 64, *GEOM)
    np.testing.assert_allclose(t_env.numpy(), np.asarray(j_env), rtol=1e-6)
    ref = np.asarray(jstft.istft_jax_masked(jnp.asarray(spec), j_env, *GEOM))
    out = tstft.istft_masked(torch.from_numpy(spec), t_env, *GEOM).numpy()
    assert out.shape == ref.shape == (5, 64 * 63)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())
    assert tstft.n_edge_frames(*GEOM[:2]) == jstft.n_edge_frames(*GEOM[:2]) == 2


@pytest.mark.parametrize("lens", [GL_LENS, [64, 3, 1, 2, 5]])  # the second: sub-5-frame samples
def test_stft_masked_matches_jax_and_per_sample(lens):
    """Valid frames equal the JAX masked STFT and, for samples of at least
    5 frames, the plain STFT of the sample's own signal (1e-5 of the peak)."""
    rng = np.random.default_rng(21)
    n = SIGNAL["hop_length"] * 63
    y = rng.standard_normal((len(lens), n)).astype(np.float32)
    ref = np.asarray(jstft.stft_jax_masked(jnp.asarray(y), jnp.asarray(lens, dtype=jnp.int32), *GEOM))
    out = tstft.stft_masked(torch.from_numpy(y), tlen(lens), *GEOM).numpy()
    assert out.shape == ref.shape == (len(lens), 129, 64)
    tol = 1e-5 * np.abs(ref).max()
    for i, L in enumerate(lens):
        np.testing.assert_allclose(out[i, :, :L], ref[i, :, :L], atol=tol)
        if L >= 5:
            solo = tstft.stft(torch.from_numpy(y[i, : SIGNAL["hop_length"] * (L - 1)]), *GEOM).numpy()
            np.testing.assert_allclose(out[i, :, :L], solo, atol=tol)


def test_griffin_lim_masked_exact_matches_per_sample_and_jax():
    """Ragged exact Griffin-Lim against the port's per-sample ``griffin_lim``
    at 30 iterations (1e-5, the JAX test's gate), and against the JAX masked
    loop at 3 iterations (1e-5 of the peak: two FFT libraries, before the
    iteration amplifies their last bits)."""
    rng = np.random.default_rng(6)
    mags, mag_b = ragged_mags(rng, GL_LENS)
    wav = griffin_lim_masked(torch.from_numpy(mag_b), GL_LENS, T_SIG, n_iter=30).numpy()
    for i, m in enumerate(mags):
        ref = griffin_lim(torch.from_numpy(m), T_SIG, n_iter=30).numpy()
        np.testing.assert_allclose(wav[i, : ref.shape[-1]], ref, atol=1e-5)
    few = griffin_lim_masked(torch.from_numpy(mag_b), GL_LENS, T_SIG, n_iter=3).numpy()
    j_few = np.asarray(griffin_lim_jax_masked(jnp.asarray(mag_b), jnp.asarray(GL_LENS), J_SIG, n_iter=3))
    for i, L in enumerate(GL_LENS):
        n = SIGNAL["hop_length"] * (L - 1)
        np.testing.assert_allclose(few[i, :n], j_few[i, :n], atol=1e-5 * np.abs(j_few).max())


def sc(wav, mag):
    est = np.abs(jstft.stft_np(np.asarray(wav), *GEOM))
    f = min(est.shape[1], mag.shape[1])
    return float(np.linalg.norm(est[:, :f] - mag[:, :f]) / np.linalg.norm(mag[:, :f]))


def test_griffin_lim_masked_fused_tracks_jax_and_exact():
    """The ragged fast mode on a consistent magnitude: finite, zero past each
    sample's end, per-sample SC within 0.01 of the JAX package's (Pallas in
    interpret mode) and below the exact masked path's + 0.05."""
    lens = [40, 64, 51]
    hop = SIGNAL["hop_length"]
    t = np.arange(64 * hop + SIGNAL["n_fft"]) / SIGNAL["sr"]
    sig = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    full = np.abs(jstft.stft_np(sig, *GEOM)).astype(np.float32)
    mags = [full[:, :L] * (1 + 0.01 * i) for i, L in enumerate(lens)]
    mag_b = np.stack([np.pad(m, ((0, 0), (0, 64 - m.shape[1]))) for m in mags])
    n_it = 20
    w_exact = griffin_lim_masked(torch.from_numpy(mag_b), lens, T_SIG, n_iter=n_it).numpy()
    w_fused = griffin_lim_masked(torch.from_numpy(mag_b), lens, T_SIG, n_iter=n_it, method="fused").numpy()
    w_jax = np.asarray(griffin_lim_jax_masked(
        jnp.asarray(mag_b), jnp.asarray(lens), J_SIG, n_iter=n_it, method="pallas"
    ))
    assert w_fused.shape == w_jax.shape and np.isfinite(w_fused).all()
    for i, L in enumerate(lens):
        n = hop * (L - 1)
        # past the last valid frame's window nothing is synthesised
        assert not w_fused[i, n + SIGNAL["n_fft"] // 2 :].any()
        s_f, s_j, s_e = (sc(w[i, :n], mags[i]) for w in (w_fused, w_jax, w_exact))
        assert abs(s_f - s_j) < 0.01, (i, s_f, s_j)
        assert s_f < s_e + 0.05, (i, s_f, s_e)
    # "pallas", the JAX package's name, is the same schedule; others raise
    w_alias = griffin_lim_masked(torch.from_numpy(mag_b), lens, T_SIG, n_iter=n_it, method="pallas")
    np.testing.assert_array_equal(w_alias.numpy(), w_fused)
    with pytest.raises(ValueError):
        griffin_lim_masked(torch.from_numpy(mag_b), lens, T_SIG, n_iter=2, method="fast")
