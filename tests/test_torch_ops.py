"""Port ops (adaptive_voice_conversion_tpu_torch.ops) against the JAX
package's ops on the same seeded numpy inputs, at the tolerances of
tests/test_ops.py. The port works on (B, C, T) with torch weight layouts;
the JAX package on (B, T, C) with (K, I, O) conv weights: layouts are
converted at the test boundary."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptive_voice_conversion_tpu import ops as jops
from adaptive_voice_conversion_tpu.ops.padding import conv_pad_amounts as j_pad_amounts
from adaptive_voice_conversion_tpu_torch.ops import conv, norm, padding, resample

RNG = np.random.default_rng(0)


def to_t(x_btc: np.ndarray) -> torch.Tensor:
    """JAX layout (B, T, C) -> port layout (B, C, T)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_btc).transpose(0, 2, 1)))


def from_t(x_bct: torch.Tensor) -> np.ndarray:
    return x_bct.detach().numpy().transpose(0, 2, 1)


def conv_w_t(w_kio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_kio.transpose(2, 1, 0)))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8])
def test_conv_pad_amounts_match_jax(k):
    assert padding.conv_pad_amounts(k) == j_pad_amounts(k)


@pytest.mark.parametrize("left,right", [(4, 3), (3, 3), (1, 0), (0, 0)])
def test_reflect_pad_matches_jax(left, right):
    """(4, 3) is the even-kernel (k=8) asymmetric pad."""
    x = RNG.standard_normal((2, 16, 4)).astype(np.float32)
    ours = padding.reflect_pad_time(to_t(x), left, right)
    ref = jops.reflect_pad_time(jnp.asarray(x), left, right)
    np.testing.assert_allclose(from_t(ours), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("k,stride", [(1, 1), (2, 1), (5, 1), (5, 2), (8, 1), (4, 2)])
def test_conv1d_matches_jax(k, stride):
    b, t, ci, co = 2, 24, 6, 5
    x = RNG.standard_normal((b, t, ci)).astype(np.float32)
    w = RNG.standard_normal((k, ci, co)).astype(np.float32) * 0.1
    bias = RNG.standard_normal((co,)).astype(np.float32)
    ours = conv.conv1d(to_t(x), conv_w_t(w), torch.from_numpy(bias), stride=stride)
    ref = jops.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), stride=stride)
    np.testing.assert_allclose(from_t(ours), np.asarray(ref), atol=1e-4)


def test_dense_matches_jax():
    x = RNG.standard_normal((3, 7)).astype(np.float32)
    w = RNG.standard_normal((7, 5)).astype(np.float32)
    bias = RNG.standard_normal((5,)).astype(np.float32)
    ours = conv.dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(bias))
    ref = jops.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_instance_norm_matches_jax():
    x = RNG.standard_normal((3, 17, 8)).astype(np.float32) * 3 + 1
    ours = norm.instance_norm_time(to_t(x))
    ref = jops.instance_norm_time(jnp.asarray(x))
    np.testing.assert_allclose(from_t(ours), np.asarray(ref), atol=1e-5)


def test_adain_matches_jax():
    b, t, c = 2, 9, 4
    x = RNG.standard_normal((b, t, c)).astype(np.float32)
    cond = RNG.standard_normal((b, 2 * c)).astype(np.float32)
    ours = norm.adain(to_t(x), torch.from_numpy(cond))
    ref = jops.adain(jnp.asarray(x), jnp.asarray(cond))
    np.testing.assert_allclose(from_t(ours), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("name", ["relu", "lrelu"])
def test_act_fn_matches_jax(name):
    x = RNG.standard_normal((4, 6)).astype(np.float32)
    ours = norm.act_fn(name)(torch.from_numpy(x))
    ref = jops.act_fn(name)(jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-7)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_pixel_shuffle_matches_jax(scale):
    b, t, c = 2, 7, 4
    x = RNG.standard_normal((b, t, c * scale)).astype(np.float32)
    ours = resample.pixel_shuffle_time(to_t(x), scale)
    ref = jops.pixel_shuffle_time(jnp.asarray(x), scale)
    np.testing.assert_allclose(from_t(ours), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("t,k", [(128, 2), (7, 2), (5, 2), (9, 4), (16, 2), (6, 1)])
def test_avg_pool_ceil_matches_jax(t, k):
    """A trailing partial window divides by its true count."""
    x = RNG.standard_normal((2, t, 3)).astype(np.float32)
    ours = resample.avg_pool_time_ceil(to_t(x), k)
    ref = jops.avg_pool_time_ceil(jnp.asarray(x), k)
    np.testing.assert_allclose(from_t(ours), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_upsample_nearest_matches_jax(scale):
    x = RNG.standard_normal((2, 6, 3)).astype(np.float32)
    ours = resample.upsample_nearest_time(to_t(x), scale)
    ref = jops.upsample_nearest_time(jnp.asarray(x), scale)
    np.testing.assert_allclose(from_t(ours), np.asarray(ref), atol=1e-6)


def test_global_avg_pool_matches_jax():
    x = RNG.standard_normal((2, 13, 5)).astype(np.float32)
    ours = resample.global_avg_pool_time(to_t(x))
    ref = jops.global_avg_pool_time(jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def _bank_inputs(kernel_sizes, b=2, t=32, ci=8, cb=4):
    x = RNG.standard_normal((b, t, ci)).astype(np.float32)
    ws = [RNG.standard_normal((k, ci, cb)).astype(np.float32) * 0.2 for k in kernel_sizes]
    bs = [RNG.standard_normal((cb,)).astype(np.float32) for _ in kernel_sizes]
    return x, ws, bs


def test_make_fused_bank_weight_matches_jax():
    """The exact tap-offset embed, in torch layout."""
    ks = [1, 2, 3, 4]
    _, ws, _ = _bank_inputs(ks)
    ours = conv.make_fused_bank_weight([conv_w_t(w) for w in ws], ks)
    ref = np.asarray(jops.make_fused_bank_weight([jnp.asarray(w) for w in ws], ks))
    np.testing.assert_array_equal(ours.numpy(), ref.transpose(2, 1, 0))


@pytest.mark.parametrize(
    "kernel_sizes,group_size",
    [(list(range(1, 9)), 2), (list(range(1, 9)), 1), (list(range(1, 9)), 4),
     (list(range(1, 9)), 8), ([2, 4, 6, 8], 2), ([1, 2, 3], 2)],
)
def test_conv_bank_matches_jax(kernel_sizes, group_size):
    """Pair grouping (the default) and other groupings against the JAX
    bank at its default pair grouping; kernels with odd and even sizes."""
    x, ws, bs = _bank_inputs(kernel_sizes)
    relu = norm.act_fn("relu")
    ours = conv.conv_bank(
        to_t(x), [conv_w_t(w) for w in ws], [torch.from_numpy(v) for v in bs],
        kernel_sizes, relu, group_size=group_size,
    )
    ref = jops.conv_bank(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(v) for v in bs],
        kernel_sizes, jops.act_fn("relu"),
    )
    np.testing.assert_allclose(from_t(ours), np.asarray(ref), atol=1e-4)
