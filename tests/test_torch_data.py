"""The port's host data path (adaptive_voice_conversion_tpu_torch.data)
against the JAX package's on the same artifacts: everything here is numpy on
both sides, so every comparison is exact."""

import json
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu.data import SegmentDataset as JSegmentDataset
from adaptive_voice_conversion_tpu.data import batch_iterator as j_batch_iterator
from adaptive_voice_conversion_tpu.data import make_frames as j_make_frames
from adaptive_voice_conversion_tpu.data.loader import as_wire_format
from adaptive_voice_conversion_tpu_torch.data.dataset import (
    SegmentDataset,
    from_bf16_bits,
    make_frames,
    to_bf16_bits,
)
from adaptive_voice_conversion_tpu_torch.data.loader import batch_iterator, device_prefetch

SEG = 16


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    data = {
        f"utt{i}": rng.standard_normal((40 + 13 * i, 8)).astype(np.float32) for i in range(5)
    }
    index = []
    for u, arr in data.items():
        for _ in range(20):
            index.append([u, int(rng.integers(0, len(arr) - SEG))])
    pkl, idx = d / "train.pkl", d / "train_samples.json"
    with open(pkl, "wb") as f:
        pickle.dump(data, f)
    with open(idx, "w") as f:
        json.dump(index, f)
    return str(pkl), str(idx), data, index


def pair(artifacts, dtype="float32"):
    pkl, idx, *_ = artifacts
    return (
        JSegmentDataset(pkl, idx, segment_size=SEG, storage_dtype=dtype),
        SegmentDataset(pkl, idx, segment_size=SEG, storage_dtype=dtype),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_and_get_utterance_match_jax(artifacts, dtype):
    _, _, data, index = artifacts
    ref, ours = pair(artifacts, dtype)
    assert len(ours) == len(ref) == len(index)
    assert ours.utt_ids == ref.utt_ids and ours.n_mels == ref.n_mels
    np.testing.assert_array_equal(ours.starts, ref.starts)
    sel = np.array([0, 7, 99, 42])
    got, want = ours.gather(sel), as_wire_format(ref.gather(sel))
    assert got.dtype == want.dtype and got.shape == (4, SEG, 8)
    np.testing.assert_array_equal(got, want)
    if dtype == "float32":
        for out, pos in zip(got, sel):
            u, t = index[pos]
            np.testing.assert_array_equal(out, data[u][t : t + SEG])
    for u in data:
        a, b = ours.get_utterance(u), ref.get_utterance(u)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_bf16_bits_match_ml_dtypes():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 4000),
        # ties to even in both directions, signed zeros, infinities, denormals, the largest finite
        np.array([1.00390625, 1.01171875, -1.00390625, 0.0, -0.0, np.inf, -np.inf,
                  1e-40, -1e-45, 3.4028235e38, 3.3895314e38], np.float32),
    ])
    want = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(to_bf16_bits(x), want.view(np.uint16))
    np.testing.assert_array_equal(from_bf16_bits(to_bf16_bits(x)), want.astype(np.float32))
    nan = to_bf16_bits(np.array([np.nan, -np.nan], np.float32))
    assert np.isnan(from_bf16_bits(nan)).all()
    # torch reads the pattern as the same numbers
    t = torch.from_numpy(to_bf16_bits(x)).view(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(t, want.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_iterator_bit_equal_to_jax_for_three_epochs(artifacts, dtype):
    ref, ours = pair(artifacts, dtype)
    bs = 8
    n = 3 * (len(ours) // bs) + 2
    it_r = j_batch_iterator(ref, bs, seed=3)
    it_o = batch_iterator(ours, bs, seed=3)
    seen = []
    for _ in range(n):
        a, b = next(it_o), as_wire_format(next(it_r))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        seen.append(a)
    per_epoch = len(ours) // bs
    assert not all(np.array_equal(a, b) for a, b in zip(seen[:per_epoch], seen[per_epoch:]))
    # resume from a step inside the second epoch
    resumed = batch_iterator(ours, bs, seed=3, start_step=per_epoch + 3)
    np.testing.assert_array_equal(next(resumed), seen[per_epoch + 3])
    np.testing.assert_array_equal(next(resumed), seen[per_epoch + 4])
    # unshuffled, and host slices: disjoint, covering, equal to JAX's
    full = next(batch_iterator(ours, bs, seed=1))
    parts = [next(batch_iterator(ours, bs, seed=1, host_index=h, host_count=4)) for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    for h in range(4):
        want = next(j_batch_iterator(ref, bs, seed=1, host_index=h, host_count=4))
        np.testing.assert_array_equal(parts[h], as_wire_format(want))
    a = next(batch_iterator(ours, bs, shuffle=False))
    np.testing.assert_array_equal(a, as_wire_format(next(j_batch_iterator(ref, bs, shuffle=False))))
    with pytest.raises(ValueError):
        next(batch_iterator(ours, 6, host_count=4))
    with pytest.raises(ValueError):
        next(batch_iterator(ours, 1000))


def test_make_frames_at_frame_size_2(artifacts):
    ref, ours = pair(artifacts)
    b = ours.gather(np.arange(4))
    got = make_frames(b, 2)
    assert got.shape == (4, SEG // 2, 16)
    np.testing.assert_array_equal(got, j_make_frames(ref.gather(np.arange(4)), 2))
    assert make_frames(b, 1) is b
    a = next(batch_iterator(ours, 8, frame_size=2, seed=5))
    np.testing.assert_array_equal(a, next(j_batch_iterator(ref, 8, frame_size=2, seed=5)))


def test_device_prefetch_on_cpu_keeps_order_and_surfaces_errors(artifacts):
    _, ours = pair(artifacts)
    direct = batch_iterator(ours, 8, seed=2)
    fetched = device_prefetch(batch_iterator(ours, 8, seed=2), torch.device("cpu"))
    for _ in range(5):
        x = next(fetched)
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), next(direct))
    fetched.close()

    def broken():
        yield np.zeros((2, 2), np.float32)
        raise RuntimeError("gather failed")

    it = device_prefetch(broken(), torch.device("cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="gather failed"):
        next(it)
