"""The port's training data modes against the JAX package's, on the CPU: the
native segment gather, the device-resident dataset and its sampling, the
chunk streamer's planning and schedule, and the multi-step trainer.

Tolerances: everything here is exact. The gathers copy bytes; the planning
is numpy on both sides; the multi-step is held bit for bit against the
port's host step fed the batches and draws it took (tests/test_torch_train.py
holds that step against the JAX chain), and the padded-start form against
the plain one.
"""

import copy
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu.data import native as j_native
from adaptive_voice_conversion_tpu.data.chunked import ChunkedDeviceStreamer as JChunked
from adaptive_voice_conversion_tpu.data.dataset import SegmentDataset as JSegmentDataset
from adaptive_voice_conversion_tpu.data.device_sampler import (
    DeviceResidentDataset as JDeviceResident,
    sample_segments as j_sample_segments,
)
from adaptive_voice_conversion_tpu_torch.data import native
from adaptive_voice_conversion_tpu_torch.data.chunked import ChunkedDeviceStreamer, next_chunk, stream_visits
from adaptive_voice_conversion_tpu_torch.data.dataset import SegmentDataset
from adaptive_voice_conversion_tpu_torch.data.device_sampler import (
    DeviceResidentDataset,
    draw_indices,
    gather_rows,
    sample_segments,
)
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.train.optim import kl_lambda, make_optimizer
from adaptive_voice_conversion_tpu_torch.train.step import (
    make_device_data_train_step,
    make_train_step,
    step_seed,
)
from adaptive_voice_conversion_tpu_torch.utils import profiling

from test_torch_solver import one_intra_op_thread, tiny  # noqa: F401

SEG = 16
N_MELS = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """24 utterances of 40-70 frames, 25 indexed segments each (the JAX
    package's tests/test_scaled_data.py fixture)."""
    d = tmp_path_factory.mktemp("modes")
    rng = np.random.default_rng(7)
    data, index = {}, []
    for i in range(24):
        n = 40 + 5 * (i % 7)
        data[f"utt{i}"] = rng.standard_normal((n, N_MELS)).astype(np.float32)
        for _ in range(25):
            index.append([f"utt{i}", int(rng.integers(0, n - SEG))])
    pkl, idx = d / "d.pkl", d / "d.json"
    with open(pkl, "wb") as f:
        pickle.dump(data, f)
    with open(idx, "w") as f:
        json.dump(index, f)
    return str(pkl), str(idx)


def pair(artifacts, storage="float32"):
    pkl, idx = artifacts
    return (
        JSegmentDataset(pkl, idx, segment_size=SEG, storage_dtype=storage),
        SegmentDataset(pkl, idx, segment_size=SEG, storage_dtype=storage),
    )


def u16(x) -> np.ndarray:
    """The bits of a bf16 array, torch or numpy (ml_dtypes), as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


# -- the native gather ---------------------------------------------------------


@pytest.mark.parametrize("n", [5, 64], ids=["one-thread", "threaded"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_native_gather_bit_equal_to_numpy_and_jax(artifacts, storage, n):
    """n=5 < 4 x n_threads takes the C source's single-thread loop, n=64 its
    threads (native/segment_gather.cpp:30)."""
    jds, ds = pair(artifacts, storage)
    sel = np.random.default_rng(n).integers(0, len(ds), n)
    got = native.gather_segments(ds.packed, ds.starts[sel], SEG, n_threads=2)
    plain = ds.gather_plain(sel)
    want = j_native.gather_segments(jds.packed, jds.starts[sel], SEG, n_threads=2)
    assert want is not None, "the JAX package's native gather did not build"
    assert got.dtype == plain.dtype == ds.packed.dtype and got.shape == (n, SEG, N_MELS)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got.view(np.uint8), np.asarray(want).view(np.uint8))
    np.testing.assert_array_equal(ds.gather(sel), plain)


def test_native_gather_builds_under_build_native_and_checks_its_input(tmp_path, monkeypatch):
    path = native.library_path()
    assert path.parent == native.REPO / "build" / "native"
    assert path.name.startswith("libsegment_gather-") and path.suffix == ".so"
    native.load_library()
    assert path.exists()
    packed = np.arange(40, dtype=np.float32).reshape(10, 4)
    with pytest.raises(IndexError):
        native.gather_segments(packed, np.array([7]), 4)
    with pytest.raises(ValueError):
        native.gather_segments(packed[:, :2], np.array([0]), 2)
    # an edited source is another file name: rebuilt, never a stale library
    src = tmp_path / "segment_gather.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != path


def test_native_gather_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises with the
    compiler's output, and nothing is left under the build directory."""
    src = tmp_path / "segment_gather.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        native.build()
    assert list((tmp_path / "build").iterdir()) == []


# -- the device-resident dataset and its sampling ------------------------------


@pytest.mark.parametrize(
    "storage,dtype", [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")]
)
def test_device_resident_bits_equal_jax(artifacts, storage, dtype):
    jds, ds = pair(artifacts, storage)
    ref = JDeviceResident(jds, dtype=dtype)
    ours = DeviceResidentDataset(ds, CPU, dtype=dtype)
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert ours.packed.dtype == want_dtype and ours.nbytes == ref.nbytes
    if dtype == "bfloat16":
        np.testing.assert_array_equal(u16(ours.packed), u16(ref.packed))
    else:
        np.testing.assert_array_equal(ours.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(ours.starts.numpy(), np.asarray(ref.starts))
    assert (ours.segment_size, ours.n_mels) == (ref.segment_size, ref.n_mels)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_valid", [None, 301])
def test_gather_rows_equals_jax_sample_segments(artifacts, storage, n_valid):
    """For the positions jax.random.randint draws, gather_rows gives JAX's
    sample_segments batch exactly, and the host gather's."""
    jds, ds = pair(artifacts, storage)
    ref = JDeviceResident(jds, dtype=storage)
    ours = DeviceResidentDataset(ds, CPU, dtype=storage)
    n = len(ds)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = j_sample_segments(
            ref.packed, ref.starts, SEG, 16, key,
            n_valid=None if n_valid is None else jnp.int32(n_valid),
        )
        sel = np.asarray(jax.random.randint(key, (16,), 0, n if n_valid is None else n_valid))
        got = gather_rows(ours.packed, ours.starts, torch.tensor(sel, dtype=torch.int64), SEG)
        assert got.shape == (16, SEG, N_MELS)
        if storage == "bfloat16":
            np.testing.assert_array_equal(u16(got), u16(want))
            np.testing.assert_array_equal(u16(got), ds.gather(sel))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(got.numpy(), ds.gather(sel))


def test_draw_indices_bounded_uniform_and_seeded():
    gen = torch.Generator().manual_seed(5)
    sel = draw_indices(100, 10_000, gen, n_valid=torch.tensor(37))
    assert sel.dtype == torch.int64 and int(sel.min()) >= 0 and int(sel.max()) < 37
    counts = np.bincount(sel.numpy(), minlength=37)
    # every position drawn, each within 5 standard deviations of 10000/37
    expect = 10_000 / 37
    assert counts.min() > 0 and np.abs(counts - expect).max() < 5 * np.sqrt(expect)
    full = draw_indices(100, 10_000, torch.Generator().manual_seed(5))
    assert int(full.max()) >= 37 and int(full.max()) < 100
    again = draw_indices(100, 10_000, torch.Generator().manual_seed(5))
    torch.testing.assert_close(full, again, rtol=0, atol=0)
    # sample_segments is the draw, then the gather
    ds_packed = torch.arange(200 * 2, dtype=torch.float32).view(200, 2)
    starts = torch.tensor([0, 50, 120, 180])
    x = sample_segments(ds_packed, starts, 4, 6, torch.Generator().manual_seed(1))
    s = draw_indices(4, 6, torch.Generator().manual_seed(1))
    torch.testing.assert_close(x, gather_rows(ds_packed, starts, s, 4), rtol=0, atol=0)


# -- the chunk streamer's planning ---------------------------------------------


def chunk_pair(artifacts, storage, chunk_rows, inner_steps, repeats, seed=3):
    jds, ds = pair(artifacts, storage)
    chunk_bytes = chunk_rows * N_MELS * ds.packed.dtype.itemsize
    kw = dict(batch_size=4, inner_steps=inner_steps, seed=seed, repeats=repeats)
    return JChunked(jds, chunk_bytes, **kw), ChunkedDeviceStreamer(ds, chunk_bytes, **kw), ds


@pytest.mark.parametrize("repeats", [1, 3])
@pytest.mark.parametrize("inner_steps", [1, 2, 5])
@pytest.mark.parametrize(
    "storage,chunk_rows", [("float32", 40), ("float32", 150), ("bfloat16", 97), ("float32", 10**6)]
)
def test_chunk_planning_equals_jax(artifacts, storage, chunk_rows, inner_steps, repeats):
    ref, ours, ds = chunk_pair(artifacts, storage, chunk_rows, inner_steps, repeats)
    for name in ("R", "n_chunks", "dropped_segments", "total_segments", "epoch_steps",
                 "repeats", "segment_size", "batch_size", "inner_steps", "seed"):
        assert getattr(ours, name) == getattr(ref, name), name
    np.testing.assert_array_equal(ours.starts_padded, ref.starts_padded)
    assert ours.starts_padded.dtype == ref.starts_padded.dtype
    np.testing.assert_array_equal(ours.n_starts, ref.n_starts)
    assert (ours._tail is None) == (ref._tail is None)
    assert ours.dropped_segments + ours.total_segments == len(ds)
    assert ours.chunk_nbytes() == ref.chunk_nbytes()
    for c in range(ours.n_chunks):
        np.testing.assert_array_equal(
            ours.chunk_view(c).view(np.uint8), np.asarray(ref.chunk_view(c)).view(np.uint8)
        )
        chunk = ours.put_chunk(c)
        assert ours.last_h2d_rows == ours.R
        assert chunk.ready is None and chunk.acquire() is chunk
        np.testing.assert_array_equal(chunk.packed.view(torch.uint8).numpy(),
                                      ours.chunk_view(c).view(np.uint8))
        np.testing.assert_array_equal(chunk.starts.numpy(), ours.starts_padded[c])
        assert int(chunk.n_starts) == ours.n_starts[c]
    for t_step in (1e-4, 1e-3, 3e-2, 0.5):
        assert ours.required_bandwidth(t_step) == ref.required_bandwidth(t_step)
        assert ours.required_bandwidth(t_step, 4) == ref.required_bandwidth(t_step, 4)
        for bw in (1e3, 1e5, 1e6, 1e7, 1e9):
            for margin, max_r in ((2.0, 16), (1.0, 4)):
                assert ours.choose_repeats(t_step, bw, margin, max_r) == \
                    ref.choose_repeats(t_step, bw, margin, max_r)
    for epoch in range(3):
        assert ours._epoch_visits(epoch) == ref._epoch_visits(epoch)
    epoch_len = sum(k for _, k in ours._epoch_visits(0))
    first = ours._epoch_visits(0)[0][1]
    # from the start, inside the first visit, at a visit boundary, across
    # the first epoch's end and inside the third epoch
    for start in (0, 1, first - 1, first, first + 1, epoch_len - 1, epoch_len + 3,
                  2 * epoch_len + first // 2):
        for n in (1, 7, 2 * epoch_len + 5):
            got = [(v.chunk_id, v.it0, v.k) for v in ours.schedule(start, n)]
            want = [(v.chunk_id, v.it0, v.k) for v in ref.schedule(start, n)]
            assert got == want, (start, n)
            assert sum(k for _, _, k in got) == n and got[0][1] == start


def test_chunk_set_repeats_and_mesh_raises(artifacts):
    """set_repeats as the JAX streamer's; with a mesh of 3 ranks R (64: four
    segments) is rounded down to a multiple of 3 as the JAX planning rounds
    it over a 3-device data axis, and each rank's put_chunk ships its third of the
    chunk's rows (the all-gather that completes it, in acquire, is held by
    tests/test_torch_dist_solver.py)."""
    from adaptive_voice_conversion_tpu.core.mesh import make_mesh as j_make_mesh
    from adaptive_voice_conversion_tpu_torch.core.mesh import Mesh

    ref, ours, ds = chunk_pair(artifacts, "float32", 40, 2, 1)
    ours.set_repeats(4)
    ref.set_repeats(4)
    assert ours.repeats == 4 and ours._epoch_visits(1) == ref._epoch_visits(1)
    ours.set_repeats(0)
    assert ours.repeats == 1
    jds, _ = pair(artifacts, "float32")
    kw = dict(batch_size=4, inner_steps=2, seed=3)
    j3 = JChunked(jds, 40 * N_MELS * 4, mesh=j_make_mesh(3, devices=jax.devices()[:3]), **kw)
    for rank in range(3):
        mesh = Mesh(3, 1, rank, 3, None, torch.device("cpu"))
        ours3 = ChunkedDeviceStreamer(ds, 40 * N_MELS * 4, mesh=mesh, **kw)
        assert (ours3.R, ours3.n_chunks, ours3.dropped_segments) == (j3.R, j3.n_chunks, j3.dropped_segments)
        np.testing.assert_array_equal(ours3.starts_padded, j3.starts_padded)
        part = ours3.put_chunk(1)
        third = ours3.R // 3
        assert ours3.R == 63 and ours3.last_h2d_rows == third and part.mesh is mesh
        lo = ours3.R + third * rank
        np.testing.assert_array_equal(part.packed.numpy(), ds.packed[lo : lo + third])


def test_next_chunk_waits_for_the_copy_inside_its_span(artifacts, monkeypatch):
    """``next_chunk`` returns the chunk a thread's ``put_chunk`` made,
    acquired, and records ``train.chunk_wait`` around the wait only while a
    profiler records."""
    from concurrent.futures import ThreadPoolExecutor

    from torch.profiler import ProfilerActivity, profile

    _, ours, _ = chunk_pair(artifacts, "float32", 40, 2, 1)
    monkeypatch.setattr(profiling, "SPAN_LOG", profiling.SpanLog(cap=100))
    with ThreadPoolExecutor(max_workers=1) as pool:
        chunk = next_chunk(pool.submit(ours.put_chunk, 1))
        assert profiling.SPAN_LOG.spans == []
        np.testing.assert_array_equal(chunk.packed.numpy(), ours.chunk_view(1))
        assert int(chunk.n_starts) == ours.n_starts[1]
        with profile(activities=[ProfilerActivity.CPU]):
            next_chunk(pool.submit(ours.put_chunk, 0))
    assert [n for n, _, _ in profiling.SPAN_LOG.spans] == ["train.chunk_wait"]


def test_stream_visits_hands_each_visit_its_chunk_and_copies_the_next_ahead(artifacts, monkeypatch):
    """``stream_visits`` yields every visit of the schedule with its chunk;
    the first chunk is copied on the caller's thread, each later one that
    differs on another thread, submitted before the visit before it is
    handed over, and each is copied once; closing the generator early
    waits for the copy in flight."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import adaptive_voice_conversion_tpu_torch.data.chunked as chunked_mod

    _, ours, _ = chunk_pair(artifacts, "float32", 40, 2, 1)
    calls, threads, real = [], [], ours.put_chunk

    class Pool(ThreadPoolExecutor):
        def submit(self, fn, *args):
            calls.append(args[0])  # when submitted, on the caller's thread
            return super().submit(fn, *args)

    def put(chunk_id):
        if threading.current_thread() is threading.main_thread():
            calls.append(chunk_id)
        threads.append(threading.current_thread() is threading.main_thread())
        return real(chunk_id)

    monkeypatch.setattr(chunked_mod, "ThreadPoolExecutor", Pool)
    monkeypatch.setattr(ours, "put_chunk", put)
    visits = list(ours.schedule(0, 4 * ours.epoch_steps))
    assert len({v.chunk_id for v in visits}) > 1
    got = []
    for i, (v, chunk) in enumerate(stream_visits(ours, visits)):
        changes = sum(a.chunk_id != b.chunk_id for a, b in zip(visits[: i + 1], visits[1 : i + 2]))
        assert len(calls) == 1 + changes  # the next one's copy is already submitted
        np.testing.assert_array_equal(chunk.packed.numpy(), ours.chunk_view(v.chunk_id))
        got.append(v)
    assert got == visits
    expect = [visits[0].chunk_id] + [b.chunk_id for a, b in zip(visits, visits[1:]) if a.chunk_id != b.chunk_id]
    assert calls == expect and threads == [True] + [False] * (len(expect) - 1)
    calls.clear()
    switch = next(i for i, (a, b) in enumerate(zip(visits, visits[1:])) if a.chunk_id != b.chunk_id)
    stream = stream_visits(ours, visits[switch:])
    next(stream)
    stream.close()
    assert len(calls) == 2 and list(stream) == []


# -- the multi-step trainer ----------------------------------------------------


def model_and_opt(cfg, seed=0):
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model, make_optimizer(cfg.optimizer, model.parameters(), state_dtype=cfg.opt_state_dtype)


def test_multi_step_equals_host_steps_bit_for_bit(artifacts):
    """K=5 steps in one call equal 5 calls of the host step fed the batches
    and draws the multi-step took: each step seeds a generator with
    step_seed(seed, it), draws the batch's positions, then the step draws
    its eps from the same stream."""
    _, ds = pair(artifacts)
    dev = DeviceResidentDataset(ds, CPU, dtype="float32")
    cfg = tiny()
    K, seed, it0 = 5, 3, 7
    model, opt = model_and_opt(cfg)
    host_model = copy.deepcopy(model)
    host_opt = make_optimizer(cfg.optimizer, host_model.parameters())
    ms = make_device_data_train_step(cfg, model, opt, inner_steps=K)(dev.packed, dev.starts, seed, it0)
    assert ms.shape == (K, 4) and ms.dtype == torch.float32

    step = make_train_step(cfg, host_model, host_opt)
    bs = cfg.data_loader.batch_size
    for i in range(K):
        gen = torch.Generator().manual_seed(step_seed(seed, it0 + i))
        sel = draw_indices(len(ds), bs, gen)
        x = gather_rows(dev.packed, dev.starts, sel, SEG)
        np.testing.assert_array_equal(x.numpy(), ds.gather(sel.numpy()))
        lam = kl_lambda(it0 + i, cfg.loss.lambda_kl, cfg.annealing_iters)
        m = step(x, lam, generator=gen)
        row = torch.stack([m["loss"], m["loss_rec"], m["loss_kl"], m["grad_norm"]])
        torch.testing.assert_close(ms[i], row, rtol=0, atol=0)
    for a, b in zip(model.state_dict().values(), host_model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len({float(v) for v in ms[:, 1]}) == K  # five different batches


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_multi_step_padded_starts_equals_plain(artifacts, storage):
    """``n_starts = len(starts)`` over a start list padded with junk gives
    the plain form's steps exactly; bf16 storage is viewed, not converted
    (and computed in bf16: a bf16 batch into f32 convolutions raises in
    both packages)."""
    _, ds = pair(artifacts, storage)
    dev = DeviceResidentDataset(ds, CPU, dtype=storage)
    cfg = tiny(sn=True, compute_dtype=storage)
    m1, o1 = model_and_opt(cfg, seed=2)
    m2, o2 = model_and_opt(cfg, seed=2)
    plain = make_device_data_train_step(cfg, m1, o1, inner_steps=3)
    padded = make_device_data_train_step(cfg, m2, o2, inner_steps=3, padded_starts=True)
    junk = torch.cat([dev.starts, torch.full((9,), 10**9, dtype=torch.int64)])
    wire = dev.packed.view(torch.uint16) if storage == "bfloat16" else dev.packed
    a = plain(dev.packed, dev.starts, 0, 4)
    b = padded(wire, junk, torch.tensor(len(ds)), 0, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all()
    for p, q in zip(m1.state_dict().values(), m2.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    with pytest.raises(ValueError, match="requires a mesh"):
        make_device_data_train_step(cfg, m1, o1, sharded_data=True)
