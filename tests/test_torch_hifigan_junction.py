"""The HiFi-GAN generator's junctions (kernels/hifigan.py): each plain
version against the eager sequence the generator ran before the kernel, bit
for bit, on the CPU; the generator's fused path through the plain versions
against its eager path, bit for bit; the junction counters and the
benchmark's ``fused_share`` reader of them. The tests marked ``cuda`` hold
the kernel against its plain version and the generator's fused path against
its eager one on the card, and the wrapper's refusals; they skip without a
card. The file imports nothing of JAX; on the card run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hifigan_junction.py
"""

import types

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from adaptive_voice_conversion_tpu_torch.kernels import hifigan as hj
from adaptive_voice_conversion_tpu_torch.models import hifigan
from adaptive_voice_conversion_tpu_torch.utils import profiling
from vc_bench import run as bench_run

from test_torch_hifigan import tiny_generator, weight_normed_state_dict

MODES = ("J0", "J1", "J2", "J3")
N_BLOCKS = 3


def bits(t: torch.Tensor) -> torch.Tensor:
    """The f32 bit patterns, so that -0.0 and 0.0 differ."""
    return t.contiguous().view(torch.int32)


def assert_bitwise(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.shape == b.shape and torch.equal(bits(a), bits(b))


def parent_mask(lengths, t, scale):
    """The generator's mask before the kernel, as it built it."""
    steps = torch.arange(t)
    return (steps[None, :] < (lengths * scale)[:, None]).to(torch.float32)[:, None, :]


def activations(shape, k, seed, device="cpu"):
    """k seeded activations with exact zeros of both signs among them."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(k):
        a = torch.randn(shape, generator=g)
        a.view(-1)[::7] = 0.0
        a.view(-1)[3::11] = -0.0
        out.append(a.to(device))
    return out


def eager(mode, cs, xs, mask, slope, biases):
    """The generator's eager ops that a junction replaces, on clones: each
    convolution's bias added to its output as nn.Conv1d adds it after cuDNN,
    then the junction's ops; J3 runs the three blocks' sum, the mean and the
    next layer's LeakyReLU."""
    cs, xs = [c.clone() for c in cs], [x.clone() for x in xs]
    cs = [c.add_(b.view(1, -1, 1)) for c, b in zip(cs, biases)]
    m = (lambda t: t) if mask is None else (lambda t: t.mul_(mask))
    if mode == "J0":
        x = m(cs[0])
        return [x, F.leaky_relu(x, slope)]
    if mode == "J1":
        return [F.leaky_relu(m(cs[0]), slope, inplace=True)]
    if mode == "J2":
        x = m(cs[0]).add_(xs[0])
        return [x, F.leaky_relu(x, slope)]
    total = None
    for c, x in zip(cs, xs):
        y = m(c).add_(x)
        total = y if total is None else total.add_(y)
    return [F.leaky_relu(total.div_(N_BLOCKS), slope)]


def fused(fn, mode, cs, xs, lengths, scale, slope, biases):
    """The same through ``fn`` (junction or junction_plain), one call a
    junction as the generator makes them, on clones."""
    cs, xs = [c.clone() for c in cs], [x.clone() for x in xs]
    if mode in ("J0", "J1"):
        out = fn(mode, cs[0], biases[0], lengths, scale, slope)
    elif mode == "J2":
        out = fn(mode, cs[0], biases[0], lengths, scale, slope, x=xs[0])
    else:
        out = None
        for j, (c, x, b) in enumerate(zip(cs, xs, biases)):
            out = fn(mode, c, b, lengths, scale, slope, x=x, total=out, block=j, n_blocks=N_BLOCKS)
    return list(out) if isinstance(out, tuple) else [out]


def inputs(shape, device="cpu"):
    """Three convolution outputs, three residuals and three biases."""
    g = torch.Generator().manual_seed(7)
    biases = [torch.randn(shape[1], generator=g).to(device) for _ in range(N_BLOCKS)]
    return activations(shape, N_BLOCKS, 1, device), activations(shape, N_BLOCKS, 2, device), biases


@pytest.mark.parametrize("slope", [0.1, 0.01])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_the_plain_version_is_the_eager_sequence_bit_for_bit(mode, masked, slope):
    b, ch, t, scale = 3, 4, 37, 5
    lengths = torch.tensor([7, 3, 5]) if masked else None
    cs, xs, biases = inputs((b, ch, t))
    want = eager(mode, cs, xs, parent_mask(lengths, t, scale) if masked else None, slope, biases)
    got = fused(hj.junction, mode, cs, xs, lengths, scale, slope, biases)  # CPU tensors: the plain version
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bitwise(g, w)
    if masked and mode in ("J0", "J1"):  # past each row's length: zeros, of either sign
        assert all((o[r, :, lengths[r] * scale:] == 0).all() for o in got for r in range(b))


@pytest.mark.parametrize("dils", [None, ((1,),)])
@pytest.mark.parametrize("masked", [True, False])
def test_the_fused_path_is_the_eager_path_bit_for_bit_on_the_cpu(masked, dils):
    """The generator's fused path through the plain junctions (what the card
    runs, junction for junction) against its eager path: the published three
    blocks of three dilations, and one block of one."""
    kw = {} if dils is None else dict(resblock_kernel_sizes=(3,), resblock_dilations=dils)
    gen = tiny_generator(**kw)[0]
    x = torch.randn(3, gen.cfg.in_channels, 11, generator=torch.Generator().manual_seed(4))
    lengths = torch.tensor([11, 4, 8]) if masked else None
    calls = []

    def counted(mode, *a, **k):
        calls.append(mode)
        return hj.junction(mode, *a, **k)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(hifigan, "junction", counted)
        got = gen._run_fused(x.clone(), lengths)
    with torch.no_grad():
        want = gen._run_eager(x.clone(), lengths)
    assert_bitwise(got, want)
    assert len(calls) == gen.junctions
    stages, pairs = len(gen.cfg.upsample_scales), sum(map(len, gen.cfg.resblock_dilations))
    assert calls.count("J0") == stages and calls.count("J3") == stages * gen.n_blocks
    assert calls.count("J1") == 1 + stages * pairs


def test_the_fused_path_runs_weight_norms_hook_on_the_cpu():
    """A generator still weight-normed (``torch.nn.utils.weight_norm``, whose
    forward pre-hook computes each convolution's weight) on the fused path
    through the plain junctions, against its eager path, which calls the
    modules: bit for bit."""
    wn = weight_normed_state_dict(tiny_generator()[0])
    x = torch.randn(2, wn.cfg.in_channels, 9, generator=torch.Generator().manual_seed(5))
    lengths = torch.tensor([9, 6])
    with torch.no_grad():  # the fused path first: the eager one's calls run the hooks
        got = wn._run_fused(x.clone(), lengths)  # CPU tensors: the plain junctions
        want = wn._run_eager(x.clone(), lengths)
    assert_bitwise(got, want)


def test_the_junction_counters_on_the_cpu(monkeypatch):
    log = profiling.CounterLog(cap=1_000_000)
    monkeypatch.setattr(profiling, "COUNTER_LOG", log)
    gen = tiny_generator()[0]
    mel = torch.randn(2, 9, gen.cfg.in_channels)
    with torch.no_grad():
        gen.generate(mel, torch.tensor([9, 5]))
        assert log.counts == []
        with profile(activities=[ProfilerActivity.CPU]):
            gen.generate(mel, torch.tensor([9, 5]))
            gen.generate(mel)
    # 2 stages, each its upsample and 3 blocks x 3 dilations x 2 convolutions, and input_conv
    assert gen.junctions == 1 + 2 * (1 + 3 * 3 * 2) == 39
    assert profiling.counter_total("voc.junctions", 0, 2**63) == 2 * 39
    assert profiling.counter_total("voc.fused_junctions", 0, 2**63) == 0


def test_the_fused_share_reader(monkeypatch):
    log = profiling.CounterLog(cap=1_000_000)
    monkeypatch.setattr(profiling, "COUNTER_LOG", log)
    reader = bench_run.load_module(bench_run.metric_file("fused_share.grid_hifigan"))
    record = {"units": [{}, {}], "trace": types.SimpleNamespace(window_ns=(1_000, 9_000))}
    assert reader.read(record) is None  # no counts: a program without the kernel
    log.add("voc.junctions", 2_000, 77)
    log.add("voc.fused_junctions", 2_001, 77)
    log.add("voc.junctions", 3_000, 77)
    log.add("voc.fused_junctions", 3_001, 0)
    log.add("voc.junctions", 500, 77)  # before the window
    log.add("voc.fused_junctions", 9_500, 77)  # after it
    assert reader.read(record) == pytest.approx(50.0)


@pytest.mark.parametrize("mode, block, arrays", [
    ("J0", 0, 3), ("J1", 0, 2), ("J2", 0, 4), ("J3", 0, 3), ("J3", 1, 4), ("J3", 2, 4)])
def test_the_bytes_a_launch_moves(mode, block, arrays):
    # the activations, and the bias once
    assert hj.junction_bytes(mode, (2, 3, 5), block, N_BLOCKS) == (arrays * 2 * 5 + 1) * 3 * 4
    assert hj.junction_bytes("J3", (2, 3, 5), 0, 1) == (3 * 2 * 5 + 1) * 3 * 4  # one block: y / 1
    with pytest.raises(ValueError):
        hj.junction_flags("J3", 3, N_BLOCKS)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the junction kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_kernels_flags_are_the_modules(card):
    assert hj.kernel_flags() == (hj.RES, hj.ACC, hj.SCALE, hj.STORE_V, hj.STORE_A)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [37, 64, 3])
@pytest.mark.parametrize("slope", [0.1, 0.01])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_the_kernel_is_its_plain_version_on_the_card(card, mode, masked, slope, t):
    """Rows of 37 frames start off the 16-byte grid (a scalar head and tail
    around the float4 body), of 64 on it, of 3 have no body."""
    b, ch, scale = 3, 5, 4
    lengths = torch.tensor([7, 1, 9], device=card) if masked else None
    cs, xs, biases = inputs((b, ch, t), card)
    launches = hj.junction.launches
    got = fused(hj.junction, mode, cs, xs, lengths, scale, slope, biases)
    want = fused(hj.junction_plain, mode, cs, xs, lengths, scale, slope, biases)
    torch.cuda.synchronize()
    assert hj.junction.launches - launches == (N_BLOCKS if mode == "J3" else 1)
    for g, w in zip(got, want):
        assert_bitwise(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_the_fused_path_is_the_eager_path_on_the_card(card, masked):
    gen = tiny_generator()[0].to(card)
    mel = torch.randn(3, 13, gen.cfg.in_channels, device=card)
    lengths = torch.tensor([13, 5, 9], device=card) if masked else None
    launches = hj.junction.launches
    with torch.no_grad():
        got = gen.generate(mel, lengths)
        want = gen._run_eager(mel.transpose(1, 2), lengths)[:, 0]
    assert hj.junction.launches - launches == gen.junctions
    assert_bitwise(got, want)


@pytest.mark.cuda
def test_the_fused_path_runs_weight_norms_hook_on_the_card(card):
    wn = weight_normed_state_dict(tiny_generator()[0]).to(card)
    mel = torch.randn(2, 9, wn.cfg.in_channels, device=card)
    lengths = torch.tensor([9, 6], device=card)
    with torch.no_grad():
        got = wn.generate(mel, lengths)  # first: the eager path's calls run the hooks
        want = wn._run_eager(mel.transpose(1, 2), lengths)[:, 0]
    assert_bitwise(got, want)


def _bad_inputs(card):
    c = torch.zeros(2, 3, 8, device=card)
    lengths = torch.tensor([8, 4], device=card)
    return {
        "non_contiguous": dict(c=torch.zeros(2, 8, 3, device=card).transpose(1, 2)),
        "float64": dict(c=c.double()),
        "two_dims": dict(c=c[0]),
        "x_shape": dict(mode="J2", x=torch.zeros(2, 3, 9, device=card)),
        "x_missing": dict(mode="J2"),
        "x_misaligned": dict(mode="J2", x=torch.zeros(2 * 3 * 8 + 1, device=card)[1:].view(2, 3, 8)),
        "lengths_int32": dict(lengths=lengths.int()),
        "lengths_on_the_host": dict(lengths=lengths.cpu()),
        "lengths_shape": dict(lengths=lengths[:1]),
        "needs_grad": dict(c=c.clone().requires_grad_()),
        "bias_shape": dict(bias=torch.zeros(4, device=card)),
        "bias_on_the_host": dict(bias=torch.zeros(3)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non_contiguous", "float64", "two_dims", "x_shape", "x_missing",
                                 "x_misaligned", "lengths_int32", "lengths_on_the_host",
                                 "lengths_shape", "needs_grad", "bias_shape", "bias_on_the_host"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(card, bad):
    kw = dict(mode="J1", c=torch.zeros(2, 3, 8, device=card), bias=torch.zeros(3, device=card),
              lengths=torch.tensor([8, 4], device=card))
    kw.update(_bad_inputs(card)[bad])
    launches = hj.junction.launches
    with pytest.raises(ValueError):
        hj.junction(kw.pop("mode"), kw.pop("c"), kw.pop("bias"), kw.pop("lengths"), 2, 0.1, **kw)
    assert hj.junction.launches == launches
