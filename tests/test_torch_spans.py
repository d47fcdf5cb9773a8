"""The port's spans (utils/profiling.py ``span``) and the benchmark's readers
of them (vc_bench/metrics/*_ms.py through vc_bench/spans.py), on the CPU.

A span records only under a torch profiler, on the profiler's own clock, as
a ``## <name>`` host event that the benchmark keeps out of the device's
operations; the serving and training paths emit their spans in order and
flat, and compute the same numbers with the profiler on as with it off."""

import pickle
import re
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.dsp.audio import trim_silence
from adaptive_voice_conversion_tpu_torch.dsp.features import mel_from_wave
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.train.optim import make_train_optimizer
from adaptive_voice_conversion_tpu_torch.train.step import make_device_data_train_step
from adaptive_voice_conversion_tpu_torch.utils import profiling
from vc_bench import run as bench_run

from test_torch_masked import N_MELS, SIGNAL, tiny_model_configs

PORT = Path(profiling.__file__).resolve().parents[1]
NAMES = ("dsp.mel", "dsp.trim", "infer.assemble", "infer.model", "infer.vocode", "infer.generate",
         "infer.to_host", "train.sample", "train.forward", "train.backward", "train.update", "train.replay")
SEG, BATCH = 16, 4


@pytest.fixture
def log(monkeypatch):
    fresh = profiling.SpanLog(cap=1_000_000)
    monkeypatch.setattr(profiling, "SPAN_LOG", fresh)
    return fresh


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def host_events(prof):
    """(name, start ns, end ns) of the trace's ``## `` events, by start."""
    out = [(e.name()[3:], e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("## ")]
    return sorted(out, key=lambda e: e[1])


def test_a_span_records_nothing_without_a_profiler(log):
    with profiling.span("test.off"):
        torch.ones(8) + 1
    assert log.spans == [] and log.dropped == 0
    assert isinstance(profiling.span("test.off"), type(profiling._OFF))


def test_a_span_shares_the_profilers_clock(log):
    """Each span's ``## `` event starts and ends within 1 ms of the recorder's
    times, the median over 20 spans: the first span of a profile pays the
    profiler's one-time set-up (~1 ms on a CPU build) between the event's
    start and the clock read, which is not another clock."""
    names = [f"test.clock{k}" for k in range(20)]
    with cpu_profile() as prof:
        for name in names:
            with profiling.span(name):
                time.sleep(0.002)
    ev = host_events(prof)
    assert [n for n, _, _ in ev] == [n for n, _, _ in log.spans] == names
    assert all(re_ - rs >= 2_000_000 for _, rs, re_ in log.spans)
    starts = [abs(s - rs) for (_, s, _), (_, rs, _) in zip(ev, log.spans)]
    ends = [abs(e - re_) for (_, _, e), (_, _, re_) in zip(ev, log.spans)]
    assert np.median(starts) < 1_000_000 and np.median(ends) < 1_000_000


@pytest.mark.parametrize("name", NAMES)
def test_every_name_the_port_emits_is_kept_out_of_the_device_ops(name):
    emitted = set()
    for path in PORT.rglob("*.py"):
        emitted |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert emitted == set(NAMES)
    assert bench_run._NOT_DEVICE_OPS.match("## " + name)


def one_utterance(served, waves, frames):
    """The featurizer on two waves, then inference_one_utterance."""
    inf, sig = served
    mels = [mel_from_wave(trim_silence(w, sig.top_db)[0], sig)[0] for w in waves]
    wav, dec = inf.inference_one_utterance(inf.normalize(mels[0]), inf.normalize(mels[1]))
    return [wav, dec] + mels


def grid(served, waves, frames):
    inf, _ = served
    rng = np.random.default_rng(5)
    mels = [rng.standard_normal((n, N_MELS)).astype(np.float32) for n in frames]
    wavs, decs = inf.convert_grid(mels[:2], mels[2:], return_mels=True)
    return wavs + decs


def train_calls(served, waves, frames):
    cfg = train_config()
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    opt = make_train_optimizer(cfg, model.parameters())
    packed = torch.randn(400, N_MELS, generator=torch.Generator().manual_seed(1))
    starts = torch.arange(400 - SEG + 1, dtype=torch.int64)
    out = make_device_data_train_step(cfg, model, opt, inner_steps=2)(packed, starts, 3, 0)
    return [out.numpy()] + [p.detach().numpy().copy() for p in model.parameters()]


def train_config():
    return tcfg.TrainConfig(
        model=tiny_model_configs()[1], signal=tcfg.SignalConfig(**SIGNAL),
        data_loader=tcfg.DataLoaderConfig(segment_size=SEG, batch_size=BATCH))


SERVE = ["infer.assemble", "infer.model", "infer.to_host"]
# the served wavs' trim: their bounds on the wavs' device, one copy, the host's slices
TRIM = ["dsp.trim", "infer.to_host", "dsp.trim"]
CALLS = {  # the spans a call emits, and the rows it trims on the device
    "one_utterance": (one_utterance, ["dsp.trim", "dsp.mel"] * 2 + SERVE
                      + ["infer.assemble", "infer.vocode"] + TRIM, 1),
    "grid": (grid, ["infer.assemble", "infer.assemble", "infer.model", "infer.vocode"] + TRIM
             + ["infer.to_host"], 6),
    "train": (train_calls, ["train.sample", "train.forward", "train.backward", "train.update"] * 2, 0),
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    sig = tcfg.SignalConfig(**SIGNAL)
    rng = np.random.default_rng(7)
    attr = {"mean": rng.standard_normal(N_MELS).astype(np.float32),
            "std": (1.0 + rng.random(N_MELS)).astype(np.float32)}
    path = tmp_path_factory.mktemp("spans") / "attr.pkl"
    with open(path, "wb") as fh:
        pickle.dump(attr, fh)
    model = AE(tiny_model_configs()[1])
    init_parameters(model, torch.Generator().manual_seed(0))
    cfg = tcfg.TrainConfig(model=tiny_model_configs()[1], signal=sig)
    return Inferencer(cfg, model, str(path), device="cpu"), sig


def voiced(n, seed):
    """A wave of n samples: near-silence, a tone, near-silence."""
    rng = np.random.default_rng(seed)
    y = 1e-4 * rng.standard_normal(n)
    mid = slice(n // 5, 4 * n // 5)
    y[mid] += 0.5 * np.sin(2 * np.pi * 440 / 8000 * np.arange(mid.stop - mid.start))
    return y.astype(np.float32)


@pytest.mark.parametrize("call", list(CALLS))
def test_the_paths_emit_their_spans_in_order_flat_and_change_nothing(call, served, log, monkeypatch):
    fn, expected, trimmed_rows = CALLS[call]
    counts = profiling.CounterLog(cap=1_000_000)
    monkeypatch.setattr(profiling, "COUNTER_LOG", counts)
    waves, frames = [voiced(4000, 1), voiced(6400, 2)], [21, 34, 13, 40, 27]
    plain = fn(served, waves, frames)
    assert log.spans == [] and counts.counts == []
    with cpu_profile() as prof:
        traced = fn(served, waves, frames)
    assert [n for n, _, _ in log.spans] == expected
    assert profiling.counter_total("trim.card_rows", 0, 2**63) == trimmed_rows
    assert [n for n, _, _ in host_events(prof)] == expected
    for (_, _, end), (_, start, _) in zip(log.spans, log.spans[1:]):
        assert start >= end  # no span encloses or overlaps the next
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


READERS = {"sample_ms": "train.sample", "forward_ms": "train.forward", "backward_ms": "train.backward",
           "update_ms": "train.update", "mel_ms": "dsp.mel", "trim_ms": "dsp.trim",
           "assemble_ms": "infer.assemble", "model_ms": "infer.model", "vocode_ms": "infer.vocode",
           "generator_ms": "infer.generate", "wait_ms": "infer.to_host"}


@pytest.mark.parametrize("stem", list(READERS))
def test_a_reader_takes_the_mean_per_unit_of_the_spans_inside_the_window(stem, log):
    name = READERS[stem]
    reader = bench_run.load_module(bench_run.metric_file(f"{stem}.cell"))
    train = name.startswith("train.")
    units = [{"steps": 10}, {"steps": 10}] if train else [{}, {}, {}, {"failed": True}]
    record = {"units": units, "trace": types.SimpleNamespace(window_ns=(1_000_000, 9_000_000))}
    assert reader.read(record) is None
    log.add("other.name", 2_000_000, 3_000_000)
    assert reader.read(record) is None
    log.add(name, 2_000_000, 2_500_000)  # inside
    log.add(name, 4_000_000, 5_250_000)  # inside
    log.add(name, 500_000, 1_500_000)  # starts before the window
    log.add(name, 8_500_000, 9_500_000)  # ends after it
    assert reader.read(record) == pytest.approx(1.75 / (20 if train else 4))


def test_the_cap_counts_what_it_drops(monkeypatch):
    capped = profiling.SpanLog(cap=2)
    monkeypatch.setattr(profiling, "SPAN_LOG", capped)
    with cpu_profile():
        for k in range(5):
            with profiling.span(f"test.cap{k}"):
                pass
    assert [n for n, _, _ in capped.spans] == ["test.cap0", "test.cap1"] and capped.dropped == 3
    assert profiling.span_seconds("test.cap4", 0, time.time_ns()) == 0
