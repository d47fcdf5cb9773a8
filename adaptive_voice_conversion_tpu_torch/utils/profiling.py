"""Tracing hooks: a ``torch.profiler`` trace of a code region
(``profile_trace``), the program's own spans at its layer boundaries
(``span``), read back by ``span_seconds``, and its counters (``count``),
read back by ``counter_total``.

A span is on only while a torch profiler records, whatever its activities
(``profile_trace``, ``cli/train --profile_dir``, ``tools/perf_probes``, any
``torch.profiler.profile`` around the program); otherwise it costs one flag
read. While on, it opens a ``record_function`` named ``"## <name>"``, so the
profiler's trace shows it among the host's events, and appends ``(name,
start ns, end ns)`` on the ``time.time_ns()`` clock, the profiler's own, to
``SPAN_LOG``. Spans are flat: no span encloses another, so the innermost
host event at any moment names one layer. The names:

    dsp.mel         dsp/features.py::mel_from_wave: host STFT, mel, dB
    dsp.trim        dsp/audio.py: every trim_silence call (host numpy), every
                    trim_bounds call (its dispatch on the wavs' device); the
                    host's slicing of the served wavs to those bounds
    infer.assemble  the Inferencer's inputs: framing, padding, stacking,
                    the cross product, host-to-device copies, length reads
    infer.model     the model's forward in the Inferencer
    infer.vocode    mel to magnitude, Griffin-Lim, de-emphasis
    infer.generate  the HiFi-GAN generator's dispatch and its length masks
                    (models/hifigan.py), in place of infer.vocode
    infer.to_host   each copy of a result to the host (the wait included)
    train.sample    a multi-step's draw: seeds, segments, the KL weight
    train.forward   the step's zero_grad through its loss
    train.backward  loss.backward()
    train.update    after backward through optimizer.step()
    train.replay    a step replayed from the multi-step's CUDA graph: the
                    seed, the copy of the step's scalars, the replay, the
                    copy of its metrics (train/step.py ``StepGraph``); a
                    replayed step emits no other span

A counter, like a span, records only while a torch profiler records, and
otherwise costs one flag read. Each ``count(name, value)`` appends ``(name,
ns, value)`` to ``COUNTER_LOG`` on the same clock; a value may be a 0-dim
device tensor, kept as it is (no synchronisation) and read when summed, or
a function that computes it, called only while recording.
The names:

    voc.samples           the generator's valid output samples in a call:
                          hop x the sum of the rows' frame lengths
    voc.computed_samples  the samples it computed, padding included:
                          hop x rows x padded frames
    trim.card_rows        the rows whose silence bounds dsp/audio.py
                          ``trim_bounds`` computed in one batched pass on the
                          wavs' device (the card on the serving path)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a host and (where there is one) device trace of the
    enclosed region into ``logdir`` as a Chrome trace, viewable in
    Perfetto or chrome://tracing:

        with profile_trace("prof/"):
            for _ in range(20):
                metrics = step(x, lam)
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class SpanLog:
    """The recorded spans, in the order they closed, up to ``cap``; the spans
    that came after the cap are counted in ``dropped``."""

    def __init__(self, cap: int):
        self.cap = cap
        self.spans: List[Tuple[str, int, int]] = []
        self.dropped = 0

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        if len(self.spans) < self.cap:
            self.spans.append((name, start_ns, end_ns))
        else:
            self.dropped += 1


SPAN_LOG = SpanLog(cap=1_000_000)


@contextlib.contextmanager
def _recorded(name: str) -> Iterator[None]:
    with torch.profiler.record_function("## " + name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            SPAN_LOG.add(name, t0, time.time_ns())


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one layer's work: recorded while a torch
    profiler records (the module docstring), nothing otherwise. It adds no
    synchronisation."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name)


class CounterLog:
    """The recorded counts ``(name, ns, value)``, in order, up to ``cap``; the
    counts that came after the cap are counted in ``dropped``."""

    def __init__(self, cap: int):
        self.cap = cap
        self.counts: List[Tuple[str, int, object]] = []
        self.dropped = 0

    def add(self, name: str, ns: int, value) -> None:
        if len(self.counts) < self.cap:
            self.counts.append((name, ns, value))
        else:
            self.dropped += 1


COUNTER_LOG = CounterLog(cap=1_000_000)


def count(name: str, value) -> None:
    """Adds ``value`` (a number or a 0-dim tensor, or a function that returns
    one, called only then) to the counter ``name`` while a torch profiler
    records (the module docstring); nothing otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        COUNTER_LOG.add(name, time.time_ns(), value() if callable(value) else value)


def counter_total(name: str, t0_ns: int, t1_ns: int) -> float:
    """The sum of the counts of ``name`` recorded inside [t0_ns, t1_ns]."""
    return float(sum(float(v) for n, t, v in COUNTER_LOG.counts if n == name and t0_ns <= t <= t1_ns))


def span_seconds(name: str, t0_ns: int, t1_ns: int) -> float:
    """Total seconds of the spans named ``name`` that lie wholly inside
    [t0_ns, t1_ns] on the ``time.time_ns()`` clock."""
    return sum(e - s for n, s, e in SPAN_LOG.spans if n == name and s >= t0_ns and e <= t1_ns) / 1e9
