"""The benchmark of adaptive_voice_conversion_tpu_torch on one NVIDIA H100.

    python3 -m vc_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One run is one process: it loads the cell
(``workloads/<cell>.json``), its configuration (``configs/<config>.json``)
and its driver (``drivers/<driver>.py``), sets up, warms up, runs the
driver's units back to back for ``--seconds``, then checks what the window
produced against the plain reference (``reference/``) and prints one JSON
line. ``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1``
profiles a few units at the start of the window with ``torch.profiler``
(the device's activity alone, so the host runs at nearly its untraced
speed; then a few more units with the host's operators too, for the
breakdown of idle gaps) and reports the per-layer metrics, each read by
``metrics/<metric>.py`` or, where there is none, by the file of the name's
first part (``metrics/idle_share.py`` reads ``idle_share.train``).
Everything is found by the names in ``BENCHMARK.json``: a new cell,
configuration, driver or metric is a new file.

A cell whose workload file sets ``steady_host`` runs its window with
Python's collector off (what set-up made is frozen first) and with the
main thread pinned to one CPU, so that the host's dispatch, which bounds
the training step, varies less from run to run.

A run fails, and prints no result, without a CUDA device, and when the
process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
BENCHMARK_JSON = HERE.parent / "BENCHMARK.json"
# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "adaptive_voice_conversion_tpu")
# device events that are not operations of the device
_NOT_DEVICE_OPS = re.compile(r"^(ProfilerStep|Optimizer\.|## |\[)")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"vc_bench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_file(name: str) -> Path:
    """``metrics/<name>.py``, or the file of the name's first part, which
    reads the metric of that name in every cell."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.exists() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def pin_main_thread() -> Optional[int]:
    """Pins the calling thread, and the threads it starts from now on, to the
    last CPU the process may use; the threads already running (the CUDA
    driver's) keep the others. Returns the CPU, or None where there is no
    choice to make."""
    allowed = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else []
    if len(allowed) < 2:
        return None
    os.sched_setaffinity(0, {allowed[-1]})
    return allowed[-1]


@contextlib.contextmanager
def collector_off():
    """Python's cyclic collector off over the window, with everything made
    before it frozen out of later collections."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that this
    cell reports: those that list it, and those without a list whose moved
    metric (per-layer) or whose own name (end-to-end) the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


class Context:
    """What a driver gets: the cell, its configuration, the seed, the
    device, and the benchmark's own spans (in memory, seconds by name)."""

    def __init__(self, cell_name: str, cell: dict, cfg: dict, seed: int, device,
                 trace: bool = False, control: bool = False):
        self.cell_name, self.cell, self.cfg = cell_name, cell, cfg
        self.seed, self.device, self.trace, self.control = int(seed), device, trace, control
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def mark(self, what: str) -> None:
        """A line on standard error: the seconds since the process started."""
        print(f"[setup] {what} at {time.perf_counter() - T_START:.2f} s", file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    """The device's operations and the host's CPU events in a traced window,
    from the profiler's raw events: ``ops`` (name, start ns, end ns) of the
    kernels, copies and sets, ``window_ns`` the window's bounds."""

    def __init__(self, prof, t0_ns: int, t1_ns: int):
        from torch.autograd import DeviceType

        self.window_ns = (t0_ns, t1_ns)
        self.ops, self.cpu = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or _NOT_DEVICE_OPS.match(e.name()):
                    continue
                s, t = max(start, t0_ns), min(end, t1_ns)
                if t > s:
                    self.ops.append((e.name(), s, t))
            elif end > start:
                self.cpu.append((e.name(), start, end))

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self, pattern: Optional[str] = None) -> float:
        """Seconds in which an operation (one whose name matches
        ``pattern``) ran on the device: the union of their intervals."""
        rx = re.compile(pattern) if pattern else None
        return _union_ns((s, e) for n, s, e in self.ops if rx is None or rx.search(n)) / 1e9

    def launches(self) -> int:
        return len(self.ops)

    def top_ops(self, n: int = 10) -> list:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return sorted(([k[:120], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time of the device, summed by the outermost host event that
        was running at each gap's middle."""
        ops = sorted((s, e) for _, s, e in self.ops)
        gaps, end = [], self.window_ns[0]
        for s, e in ops:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window_ns[1] > end:
            gaps.append((end, self.window_ns[1]))
        cpu = sorted(self.cpu, key=lambda c: c[1])
        by: Dict[str, float] = {}
        active: list = []
        i = 0
        for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
            mid = (g0 + g1) // 2
            while i < len(cpu) and cpu[i][1] <= mid:
                active.append(cpu[i])
                i += 1
            active = [c for c in active if c[2] >= mid]
            name = max(active, key=lambda c: c[2] - c[1])[0] if active else "host outside traced ops"
            by[name[:120]] = by.get(name[:120], 0.0) + (g1 - g0) / 1e9
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


class Profiled:
    """Traces units ``first`` .. ``first + count - 1`` of the window with
    ``torch.profiler`` recording the device's activity alone, for the
    metrics, then the next ``count`` units with the host's operators too,
    for the breakdown of idle gaps by what the host was doing (recording
    every operator slows the host's dispatch about twofold). Each traced
    stretch has a synchronise at both ends, so that it holds its units
    whole."""

    def __init__(self, ctx: Context, first: int, count: int):
        self.ctx, self.first, self.count = ctx, first, count
        self.prof = None
        self.trace: Optional[Trace] = None
        self.host_trace: Optional[Trace] = None
        self.units: list = []

    @property
    def done(self) -> bool:
        return self.host_trace is not None

    def _start(self, activities) -> None:
        from torch.profiler import profile

        self.ctx.sync()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.ctx.sync()
        self.t0 = time.time_ns()

    def _stop(self) -> Trace:
        self.ctx.sync()
        t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        tr = Trace(self.prof, self.t0, t1)
        self.prof = None
        return tr

    def before(self, k: int) -> None:
        from torch.profiler import ProfilerActivity

        on_card = self.ctx.device.type == "cuda"
        if k == self.first:
            self._start([ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
        elif k == self.first + self.count:
            self._start([ProfilerActivity.CPU, ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])

    def after(self, k: int, desc) -> None:
        if self.prof is None:
            return
        if self.trace is None:
            self.units.append(desc)
            if k == self.first + self.count - 1:
                self.trace = self._stop()
        elif k == self.first + 2 * self.count - 1:
            self.host_trace = self._stop()


def device_info(device, peak: int) -> dict:
    import torch

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device=None,
             control: bool = False, cell: Optional[dict] = None, cfg: Optional[dict] = None,
             bench: Optional[dict] = None, log: Callable[[str], None] = None) -> dict:
    """One run of a cell; returns the result line as a dict. ``cell`` and
    ``cfg`` default to the files the names point at; ``control`` puts the
    driver's lower-precision control in the program's place."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = bench if bench is not None else load_json(BENCHMARK_JSON)
    cell = cell if cell is not None else load_json(HERE / "workloads" / f"{cell_name}.json")
    cfg = cfg if cfg is not None else load_json(HERE / "configs" / f"{cell['config']}.json")
    device = torch.device(device or "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    driver = importlib.import_module(f"vc_bench.drivers.{cell['driver']}")
    ctx = Context(cell_name, cell, cfg, seed, device, trace, control)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        log("[card] " + power_line())
        if cell.get("steady_host"):
            torch.empty(1, device=device)  # the CUDA context, and its threads, before the pin
            log(f"[host] main thread pinned to CPU {pin_main_thread()}")

    ctx.mark("imports and the card")
    state = driver.setup(ctx)
    ctx.sync()
    ctx.mark("set-up")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START
    prof = Profiled(ctx, cell["trace_first_unit"], cell["trace_units"]) if trace else None

    unit_s: List[float] = []
    with collector_off() if cell.get("steady_host") else contextlib.nullcontext():
        t0 = time.perf_counter()
        k = 0
        while True:
            if prof:
                prof.before(k)
            u0 = time.perf_counter()
            desc = driver.unit(state, ctx, k)
            now = time.perf_counter()
            unit_s.append(now - u0)
            if prof:
                prof.after(k, desc)
            k += 1
            if now - t0 >= seconds and (prof is None or prof.done):
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
    q = sorted(unit_s)
    log(f"[window] {len(q)} units in {window_s:.3f} s; a unit's seconds p25 {q[len(q) // 4]:.4f} "
        f"p50 {q[len(q) // 2]:.4f} p75 {q[3 * len(q) // 4]:.4f} max {q[-1]:.4f}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    outcome = driver.finish(state, ctx, unit_s, window_s)
    checks = driver.check(state, ctx)
    correct = outcome["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    wanted = cell_metrics(bench, cell_name, "per_layer" if trace else "end_to_end")
    metrics: Dict[str, dict] = {}
    dev = device_info(device, peak)
    result = {"correct": correct, "attempted": outcome["attempted"], "failed": outcome["failed"]}
    breakdown = None
    if trace:
        tr = prof.trace
        lo, n = prof.first, prof.count
        rest = sorted(unit_s[:lo] + unit_s[lo + 2 * n:])
        log(f"[trace] {n} units traced in {tr.window_s:.4f} s ({tr.window_s / n:.4f} s a unit; "
            f"{sum(unit_s[lo + n:lo + 2 * n]) / n:.4f} with the host's operators); the untraced "
            f"units' median {rest[len(rest) // 2] if rest else float('nan'):.4f} s")
        record = {"cell": cell, "config": cfg, "spans": ctx.spans, "trace": tr,
                  "units": prof.units}
        for m in wanted:
            value = load_module(metric_file(m["name"])).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": prof.host_trace.idle_gaps()}
    else:
        values = dict(outcome["metrics"], setup_s=setup_s)
        for m in wanted:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]} for k, c in checks.items()}
    return result


def finite(x):
    """A number as JSON can hold it: null for inf and nan."""
    return float(x) if x == x and abs(x) != float("inf") else None


def power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    # one process with one thread of host arithmetic (numpy's BLAS, torch's
    # CPU ops): the host's other work varies less from run to run
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")

    import torch

    torch.set_num_threads(1)
    cell = load_json(HERE / "workloads" / f"{args.workload}.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vc_bench: cell {args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {n}; no result", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"vc_bench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
