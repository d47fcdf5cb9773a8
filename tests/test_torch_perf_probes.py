"""The port's perf probes (tools/perf_probes.py) on the CPU at tiny sizes:
each runs, its checks pass and its lines parse; the CLI keeps the JAX
package's probe names and its "unknown probe" error.

The bank and residual probes run at 16 channels: at 8 input channels and a
kernel of 8 taps the CPU's bf16 conv1d of the installed PyTorch is wrong
(relative error ~1, not a rounding), which ``probe_bank``'s check rejects;
at 16 channels it agrees with f32 math on bf16 operands. On the card the
probes run at the JAX shapes (chip_smoke.py phase 12).
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.tools import perf_probes as pp

from test_torch_solver import one_intra_op_thread  # noqa: F401
from test_torch_train import tiny

REPO = Path(__file__).resolve().parents[1]
N = 2  # applications a timing; the card runs 50
# "<name>: eager fwd E ms   eager fwd+bwd E ms" (no graph on the CPU)
TIMED = re.compile(r"^(\S+): eager fwd ([\d.]+) ms(?:   eager fwd\+bwd ([\d.]+) ms)?$")


def timed_lines(out: str) -> dict:
    return {m.group(1): m.groups()[1:] for m in map(TIMED.match, out.splitlines()) if m}


def test_probe_bank(capsys):
    r = pp.probe_bank("cpu", B=2, T=16, c_in=16, c_bank=4, n=N)
    assert set(r["max_diff"]) == set(pp.BANK_GROUPINGS)
    assert all(d <= r["tol"] for d in r["max_diff"].values())
    lines = timed_lines(capsys.readouterr().out)
    assert set(lines) == set(pp.BANK_GROUPINGS)
    for name, (fwd, bwd) in lines.items():
        assert float(fwd) > 0 and float(bwd) > 0
        assert r["times"][name]["fwd"].graph is None  # no graph off the card


def test_probe_bank_rejects_a_grouping_that_differs(monkeypatch):
    """The check holds: a bank whose grouped output is wrong fails it."""
    real = pp.conv_bank

    def wrong(x, ws, bs, ks, act, group_size=2, compute_dtype=None):
        out = real(x, ws, bs, ks, act, group_size=group_size, compute_dtype=compute_dtype)
        return out if group_size == 8 else out + 1.0

    monkeypatch.setattr(pp, "conv_bank", wrong)
    with pytest.raises(RuntimeError, match="differ from fused1"):
        pp.probe_bank("cpu", B=2, T=16, c_in=16, c_bank=4, n=N)


def test_probe_parts(capsys):
    r = pp.probe_parts("cpu", B=4, T=16, cfg=tiny(tcfg), n=N)
    want = ["spk_fwd", "cnt_fwd", "dec_fwd", "ae_fwd", "loss_fwd"]
    assert list(r["times"]) == want
    lines = timed_lines(capsys.readouterr().out)
    assert list(lines) == want and all(float(f) > 0 and b is None for f, b in lines.values())


def test_probe_residual(capsys):
    r = pp.probe_residual("cpu", B=2, T=16, C=16, n=N)
    out = capsys.readouterr().out
    assert set(timed_lines(out)) == {"conv", "im2col", "shifts"}
    printed = dict(re.findall(r"^(\w+): max\|diff\| vs conv = ([\d.e+-]+)$", out, re.M))
    assert set(printed) == {"im2col", "shifts"}
    assert all(np.isfinite(float(v)) for v in printed.values())
    assert r["max_diff"]["conv"] == 0.0
    # in bf16 the formulations round at other points (each tap's product,
    # for the shifts), so they agree only to bf16's precision; the next
    # test holds them to the conv in f32


def test_residual_formulations_are_the_conv(monkeypatch):
    """im2col and the shifted products are the strided reflect-padded conv
    (f32 operands: within f32 summation order)."""
    monkeypatch.setattr(pp, "BF16", torch.float32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 13, generator=g)
    w, b = torch.randn(5, 6, 5, generator=g), torch.randn(5, generator=g)
    for stride in (1, 2):
        want = pp.conv1d(x, w, b, stride=stride)
        for f in (pp._conv_im2col, pp._conv_shifts):
            torch.testing.assert_close(f(x, w, b, stride), want, rtol=1e-5, atol=1e-5)


def test_probe_bank_split(capsys):
    r = pp.probe_bank_split("cpu", B=2, T=16, c_in=16, c_bank=4, c_h=8, n=N)
    out = capsys.readouterr().out
    diff = float(re.search(r"^split vs concat max\|diff\| = ([\d.e+-]+)$", out, re.M).group(1))
    assert diff == pytest.approx(r["max_diff"], rel=1e-2, abs=1e-12)
    assert np.isfinite(r["max_diff"])  # tests/test_torch_experiments.py holds the two
    assert set(timed_lines(out)) == {"concat+1x1", "split-partials"}


def test_probe_opt(capsys):
    r = pp.probe_opt("cpu", n_frames=200, n_starts=50, calls=1, cfg=tiny(tcfg))
    assert set(r) == {"float32", "bfloat16"} and all(v > 0 for v in r.values())
    out = capsys.readouterr().out
    got = re.findall(r"^opt_state_dtype=(\w+) fused=False: ([\d.]+) ms/step$", out, re.M)
    assert [k for k, _ in got] == ["float32", "bfloat16"]


def test_probe_profile(tmp_path, capsys):
    files = pp.probe_profile("cpu", str(tmp_path / "prof"), n_frames=200, n_starts=50, calls=1,
                             cfg=tiny(tcfg))
    assert files and all(size > 0 for _, size in files)
    assert any(Path(f).name == "trace.json" for f, _ in files)
    assert "trace captured in" in capsys.readouterr().out


def test_cli_names_and_unknown_probe(capsys):
    with pytest.raises(SystemExit, match=r"unknown probe 'nope' \(bank\|parts\|residual\|bank_split\|opt\|profile\)"):
        pp.main(["nope", "--device", "cpu"])
    assert pp.PROBES == ("bank", "parts", "residual", "bank_split", "opt", "profile")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pp.main(["bank"])  # the default device is the card, never a fallback


def test_cli_in_its_own_process():
    """As chip_smoke.py starts the probes: ``python -m``; an unknown probe
    exits non-zero with the JAX message, before touching any device."""
    proc = subprocess.run(
        [sys.executable, "-m", "adaptive_voice_conversion_tpu_torch.tools.perf_probes", "nope"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "unknown probe 'nope'" in proc.stderr
