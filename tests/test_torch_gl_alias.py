"""``gl_method="pallas"``, the JAX package's name for the fused Griffin-Lim
schedule (its CLIs take ``--gl_method {exact,pallas}``), selects the port's
fused schedule everywhere "fused" does: the two vocoders, the Inferencer and
both CLIs. On the CPU the schedule runs the kernel's plain version, so the
two names must give the same wav bit for bit; any other name raises.
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from adaptive_voice_conversion_tpu_torch.cli import convert_grid as cli_grid
from adaptive_voice_conversion_tpu_torch.cli import inference as cli_inference
from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import griffin_lim, griffin_lim_masked
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
from adaptive_voice_conversion_tpu_torch.models.weights import load_checkpoint

from test_torch_serving import cli_assets  # noqa: F401

SIG = SignalConfig(sr=8000, n_fft=256, hop_length=64, win_length=192, n_mels=8, n_iter=12)


def magnitude(b, t, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.abs(rng.standard_normal((b, SIG.n_fft // 2 + 1, t))).astype(np.float32))


def test_griffin_lim_pallas_is_fused():
    mag = magnitude(2, 40)
    fused = griffin_lim(mag, SIG, method="fused")
    assert torch.equal(griffin_lim(mag, SIG, method="pallas"), fused)
    assert not torch.equal(griffin_lim(mag, SIG, method="exact"), fused)
    with pytest.raises(ValueError, match="pallas"):
        griffin_lim(mag, SIG, method="kernel")


def test_griffin_lim_masked_pallas_is_fused():
    mag, lens = magnitude(3, 48, seed=1), [48, 31, 20]
    fused = griffin_lim_masked(mag, lens, SIG, method="fused")
    assert torch.equal(griffin_lim_masked(mag, lens, SIG, method="pallas"), fused)
    with pytest.raises(ValueError, match="pallas"):
        griffin_lim_masked(mag, lens, SIG, method="kernel")


@pytest.mark.parametrize("parser", [cli_inference.build_parser, cli_grid.build_parser])
def test_cli_parsers_take_pallas(parser):
    files = ["-a", "a.pkl", "-c", "c.yaml", "-m", "m.ckpt", "-s", "s.wav", "-t", "t.wav", "-o", "o"]
    for name in ("exact", "fused", "pallas"):
        assert parser().parse_args(files + ["--gl_method", name]).gl_method == name
    with pytest.raises(SystemExit):
        parser().parse_args(files + ["--gl_method", "kernel"])


def test_convert_grid_pallas_is_fused(cli_assets):  # noqa: F811
    d, cfg = cli_assets
    model = load_checkpoint(str(d / "model.ckpt"), cfg.model, "cpu")
    rng = np.random.default_rng(2)
    srcs = [rng.standard_normal((n, 512)).astype(np.float32) for n in (24, 17)]
    tars = [rng.standard_normal((n, 512)).astype(np.float32) for n in (20, 13)]
    out = {}
    for name in ("fused", "pallas"):
        inf = Inferencer(cfg, model, str(d / "attr.pkl"), gl_method=name, device="cpu")
        out[name] = inf.convert_grid(srcs, tars, trim=False)
    for a, b in zip(out["pallas"], out["fused"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="gl_method"):
        Inferencer(cfg, model, str(d / "attr.pkl"), gl_method="kernel", device="cpu")


def test_cli_convert_grid_pallas_writes_the_fused_wavs(cli_assets):  # noqa: F811
    d, _ = cli_assets
    for name in ("fused", "pallas"):
        cli_grid.main([
            "-a", str(d / "attr.pkl"), "-c", str(d / "config.yaml"), "-m", str(d / "model.ckpt"),
            "-s", str(d / "s0.wav"), "-t", str(d / "t0.wav"), str(d / "t1.wav"),
            "-o", str(d / f"alias_{name}"), "--device", "cpu", "--gl_method", name,
        ])
    for j in range(2):
        wav = lambda name: wavfile.read(d / f"alias_{name}" / f"s0__to__t{j}.wav")[1]
        np.testing.assert_array_equal(wav("pallas"), wav("fused"))
