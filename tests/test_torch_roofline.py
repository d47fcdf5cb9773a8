"""The port's cost model and config writer (utils/roofline.py,
core/config.py::save_config) against the JAX package's: the FLOP, parameter
and byte counts exactly, the peak table's TPU rows unchanged and its H100
row, the MFU arithmetic by hand."""

import dataclasses
from pathlib import Path

import pytest

from adaptive_voice_conversion_tpu.core.config import TrainConfig as JTrainConfig
from adaptive_voice_conversion_tpu.core.config import load_config as jload_config
from adaptive_voice_conversion_tpu.core.config import save_config as jsave_config
from adaptive_voice_conversion_tpu.utils import roofline as jroof
from adaptive_voice_conversion_tpu_torch.core.config import TrainConfig, load_config, save_config
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.utils import roofline

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = str(REPO / "examples" / "config.yaml")
H100 = "NVIDIA H100 80GB HBM3"


def configs():
    return {
        "default": (TrainConfig(), JTrainConfig()),
        "example": (load_config(EXAMPLE), jload_config(EXAMPLE)),
    }


@pytest.mark.parametrize("name", ["default", "example"])
def test_costs_equal_jax(name):
    cfg, jcfg = configs()[name]
    for b, t in ((1, 128), (128, 128), (3, 77)):
        assert roofline.ae_forward_flops(cfg.model, b, t) == jroof.ae_forward_flops(jcfg.model, b, t)
    assert roofline.param_count(cfg.model) == jroof.param_count(jcfg.model)
    assert roofline.train_step_cost(cfg) == jroof.train_step_cost(jcfg)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    jbf16 = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    assert roofline.train_step_cost(bf16, 8, 64) == jroof.train_step_cost(jbf16, 8, 64)


def test_param_count_is_the_port_models():
    cfg = load_config(EXAMPLE)
    n = sum(p.numel() for p in AE(cfg.model).parameters())
    assert roofline.param_count(cfg.model) == n == 9_040_512


def test_device_spec():
    spec = roofline.device_spec(H100)
    assert spec == roofline.DeviceSpec("NVIDIA H100 SXM", 989.4e12, 3.35e12)
    assert roofline.device_spec("nvidia h100") == spec
    for kind in ("TPU v5 lite", "TPU v5e", "TPU v5p", "TPU v6 lite", "TPU v4"):
        ours, ref = roofline.device_spec(kind), jroof.device_spec(kind)
        assert (ours.name, ours.peak_flops_bf16, ours.hbm_gbps) == (
            ref.name, ref.peak_flops_bf16, ref.hbm_gbps)
    assert roofline.device_spec("cpu") is None


def test_mfu_and_roofline_by_hand():
    cfg = load_config(EXAMPLE)
    cost = roofline.train_step_cost(cfg)
    step_s = 0.05
    out = roofline.mfu_and_roofline(cfg, step_s, H100)
    flops, nbytes = cost["flops_total"], cost["hbm_bytes_est"]
    assert flops == 3 * cost["flops_forward"]
    assert out["achieved_tflops"] == pytest.approx(flops / step_s / 1e12, rel=1e-12)
    assert out["mfu"] == pytest.approx(flops / 0.05 / 989.4e12, rel=1e-12)
    assert out["hbm_utilization"] == pytest.approx(nbytes / 0.05 / 3.35e12, rel=1e-12)
    t_compute, t_memory = flops / 989.4e12, nbytes / 3.35e12
    assert out["roofline_bound"] == ("compute" if t_compute >= t_memory else "memory") == "compute"
    assert out["speed_of_light_ms"] == pytest.approx(max(t_compute, t_memory) * 1e3, rel=1e-12)
    assert out["device"] == "NVIDIA H100 SXM"
    # an unknown device: the costs and the achieved rate, no MFU
    cpu = roofline.mfu_and_roofline(cfg, step_s, "cpu")
    assert "mfu" not in cpu and cpu["achieved_tflops"] == out["achieved_tflops"]


def test_save_config_writes_the_jax_file(tmp_path):
    cfg, jcfg = configs()["example"]
    save_config(cfg, str(tmp_path / "port.yaml"))
    jsave_config(jcfg, str(tmp_path / "jax.yaml"))
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    assert load_config(str(tmp_path / "port.yaml")) == cfg
