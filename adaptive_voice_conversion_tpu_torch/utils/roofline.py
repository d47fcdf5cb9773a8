"""Analytic FLOP / HBM-byte accounting for the AdaIN-VC training step.

Gives an MFU and roofline figure for a measured step time: every conv and
dense layer in the three modules is counted analytically from the config,
backward FLOPs use the standard 2x-forward rule (one matmul each for dgrad
and wgrad), and HBM traffic is estimated from parameter and optimizer-state
movement plus materialized conv activations. The cost model is the JAX
package's, value for value.

Peak-rate table (public data sheets), matched by a substring of the device's
name (``torch.cuda.get_device_name()`` on the card):
  H100 SXM  989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3 (NVIDIA H100 data sheet)
  TPU v5e   197 TFLOP/s bf16,  819 GB/s HBM
  TPU v4    275 TFLOP/s bf16, 1228 GB/s
  TPU v5p   459 TFLOP/s bf16, 2765 GB/s
  TPU v6e   918 TFLOP/s bf16, 1640 GB/s
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..core.config import AEConfig, TrainConfig


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _conv_flops(b: int, t_out: int, k: int, c_in: int, c_out: int) -> int:
    """Forward MACs*2 of a length-``t_out``-output 1D conv."""
    return 2 * b * t_out * k * c_in * c_out


def _dense_flops(b: int, c_in: int, c_out: int) -> int:
    return 2 * b * c_in * c_out


def _bank_kernel_sizes(cfg) -> list:
    return list(range(cfg.bank_scale, cfg.bank_size + 1, cfg.bank_scale))


def speaker_encoder_flops(cfg, b: int, t: int) -> Dict[str, int]:
    ks = _bank_kernel_sizes(cfg)
    out: Dict[str, int] = {}
    out["conv_bank"] = sum(_conv_flops(b, t, k, cfg.c_in, cfg.c_bank) for k in ks)
    c_cat = cfg.c_bank * len(ks) + cfg.c_in
    out["in_conv"] = _conv_flops(b, t, 1, c_cat, cfg.c_h)
    blocks = 0
    t_l = t
    for sub in cfg.subsample[: cfg.n_conv_blocks]:
        blocks += _conv_flops(b, t_l, cfg.kernel_size, cfg.c_h, cfg.c_h)
        t_l = _ceil_div(t_l, sub)
        blocks += _conv_flops(b, t_l, cfg.kernel_size, cfg.c_h, cfg.c_h)
    out["conv_blocks"] = blocks
    out["dense"] = (
        2 * cfg.n_dense_blocks * _dense_flops(b, cfg.c_h, cfg.c_h)
        + _dense_flops(b, cfg.c_h, cfg.c_out)
    )
    return out


def content_encoder_flops(cfg, b: int, t: int) -> Dict[str, int]:
    ks = _bank_kernel_sizes(cfg)
    out: Dict[str, int] = {}
    out["conv_bank"] = sum(_conv_flops(b, t, k, cfg.c_in, cfg.c_bank) for k in ks)
    c_cat = cfg.c_bank * len(ks) + cfg.c_in
    out["in_conv"] = _conv_flops(b, t, 1, c_cat, cfg.c_h)
    blocks = 0
    t_l = t
    for sub in cfg.subsample[: cfg.n_conv_blocks]:
        blocks += _conv_flops(b, t_l, cfg.kernel_size, cfg.c_h, cfg.c_h)
        t_l = _ceil_div(t_l, sub)
        blocks += _conv_flops(b, t_l, cfg.kernel_size, cfg.c_h, cfg.c_h)
    out["conv_blocks"] = blocks
    out["mu_std"] = 2 * _conv_flops(b, t_l, 1, cfg.c_h, cfg.c_out)
    return out


def decoder_flops(cfg, b: int, t_in: int) -> Dict[str, int]:
    out: Dict[str, int] = {}
    out["in_conv"] = _conv_flops(b, t_in, 1, cfg.c_in, cfg.c_h)
    blocks = 0
    affine = 0
    t_l = t_in
    for up in cfg.upsample[: cfg.n_conv_blocks]:
        blocks += _conv_flops(b, t_l, cfg.kernel_size, cfg.c_h, cfg.c_h)
        blocks += _conv_flops(b, t_l, cfg.kernel_size, cfg.c_h, cfg.c_h * up)
        affine += 2 * _dense_flops(b, cfg.c_cond, cfg.c_h * 2)
        t_l = t_l * up
    out["conv_blocks"] = blocks
    out["adain_affine"] = affine
    out["out_conv"] = _conv_flops(b, t_l, 1, cfg.c_h, cfg.c_out)
    return out


def ae_forward_flops(cfg: AEConfig, b: int, t: int) -> Dict[str, object]:
    """Forward FLOPs of one ae_forward (models/ae.py) at batch b, seg len t."""
    se = speaker_encoder_flops(cfg.speaker_encoder, b, t)
    ce = content_encoder_flops(cfg.content_encoder, b, t)
    sub_prod = 1
    for s in cfg.content_encoder.subsample[: cfg.content_encoder.n_conv_blocks]:
        sub_prod *= s
    de = decoder_flops(cfg.decoder, b, _ceil_div(t, sub_prod))
    total = sum(se.values()) + sum(ce.values()) + sum(de.values())
    by_class = {
        "conv_bank": se["conv_bank"] + ce["conv_bank"],
        "in_conv": se["in_conv"] + ce["in_conv"],
        "residual_convs": se["conv_blocks"] + ce["conv_blocks"] + de["conv_blocks"],
        "pointwise_out": ce["mu_std"] + de["in_conv"] + de["out_conv"],
        "dense": se["dense"] + de["adain_affine"],
    }
    return {
        "total": total,
        "speaker_encoder": se,
        "content_encoder": ce,
        "decoder": de,
        "by_class": by_class,
    }


def param_count(cfg: AEConfig) -> int:
    def conv_p(k, ci, co):
        return k * ci * co + co

    def dense_p(ci, co):
        return ci * co + co

    n = 0
    for mcfg, has_dense in (
        (cfg.speaker_encoder, True),
        (cfg.content_encoder, False),
    ):
        ks = _bank_kernel_sizes(mcfg)
        n += sum(conv_p(k, mcfg.c_in, mcfg.c_bank) for k in ks)
        n += conv_p(1, mcfg.c_bank * len(ks) + mcfg.c_in, mcfg.c_h)
        n += 2 * mcfg.n_conv_blocks * conv_p(mcfg.kernel_size, mcfg.c_h, mcfg.c_h)
        # strided second convs widen nothing; handled above
        if has_dense:
            n += 2 * mcfg.n_dense_blocks * dense_p(mcfg.c_h, mcfg.c_h)
            n += dense_p(mcfg.c_h, mcfg.c_out)
        else:
            n += 2 * conv_p(1, mcfg.c_h, mcfg.c_out)
    d = cfg.decoder
    n += conv_p(1, d.c_in, d.c_h)
    for up in d.upsample[: d.n_conv_blocks]:
        n += conv_p(d.kernel_size, d.c_h, d.c_h)
        n += conv_p(d.kernel_size, d.c_h, d.c_h * up)
        n += 2 * dense_p(d.c_cond, d.c_h * 2)
    n += conv_p(1, d.c_h, d.c_out)
    return n


def _conv_act_elems(cfg: AEConfig, b: int, t: int) -> int:
    """Elements of materialized conv/dense outputs in one forward pass."""
    elems = 0

    def enc(mcfg):
        nonlocal elems
        ks = _bank_kernel_sizes(mcfg)
        elems += b * t * (mcfg.c_bank * len(ks) + mcfg.c_in)  # bank concat
        elems += b * t * mcfg.c_h
        t_l = t
        for sub in mcfg.subsample[: mcfg.n_conv_blocks]:
            elems += b * t_l * mcfg.c_h
            t_l = _ceil_div(t_l, sub)
            elems += b * t_l * mcfg.c_h
        return t_l

    enc(cfg.speaker_encoder)
    t_c = enc(cfg.content_encoder)
    elems += 2 * b * t_c * cfg.content_encoder.c_out  # mu, log_sigma
    d = cfg.decoder
    t_l = t_c
    elems += b * t_l * d.c_h
    for up in d.upsample[: d.n_conv_blocks]:
        elems += b * t_l * d.c_h
        elems += b * t_l * d.c_h * up
        t_l = t_l * up
    elems += b * t_l * d.c_out
    return elems


def train_step_cost(
    cfg: TrainConfig, b: Optional[int] = None, t: Optional[int] = None
) -> Dict[str, object]:
    """FLOPs + estimated HBM bytes for ONE optimizer step (fwd+bwd+update)."""
    b = b or cfg.data_loader.batch_size
    t = t or cfg.data_loader.segment_size
    fwd = ae_forward_flops(cfg.model, b, t)
    n_params = param_count(cfg.model)
    flops_fwd = int(fwd["total"])
    flops_bwd = 2 * flops_fwd  # dgrad + wgrad matmuls
    act_bytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    # params: read (fwd) + read (bwd wgrad) + write (update), f32 master
    # opt state (Adam amsgrad): m, v, vhat read+write; grads write+read
    param_traffic = n_params * 4 * (3 + 6 + 2)
    # conv activations: fwd write + bwd read + dgrad write (x3)
    act_traffic = _conv_act_elems(cfg.model, b, t) * act_bytes * 3
    batch_bytes = b * t * cfg.model.content_encoder.c_in * act_bytes
    return {
        "batch": b,
        "segment": t,
        "n_params": n_params,
        "flops_forward": flops_fwd,
        "flops_backward": flops_bwd,
        "flops_total": flops_fwd + flops_bwd,
        "flops_by_class": {k: 3 * v for k, v in fwd["by_class"].items()},
        "hbm_bytes_est": param_traffic + act_traffic + batch_bytes,
        "hbm_bytes_params": param_traffic,
        "hbm_bytes_activations": act_traffic,
    }


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops_bf16: float
    hbm_gbps: float


_SPECS = (
    ("h100", DeviceSpec("NVIDIA H100 SXM", 989.4e12, 3.35e12)),
    ("v5 lite", DeviceSpec("TPU v5e", 197e12, 819e9)),
    ("v5e", DeviceSpec("TPU v5e", 197e12, 819e9)),
    ("v5p", DeviceSpec("TPU v5p", 459e12, 2765e9)),
    ("v6 lite", DeviceSpec("TPU v6e", 918e12, 1640e9)),
    ("v6e", DeviceSpec("TPU v6e", 918e12, 1640e9)),
    ("v4", DeviceSpec("TPU v4", 275e12, 1228e9)),
)


def device_spec(device_kind: str) -> Optional[DeviceSpec]:
    kind = device_kind.lower()
    for key, spec in _SPECS:
        if key in kind:
            return spec
    return None


def mfu_and_roofline(
    cfg: TrainConfig, step_seconds: float, device_kind: str
) -> Dict[str, object]:
    """MFU + HBM-utilization for a measured per-step wall time."""
    cost = train_step_cost(cfg)
    spec = device_spec(device_kind)
    out = dict(cost)
    out["step_seconds"] = step_seconds
    out["achieved_tflops"] = cost["flops_total"] / step_seconds / 1e12
    if spec is not None:
        out["device"] = spec.name
        out["mfu"] = cost["flops_total"] / step_seconds / spec.peak_flops_bf16
        out["hbm_utilization"] = (
            cost["hbm_bytes_est"] / step_seconds / spec.hbm_gbps
        )
        # roofline: which bound is tighter at this intensity
        t_compute = cost["flops_total"] / spec.peak_flops_bf16
        t_memory = cost["hbm_bytes_est"] / spec.hbm_gbps
        out["roofline_bound"] = "compute" if t_compute >= t_memory else "memory"
        out["speed_of_light_ms"] = max(t_compute, t_memory) * 1e3
    return out
