"""Typed configuration, the port's own copy of the JAX package's schema.

Same dataclasses, same YAML schema (the reference ``config.yaml`` keys
SpeakerEncoder / ContentEncoder / Decoder / data_loader / optimizer /
lambda / annealing_iters, plus ``signal`` and the JAX package's extra
top-level knobs), so one config file loads field-for-field identically in
both packages. Kept as a copy because importing the JAX package's ``core``
pulls in jax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence

import yaml


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    c_in: int = 512
    c_h: int = 128
    c_out: int = 128
    kernel_size: int = 5
    bank_size: int = 8
    bank_scale: int = 1
    c_bank: int = 128
    n_conv_blocks: int = 6
    n_dense_blocks: int = 6
    subsample: Sequence[int] = (1, 2, 1, 2, 1, 2)
    act: str = "relu"
    dropout_rate: float = 0.0


@dataclass(frozen=True)
class ContentEncoderConfig:
    c_in: int = 512
    c_h: int = 128
    c_out: int = 128
    kernel_size: int = 5
    bank_size: int = 8
    bank_scale: int = 1
    c_bank: int = 128
    n_conv_blocks: int = 6
    subsample: Sequence[int] = (1, 2, 1, 2, 1, 2)
    act: str = "relu"
    dropout_rate: float = 0.0


@dataclass(frozen=True)
class DecoderConfig:
    c_in: int = 128
    c_cond: int = 128
    c_h: int = 128
    c_out: int = 512
    kernel_size: int = 5
    n_conv_blocks: int = 6
    upsample: Sequence[int] = (2, 1, 2, 1, 2, 1)
    act: str = "relu"
    sn: bool = False
    dropout_rate: float = 0.0


@dataclass(frozen=True)
class DataLoaderConfig:
    segment_size: int = 128
    frame_size: int = 1
    batch_size: int = 128
    shuffle: bool = True


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.999
    amsgrad: bool = True
    weight_decay: float = 1e-4
    grad_norm: float = 5.0


@dataclass(frozen=True)
class LambdaConfig:
    lambda_rec: float = 10.0
    lambda_kl: float = 1.0


@dataclass(frozen=True)
class SignalConfig:
    """Signal constants (n_fft 2048, hop 12.5 ms, window 50 ms at 24 kHz)."""

    sr: int = 24000
    n_fft: int = 2048
    hop_length: int = 300
    win_length: int = 1200
    n_mels: int = 512
    n_iter: int = 100  # Griffin-Lim iterations
    preemphasis: float = 0.97
    max_db: float = 100.0
    ref_db: float = 20.0
    top_db: float = 15.0


@dataclass(frozen=True)
class AEConfig:
    speaker_encoder: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)
    content_encoder: ContentEncoderConfig = field(default_factory=ContentEncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)


@dataclass(frozen=True)
class TrainConfig:
    model: AEConfig = field(default_factory=AEConfig)
    data_loader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loss: LambdaConfig = field(default_factory=LambdaConfig)
    annealing_iters: int = 20000
    signal: SignalConfig = field(default_factory=SignalConfig)
    # training-side knobs: compute_dtype, data_dtype, input_mode,
    # opt_state_dtype and opt_fused are read by train/; the rest belong to
    # the data modes that are not ported yet and are carried so that a
    # config file round-trips field for field
    compute_dtype: str = "float32"
    data_dtype: str = "float32"
    input_mode: str = "auto"
    device_data_budget_bytes: int = 6_000_000_000
    chunk_bytes: int = 0
    chunk_repeats: object = 1
    inner_steps: int = 10
    opt_state_dtype: str = "float32"
    opt_fused: object = False


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    out = {k: v for k, v in d.items() if k in names}
    for k, v in out.items():
        if isinstance(v, list):
            out[k] = tuple(v)
    return out


def _parse_opt_fused(v):
    """bool, 0/1, or "bucketed<K>" with K >= 1; anything else raises."""
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return bool(v)
    if isinstance(v, str) and v.startswith("bucketed"):
        tail = v[len("bucketed"):]
        if tail == "" or (tail.isdigit() and int(tail) >= 1):
            return v
    raise ValueError(
        f"config opt_fused={v!r}: expected false, true, or 'bucketed<K>' "
        f"with K >= 1"
    )


def _parse_chunk_repeats(v):
    """int >= 1 or the literal "auto"; anything else raises."""
    if isinstance(v, str):
        if v == "auto":
            return v
        raise ValueError(
            f"config chunk_repeats={v!r}: expected an int >= 1 or 'auto'"
        )
    iv = int(v)
    if iv < 1:
        raise ValueError(
            f"config chunk_repeats={v!r}: expected an int >= 1 or 'auto'"
        )
    return iv


def config_from_dict(raw: dict) -> TrainConfig:
    """Build a TrainConfig from a reference-format config dict."""
    model = AEConfig(
        speaker_encoder=SpeakerEncoderConfig(
            **_filter_kwargs(SpeakerEncoderConfig, raw.get("SpeakerEncoder", {}))
        ),
        content_encoder=ContentEncoderConfig(
            **_filter_kwargs(ContentEncoderConfig, raw.get("ContentEncoder", {}))
        ),
        decoder=DecoderConfig(**_filter_kwargs(DecoderConfig, raw.get("Decoder", {}))),
    )
    return TrainConfig(
        model=model,
        data_loader=DataLoaderConfig(
            **_filter_kwargs(DataLoaderConfig, raw.get("data_loader", {}))
        ),
        optimizer=OptimizerConfig(
            **_filter_kwargs(OptimizerConfig, raw.get("optimizer", {}))
        ),
        loss=LambdaConfig(**_filter_kwargs(LambdaConfig, raw.get("lambda", {}))),
        annealing_iters=int(raw.get("annealing_iters", 20000)),
        signal=SignalConfig(**_filter_kwargs(SignalConfig, raw.get("signal", {}))),
        compute_dtype=str(raw.get("compute_dtype", "float32")),
        data_dtype=str(raw.get("data_dtype", "float32")),
        input_mode=str(raw.get("input_mode", "auto")),
        device_data_budget_bytes=int(
            raw.get("device_data_budget_bytes", 6_000_000_000)
        ),
        chunk_bytes=int(raw.get("chunk_bytes", 0)),
        chunk_repeats=_parse_chunk_repeats(raw.get("chunk_repeats", 1)),
        inner_steps=int(raw.get("inner_steps", 10)),
        opt_state_dtype=str(raw.get("opt_state_dtype", "float32")),
        opt_fused=_parse_opt_fused(raw.get("opt_fused", False)),
    )


def config_to_dict(cfg: TrainConfig) -> dict:
    """Dump back to the reference-compatible YAML schema."""

    def asdict(dc):
        d = dataclasses.asdict(dc)
        return {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}

    return {
        "SpeakerEncoder": asdict(cfg.model.speaker_encoder),
        "ContentEncoder": asdict(cfg.model.content_encoder),
        "Decoder": asdict(cfg.model.decoder),
        "data_loader": asdict(cfg.data_loader),
        "optimizer": asdict(cfg.optimizer),
        "lambda": asdict(cfg.loss),
        "annealing_iters": cfg.annealing_iters,
        "signal": asdict(cfg.signal),
        "compute_dtype": cfg.compute_dtype,
        "data_dtype": cfg.data_dtype,
        "input_mode": cfg.input_mode,
        "device_data_budget_bytes": cfg.device_data_budget_bytes,
        "chunk_bytes": cfg.chunk_bytes,
        "chunk_repeats": cfg.chunk_repeats,
        "inner_steps": cfg.inner_steps,
        "opt_state_dtype": cfg.opt_state_dtype,
        "opt_fused": cfg.opt_fused,
    }


def load_config(path: str) -> TrainConfig:
    with open(path) as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw or {})


def save_config(cfg: TrainConfig, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=False)
