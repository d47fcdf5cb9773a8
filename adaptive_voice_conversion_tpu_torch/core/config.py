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
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

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
class VocoderConfig:
    """The vocoder after the model. ``kind`` "griffin_lim" (the default, and
    the JAX package's only vocoder) reads no other field. "hifigan" is the
    HiFi-GAN V1 generator (Kong et al., arXiv:2010.05646) in
    ParallelWaveGAN's ``HiFiGANGenerator`` layout (models/hifigan.py), at
    24 kHz and hop 300 as that project's VCTK recipe runs it, taking this
    system's 512-channel normalised mel: ``prod(upsample_scales)`` must equal
    ``signal.hop_length``, ``in_channels`` ``signal.n_mels``, and each
    upsampling kernel twice its scale."""

    kind: str = "griffin_lim"
    in_channels: int = 512
    out_channels: int = 1
    channels: int = 512
    kernel_size: int = 7
    upsample_scales: Sequence[int] = (5, 5, 4, 3)
    upsample_kernel_sizes: Sequence[int] = (10, 10, 8, 6)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    negative_slope: float = 0.1


VOCODER_KINDS = ("griffin_lim", "hifigan")


@dataclass(frozen=True)
class VocoderTrainConfig:
    """The ``vocoder_train`` section: HiFi-GAN V1's training job
    (train/vocoder.py), jik876/hifi-gan's ``config_v1.json`` and ``train.py``
    at 24 kHz and hop 300, as ParallelWaveGAN's VCTK recipe runs it.

    The multi-period discriminator has one sub-discriminator per period,
    ``Conv2d`` over (samples / period, period) with kernel
    (``mpd_kernel_size``, 1), the channels and strides listed, then
    ``conv_post`` (``post_kernel_size``, 1) to one channel. The multi-scale
    discriminator has ``msd_scales`` sub-discriminators, each on the wav
    average-pooled once more than the last (``AvgPool1d(4, 2, padding=2)``),
    with the ``Conv1d`` channels, kernels, strides and groups listed (padding
    (k - 1) // 2), then ``conv_post``; its first sub-discriminator takes
    spectral norm where ``msd_spectral_norm_first``, every other convolution
    weight norm. Losses are least squares, plus ``lambda_fm`` x feature
    matching and ``lambda_mel`` x the L1 of the log mels. Each network has
    its own AdamW (decoupled weight decay, no clipping), its lr times
    ``lr_decay`` once an epoch. A step takes ``batch_size`` segments of
    ``segment_samples`` samples at frame-aligned starts."""

    batch_size: int = 16
    segment_samples: int = 8400
    mpd_periods: Sequence[int] = (2, 3, 5, 7, 11)
    mpd_channels: Sequence[int] = (32, 128, 512, 1024, 1024)
    mpd_strides: Sequence[int] = (3, 3, 3, 3, 1)
    mpd_kernel_size: int = 5
    msd_scales: int = 3
    msd_channels: Sequence[int] = (128, 128, 256, 512, 1024, 1024, 1024)
    msd_kernel_sizes: Sequence[int] = (15, 41, 41, 41, 41, 41, 5)
    msd_strides: Sequence[int] = (1, 2, 2, 4, 4, 1, 1)
    msd_groups: Sequence[int] = (1, 4, 16, 16, 16, 16, 1)
    msd_spectral_norm_first: bool = True
    post_kernel_size: int = 3
    negative_slope: float = 0.1
    lambda_adv: float = 1.0
    lambda_fm: float = 2.0
    lambda_mel: float = 45.0
    lr: float = 2e-4
    betas: Sequence[float] = (0.8, 0.99)
    eps: float = 1e-8
    weight_decay: float = 0.01
    lr_decay: float = 0.999


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
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    # the vocoder's training job; None where the config has no such section
    vocoder_train: Optional[VocoderTrainConfig] = None
    # training-side knobs, every one read by train/ and data/:
    # compute_dtype, opt_state_dtype and opt_fused by the step and the
    # optimiser; data_dtype, input_mode, device_data_budget_bytes,
    # chunk_bytes, chunk_repeats and inner_steps by the Solver's data modes
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


def _parse_vocoder(raw: dict, signal: SignalConfig) -> VocoderConfig:
    """The ``vocoder`` section; absent, Griffin-Lim. Raises on an unknown
    kind and on a generator that does not fit the signal."""
    kw = _filter_kwargs(VocoderConfig, raw)
    if "resblock_dilations" in kw:
        kw["resblock_dilations"] = tuple(tuple(d) for d in kw["resblock_dilations"])
    voc = VocoderConfig(**kw)
    if voc.kind not in VOCODER_KINDS:
        raise ValueError(f"config vocoder.kind={voc.kind!r}: expected one of {VOCODER_KINDS}")
    if voc.kind == "hifigan":
        hop = math.prod(voc.upsample_scales)
        if hop != signal.hop_length or voc.in_channels != signal.n_mels:
            raise ValueError(
                f"config vocoder: upsample_scales {list(voc.upsample_scales)} give hop {hop} and "
                f"in_channels is {voc.in_channels}; the signal has hop_length "
                f"{signal.hop_length} and n_mels {signal.n_mels}")
        if list(voc.upsample_kernel_sizes) != [2 * s for s in voc.upsample_scales]:
            raise ValueError("config vocoder: each upsample kernel size must be twice its scale")
        if len(voc.resblock_dilations) != len(voc.resblock_kernel_sizes):
            raise ValueError("config vocoder: one dilation list per residual block kernel size")
    return voc


def _parse_vocoder_train(raw: Optional[dict], signal: SignalConfig) -> Optional[VocoderTrainConfig]:
    """The ``vocoder_train`` section; absent, None."""
    if raw is None:
        return None
    vt = VocoderTrainConfig(**_filter_kwargs(VocoderTrainConfig, raw))
    if vt.segment_samples % signal.hop_length:
        raise ValueError(f"config vocoder_train.segment_samples={vt.segment_samples} is not a "
                         f"multiple of the hop {signal.hop_length}")
    if len(vt.mpd_strides) != len(vt.mpd_channels):
        raise ValueError("config vocoder_train: one mpd stride per mpd channel count")
    if not len(vt.msd_channels) == len(vt.msd_kernel_sizes) == len(vt.msd_strides) == len(vt.msd_groups):
        raise ValueError("config vocoder_train: one msd kernel size, stride and group count per channel count")
    return vt


def config_from_dict(raw: dict) -> TrainConfig:
    """Build a TrainConfig from a reference-format config dict."""
    signal = SignalConfig(**_filter_kwargs(SignalConfig, raw.get("signal", {})))
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
        signal=signal,
        vocoder=_parse_vocoder(raw.get("vocoder", {}), signal),
        vocoder_train=_parse_vocoder_train(raw.get("vocoder_train"), signal),
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
    """Dump back to the reference-compatible YAML schema; the ``vocoder``
    section only where it is not Griffin-Lim."""

    def plain(v):
        return [plain(x) for x in v] if isinstance(v, (tuple, list)) else v

    def asdict(dc):
        return {k: plain(v) for k, v in dataclasses.asdict(dc).items()}

    out = {
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
    if cfg.vocoder.kind != "griffin_lim":
        out["vocoder"] = asdict(cfg.vocoder)
    if cfg.vocoder_train is not None:
        out["vocoder_train"] = asdict(cfg.vocoder_train)
    return out


def load_config(path: str) -> TrainConfig:
    with open(path) as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw or {})


def save_config(cfg: TrainConfig, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=False)
