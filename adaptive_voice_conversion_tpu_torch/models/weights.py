"""Weights: reference-format checkpoints and the JAX parameter tree.

A reference ``.ckpt`` is a ``torch.save``d state_dict whose keys are the
module tree of ``models/modules.py``, so loading one is
``load_state_dict(strict=True)``. ``state_dict_from_jax_params`` is the
port's own copy of the JAX package's exporter mapping: it turns the JAX
parameter tree, as numpy arrays, into that state_dict (conv (K, I, O) ->
(O, I, K), dense (I, O) -> (O, I)).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.config import AEConfig
from ..core.device import DeviceLike, resolve_device
from .ae import AE


def _conv(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(p["w"], np.float32).transpose(2, 1, 0))
    )
    sd[f"{name}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))


def _dense(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(p["w"], np.float32).T)
    )
    sd[f"{name}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))


def state_dict_from_jax_params(params: dict, cfg: AEConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state_dict (CPU f32)."""
    if cfg.decoder.sn:
        raise NotImplementedError("sn=True parameters are not ported yet")
    sd: dict = {}
    se = params["speaker_encoder"]
    for i, p in enumerate(se["conv_bank"]):
        _conv(sd, f"speaker_encoder.conv_bank.{i}", p)
    _conv(sd, "speaker_encoder.in_conv_layer", se["in_conv"])
    for l, blk in enumerate(se["conv_blocks"]):
        _conv(sd, f"speaker_encoder.first_conv_layers.{l}", blk["first"])
        _conv(sd, f"speaker_encoder.second_conv_layers.{l}", blk["second"])
    for l, blk in enumerate(se["dense_blocks"]):
        _dense(sd, f"speaker_encoder.first_dense_layers.{l}", blk["first"])
        _dense(sd, f"speaker_encoder.second_dense_layers.{l}", blk["second"])
    _dense(sd, "speaker_encoder.output_layer", se["output"])

    ce = params["content_encoder"]
    for i, p in enumerate(ce["conv_bank"]):
        _conv(sd, f"content_encoder.conv_bank.{i}", p)
    _conv(sd, "content_encoder.in_conv_layer", ce["in_conv"])
    for l, blk in enumerate(ce["conv_blocks"]):
        _conv(sd, f"content_encoder.first_conv_layers.{l}", blk["first"])
        _conv(sd, f"content_encoder.second_conv_layers.{l}", blk["second"])
    _conv(sd, "content_encoder.mean_layer", ce["mean"])
    _conv(sd, "content_encoder.std_layer", ce["std"])

    de = params["decoder"]
    _conv(sd, "decoder.in_conv_layer", de["in_conv"])
    for l, blk in enumerate(de["conv_blocks"]):
        _conv(sd, f"decoder.first_conv_layers.{l}", blk["first"])
        _conv(sd, f"decoder.second_conv_layers.{l}", blk["second"])
        _dense(sd, f"decoder.conv_affine_layers.{2 * l}", blk["affine1"])
        _dense(sd, f"decoder.conv_affine_layers.{2 * l + 1}", blk["affine2"])
    _conv(sd, "decoder.out_conv_layer", de["out_conv"])
    return sd


def load_checkpoint(path: str, cfg: AEConfig, device: DeviceLike = None) -> AE:
    """A reference-format ``.ckpt`` -> an ``AE`` in eval mode on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    model = AE(cfg)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def save_checkpoint(model: AE, path: str) -> None:
    """Write the model's state_dict as a reference-format ``.ckpt``."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
