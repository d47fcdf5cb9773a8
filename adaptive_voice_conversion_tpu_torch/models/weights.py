"""Weights: reference-format checkpoints and the JAX parameter tree.

A reference ``.ckpt`` is a ``torch.save``d state_dict whose keys are the
module tree of ``models/modules.py``, so loading one is
``load_state_dict(strict=True)``. ``state_dict_from_jax_params`` is the
port's own copy of the JAX package's exporter mapping: it turns the JAX
parameter tree, as numpy arrays, into that state_dict (conv (K, I, O) ->
(O, I, K), dense (I, O) -> (O, I)); ``jax_params_from_state_dict`` is its
inverse. Parameters and spectral-norm vectors cross; optimiser state does
not.

A HiFi-GAN generator checkpoint (ParallelWaveGAN's layout, models/hifigan.py)
holds its convolutions weight-normed, as ``weight_g`` / ``weight_v``:
``load_generator`` folds each pair into the plain ``weight`` the layer
computes, ``g v / ||v||``, at load.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.config import AEConfig, VocoderConfig
from ..core.device import DeviceLike, resolve_device
from .ae import AE
from .hifigan import Generator


def _put(sd: dict, name: str, p: dict, w: np.ndarray) -> None:
    """One layer: ``weight`` and ``bias``, or for a spectral-norm layer
    (its JAX dict carries ``u``) ``weight_orig``, ``bias``, ``weight_u`` and
    the derived ``weight_v`` = W^T u normalised."""
    w = np.ascontiguousarray(w)
    if "u" in p:
        u = np.array(p["u"], np.float32)
        v = w.reshape(w.shape[0], -1).T @ u
        sd[f"{name}.weight_orig"] = torch.from_numpy(w)
        sd[f"{name}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))
        sd[f"{name}.weight_u"] = torch.from_numpy(u)
        sd[f"{name}.weight_v"] = torch.from_numpy(
            (v / (np.linalg.norm(v) + 1e-12)).astype(np.float32)
        )
    else:
        sd[f"{name}.weight"] = torch.from_numpy(w)
        sd[f"{name}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))


def _conv(sd: dict, name: str, p: dict) -> None:
    _put(sd, name, p, np.asarray(p["w"], np.float32).transpose(2, 1, 0))


def _dense(sd: dict, name: str, p: dict) -> None:
    _put(sd, name, p, np.asarray(p["w"], np.float32).T)


def _layer_names(cfg: AEConfig):
    """(state_dict prefix, path into the JAX tree, is_conv) for every layer,
    in the exporter's order."""
    out = []
    se, ce, de = cfg.speaker_encoder, cfg.content_encoder, cfg.decoder
    for mod, c in (("speaker_encoder", se), ("content_encoder", ce)):
        n_bank = len(range(c.bank_scale, c.bank_size + 1, c.bank_scale))
        out += [(f"{mod}.conv_bank.{i}", (mod, "conv_bank", i), True) for i in range(n_bank)]
        out.append((f"{mod}.in_conv_layer", (mod, "in_conv"), True))
        for l in range(c.n_conv_blocks):
            out.append((f"{mod}.first_conv_layers.{l}", (mod, "conv_blocks", l, "first"), True))
            out.append((f"{mod}.second_conv_layers.{l}", (mod, "conv_blocks", l, "second"), True))
        if mod == "speaker_encoder":
            for l in range(c.n_dense_blocks):
                out.append((f"{mod}.first_dense_layers.{l}", (mod, "dense_blocks", l, "first"), False))
                out.append((f"{mod}.second_dense_layers.{l}", (mod, "dense_blocks", l, "second"), False))
            out.append((f"{mod}.output_layer", (mod, "output"), False))
        else:
            out.append((f"{mod}.mean_layer", (mod, "mean"), True))
            out.append((f"{mod}.std_layer", (mod, "std"), True))
    out.append(("decoder.in_conv_layer", ("decoder", "in_conv"), True))
    for l in range(de.n_conv_blocks):
        blk = ("decoder", "conv_blocks", l)
        out.append((f"decoder.first_conv_layers.{l}", blk + ("first",), True))
        out.append((f"decoder.second_conv_layers.{l}", blk + ("second",), True))
        out.append((f"decoder.conv_affine_layers.{2 * l}", blk + ("affine1",), False))
        out.append((f"decoder.conv_affine_layers.{2 * l + 1}", blk + ("affine2",), False))
    out.append(("decoder.out_conv_layer", ("decoder", "out_conv"), True))
    return out


def state_dict_from_jax_params(params: dict, cfg: AEConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state_dict (CPU f32).
    An ``sn=True`` tree's ``w`` / ``u`` become ``weight_orig`` / ``weight_u``."""
    sd: dict = {}
    for name, path, is_conv in _layer_names(cfg):
        p = params
        for key in path:
            p = p[key]
        (_conv if is_conv else _dense)(sd, name, p)
    return sd


def jax_params_from_state_dict(sd: Dict[str, torch.Tensor], cfg: AEConfig) -> dict:
    """The inverse: the port's state_dict -> the JAX tree's layout and names
    with numpy leaves (conv (O, I, K) -> (K, I, O), dense (O, I) -> (I, O);
    ``weight_orig`` / ``weight_u`` -> ``w`` / ``u``; ``weight_v`` has no
    place in the tree and is dropped)."""
    def leaf(name: str, is_conv: bool) -> dict:
        sn = f"{name}.weight_orig" in sd
        w = sd[f"{name}.weight_orig" if sn else f"{name}.weight"].detach().cpu().float().numpy()
        out = {
            "w": np.ascontiguousarray(w.transpose(2, 1, 0) if is_conv else w.T),
            "b": sd[f"{name}.bias"].detach().cpu().float().numpy().copy(),
        }
        if sn:
            out["u"] = sd[f"{name}.weight_u"].detach().cpu().float().numpy().copy()
        return out

    tree: dict = {}
    for name, path, is_conv in _layer_names(cfg):
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append([] if isinstance(nxt, int) else {})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        last = path[-1]
        if isinstance(last, int):
            assert len(node) == last
            node.append(leaf(name, is_conv))
        else:
            node[last] = leaf(name, is_conv)
    return tree


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


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each ``<layer>.weight_g`` / ``<layer>.weight_v`` pair -> ``<layer>.weight``
    = g v / ||v||, the norm over every dimension but the first (the default
    ``dim=0`` of ``torch.nn.utils.weight_norm``); other keys pass through."""
    out = {k: v for k, v in sd.items() if not k.endswith((".weight_g", ".weight_v"))}
    for k in sd:
        if k.endswith(".weight_g"):
            name = k[: -len("_g")]
            if f"{name}_v" not in sd:
                raise KeyError(f"{k} has no {name}_v")
            out[name] = torch._weight_norm(sd[f"{name}_v"], sd[k], 0)
    return out


def load_generator(path: str, cfg: VocoderConfig, device: DeviceLike = None) -> Generator:
    """A HiFi-GAN generator checkpoint -> a ``Generator`` in eval mode on
    ``device`` (default ``cuda``). The file is a state_dict, or a
    ParallelWaveGAN training checkpoint (``{"model": {"generator": ...}}``);
    weight norm is folded, and the keys must match exactly."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict) and "generator" in sd["model"]:
        sd = sd["model"]["generator"]
    gen = Generator(cfg)
    gen.load_state_dict(fold_weight_norm(sd), strict=True)
    return gen.to(resolve_device(device)).eval()

