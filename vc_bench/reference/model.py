"""Plain AdaIN-VC (Chou et al., Interspeech 2019), written from the reference
``model.py`` of jjery2243542/adaptive_voice_conversion.

Functional PyTorch on (B, C, T) activations over a dict of tensors keyed
by the reference checkpoint's names (``speaker_encoder.conv_bank.0.weight``,
``decoder.conv_affine_layers.3.bias``, ...). No kernel, cache or batching
of the program under test: every layer is ``F.conv1d`` / ``F.linear`` after
the reference's reflect padding (``pad_layer``), in the order the reference
runs them. With ``Decoder.sn`` a decoder layer holds ``weight_orig`` and the
stored power-iteration vector ``weight_u``; its weight is ``weight_orig /
sigma`` after one power iteration, as ``torch.nn.utils.spectral_norm``
computes it in training mode.

``make_params`` draws a checkpoint from a seed on the device. The benchmark
hands the same tensors to the program (``load_state_dict``) and to this
reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def bank_sizes(enc: dict) -> List[int]:
    return list(range(enc["bank_scale"], enc["bank_size"] + 1, enc["bank_scale"]))


def param_shapes(model: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every weight and bias of a configuration (the keys
    SpeakerEncoder, ContentEncoder and Decoder), in the reference's module
    order. A spectral-norm decoder layer's weight is named ``weight_orig``."""
    out: List[Tuple[str, tuple]] = []

    def conv(name, c_in, c_out, k):
        out.append((f"{name}.weight", (c_out, c_in, k)))
        out.append((f"{name}.bias", (c_out,)))

    def dense(name, c_in, c_out):
        out.append((f"{name}.weight", (c_out, c_in)))
        out.append((f"{name}.bias", (c_out,)))

    for enc_name in ("SpeakerEncoder", "ContentEncoder"):
        e = model[enc_name]
        pre = "speaker_encoder" if enc_name == "SpeakerEncoder" else "content_encoder"
        ks = bank_sizes(e)
        for i, k in enumerate(ks):
            conv(f"{pre}.conv_bank.{i}", e["c_in"], e["c_bank"], k)
        conv(f"{pre}.in_conv_layer", e["c_bank"] * len(ks) + e["c_in"], e["c_h"], 1)
        for l in range(e["n_conv_blocks"]):
            conv(f"{pre}.first_conv_layers.{l}", e["c_h"], e["c_h"], e["kernel_size"])
        for l in range(e["n_conv_blocks"]):
            conv(f"{pre}.second_conv_layers.{l}", e["c_h"], e["c_h"], e["kernel_size"])
        if enc_name == "SpeakerEncoder":
            for l in range(e["n_dense_blocks"]):
                dense(f"{pre}.first_dense_layers.{l}", e["c_h"], e["c_h"])
            for l in range(e["n_dense_blocks"]):
                dense(f"{pre}.second_dense_layers.{l}", e["c_h"], e["c_h"])
            dense(f"{pre}.output_layer", e["c_h"], e["c_out"])
        else:
            conv(f"{pre}.mean_layer", e["c_h"], e["c_out"], 1)
            conv(f"{pre}.std_layer", e["c_h"], e["c_out"], 1)
    d = model["Decoder"]
    start = len(out)
    conv("decoder.in_conv_layer", d["c_in"], d["c_h"], 1)
    for l in range(d["n_conv_blocks"]):
        conv(f"decoder.first_conv_layers.{l}", d["c_h"], d["c_h"], d["kernel_size"])
    for l, up in enumerate(d["upsample"][: d["n_conv_blocks"]]):
        conv(f"decoder.second_conv_layers.{l}", d["c_h"], d["c_h"] * up, d["kernel_size"])
    for l in range(2 * d["n_conv_blocks"]):
        dense(f"decoder.conv_affine_layers.{l}", d["c_cond"], d["c_h"] * 2)
    conv("decoder.out_conv_layer", d["c_h"], d["c_out"], 1)
    if d.get("sn"):
        out[start:] = [
            (n.replace(".weight", ".weight_orig"), s) if n.endswith(".weight") else (n, s)
            for n, s in out[start:]
        ]
    return out


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm().clamp_min(1e-12)


def make_params(model: dict, seed: int, device) -> Params:
    """A checkpoint drawn from ``seed`` on ``device`` in two large draws:
    every weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (PyTorch's
    default for Conv1d and Linear), and with spectral norm every layer's
    ``weight_u`` (a unit normal vector) and ``weight_v`` (W^T u, normalised)."""
    shapes = param_shapes(model)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out: Params = {}
    fan_in = 1
    for (name, shape), part in zip(shapes, flat.split(sizes)):
        if name.endswith("weight") or name.endswith("weight_orig"):
            fan_in = math.prod(shape[1:])
        out[name] = part.view(shape).mul(1.0 / math.sqrt(fan_in))
    sn = [n[: -len(".weight_orig")] for n, _ in shapes if n.endswith(".weight_orig")]
    if sn:
        rows = [out[f"{n}.weight_orig"].shape[0] for n in sn]
        us = torch.randn(sum(rows), generator=gen, device=device).split(rows)
        for n, u in zip(sn, us):
            u = _normalize(u)
            out[f"{n}.weight_u"] = u
            out[f"{n}.weight_v"] = _normalize(out[f"{n}.weight_orig"].reshape(u.shape[0], -1).t() @ u)
    return out


class Net:
    """The reference forward over ``params``. ``dtype`` casts the weights
    and the input (the lower-precision control); the default keeps f32.
    With spectral norm, ``new_u`` collects each layer's advanced vector
    (one power iteration from the stored ``weight_u``), which the training
    step stores after the optimiser has run."""

    def __init__(self, cfg: dict, params: Params, dtype: Optional[torch.dtype] = None):
        self.model = cfg
        self.p = params
        self.dtype = dtype
        self.new_u: Dict[str, torch.Tensor] = {}

    def _w(self, name: str) -> torch.Tensor:
        if f"{name}.weight_orig" in self.p:
            w = self.p[f"{name}.weight_orig"]
            wm = w.reshape(w.shape[0], -1)
            with torch.no_grad():
                v = _normalize(wm.t() @ self.p[f"{name}.weight_u"])
                u = _normalize(wm @ v)
            self.new_u[name] = u
            w = w / torch.dot(u, wm @ v)
        else:
            w = self.p[f"{name}.weight"]
        return w if self.dtype is None else w.to(self.dtype)

    def _b(self, name: str) -> torch.Tensor:
        b = self.p[f"{name}.bias"]
        return b if self.dtype is None else b.to(self.dtype)

    def conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        w = self._w(name)
        k = w.shape[-1]
        pad = (k // 2, k // 2 - 1) if k % 2 == 0 else (k // 2, k // 2)
        if pad != (0, 0):
            x = F.pad(x, pad, mode="reflect")
        return F.conv1d(x, w, self._b(name), stride=stride)

    def dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.linear(x, self._w(name), self._b(name))

    @staticmethod
    def norm(x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, eps=1e-5)

    @staticmethod
    def act(x: torch.Tensor, name: str) -> torch.Tensor:
        return F.leaky_relu(x, 0.01) if name == "lrelu" else F.relu(x)

    def bank(self, x: torch.Tensor, pre: str, e: dict) -> torch.Tensor:
        outs = [self.act(self.conv(x, f"{pre}.conv_bank.{i}"), e["act"])
                for i in range(len(bank_sizes(e)))]
        return torch.cat(outs + [x], dim=1)

    def speaker_encoder(self, x: torch.Tensor) -> torch.Tensor:
        e, pre = self.model["SpeakerEncoder"], "speaker_encoder"
        a = lambda y: self.act(y, e["act"])
        out = a(self.conv(self.bank(x, pre, e), f"{pre}.in_conv_layer"))
        for l in range(e["n_conv_blocks"]):
            sub = e["subsample"][l]
            y = a(self.conv(out, f"{pre}.first_conv_layers.{l}"))
            y = a(self.conv(y, f"{pre}.second_conv_layers.{l}", stride=sub))
            if sub > 1:
                out = F.avg_pool1d(out, kernel_size=sub, ceil_mode=True)
            out = y + out
        out = out.mean(dim=2)
        for l in range(e["n_dense_blocks"]):
            y = a(self.dense(out, f"{pre}.first_dense_layers.{l}"))
            out = a(self.dense(y, f"{pre}.second_dense_layers.{l}")) + out
        return self.dense(out, f"{pre}.output_layer")

    def content_encoder(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        e, pre = self.model["ContentEncoder"], "content_encoder"
        a = lambda y: self.act(y, e["act"])
        out = a(self.norm(self.conv(self.bank(x, pre, e), f"{pre}.in_conv_layer")))
        for l in range(e["n_conv_blocks"]):
            sub = e["subsample"][l]
            y = a(self.norm(self.conv(out, f"{pre}.first_conv_layers.{l}")))
            y = a(self.norm(self.conv(y, f"{pre}.second_conv_layers.{l}", stride=sub)))
            if sub > 1:
                out = F.avg_pool1d(out, kernel_size=sub, ceil_mode=True)
            out = y + out
        return self.conv(out, f"{pre}.mean_layer"), self.conv(out, f"{pre}.std_layer")

    def decoder(self, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        d, pre = self.model["Decoder"], "decoder"
        a = lambda y: self.act(y, d["act"])

        def affine(y, l):
            c = self.dense(cond, f"{pre}.conv_affine_layers.{l}")
            half = c.shape[1] // 2
            return y * c[:, half:, None] + c[:, :half, None]

        out = a(self.norm(self.conv(z, f"{pre}.in_conv_layer")))
        for l in range(d["n_conv_blocks"]):
            up = d["upsample"][l]
            y = a(affine(self.norm(self.conv(out, f"{pre}.first_conv_layers.{l}")), 2 * l))
            y = self.conv(y, f"{pre}.second_conv_layers.{l}")
            if up > 1:  # the reference's pixel_shuffle_1d
                b, c, t = y.shape
                y = y.view(b, c // up, up, t).permute(0, 1, 3, 2).reshape(b, c // up, t * up)
            y = a(affine(self.norm(y), 2 * l + 1))
            out = y + (F.interpolate(out, scale_factor=up, mode="nearest") if up > 1 else out)
        return self.conv(out, f"{pre}.out_conv_layer")

    def inference(self, src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
        """Normalised mels (T, C) and (T_c, C) -> the converted mel (T', C)."""
        cast = (lambda m: m) if self.dtype is None else (lambda m: m.to(self.dtype))
        emb = self.speaker_encoder(cast(tar).t()[None])
        mu, _ = self.content_encoder(cast(src).t()[None])
        return self.decoder(mu, emb)[0].t().float()
