"""Length-masked (ragged-batch) inference through the AdaIN-VC modules.

Mirrors the forward passes of models/modules.py with every length-sensitive
op replaced by its masked variant from ops/masked.py, so one padded batch
of mixed-length utterances gives, per sample, the activations the unmasked
forward gives on that sample alone at its true length. This is what makes
batched ``convert_grid`` serving equal to one-at-a-time conversion.

The functions take the existing ``nn.Module``s and read their layers'
weights: there are no new parameters and no second weight tree. Inference
only, deterministic. Activations are (B, C, T); ``lengths`` is a (B,)
integer tensor on the activations' device.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.masked import (
    avg_pool_time_ceil_masked,
    conv1d_masked,
    conv_bank_masked,
    global_avg_pool_time_masked,
    instance_norm_time_masked,
)
from ..ops.norm import adain
from ..ops.resample import pixel_shuffle_time, upsample_nearest_time
from .ae import AE
from .modules import ContentEncoder, Decoder, SpeakerEncoder, _dense


def _conv(layer, x: torch.Tensor, lengths: torch.Tensor):
    # layer.weight of a spectral-norm layer is its normalised weight
    return conv1d_masked(x, lengths, layer.weight, layer.bias, stride=layer.stride[0])


def _bank(module, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    layers = module.conv_bank
    return conv_bank_masked(
        x, lengths, [c.weight for c in layers], [c.bias for c in layers],
        module.kernel_sizes, module.act,
    )


def speaker_encoder_apply_masked(
    module: SpeakerEncoder, x: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """x (B, c_in, T) + per-sample lengths -> (B, c_out) speaker embeddings,
    each equal to ``module(x_b)`` on the sample at its true length (a masked
    global pool takes the place of the padded AdaptiveAvgPool1d)."""
    act = module.act
    out = _bank(module, x, lengths)
    out = act(_conv(module.in_conv_layer, out, lengths)[0])
    lens = lengths
    for first, second in zip(module.first_conv_layers, module.second_conv_layers):
        y = act(_conv(first, out, lens)[0])
        y, y_lens = _conv(second, y, lens)
        y = act(y)
        out, _ = avg_pool_time_ceil_masked(out, lens, second.stride[0])
        out = y + out
        lens = y_lens
    out = global_avg_pool_time_masked(out, lens)
    for first, second in zip(module.first_dense_layers, module.second_dense_layers):
        out = act(_dense(second, act(_dense(first, out)))) + out
    return _dense(module.output_layer, out)


def content_encoder_apply_masked(
    module: ContentEncoder, x: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (mu, log_sigma, content_lengths); a sample's content length
    is ceil(L / prod(subsample)). Masked instance norm takes the place of
    the padded statistics."""
    act = module.act
    out = _bank(module, x, lengths)
    out = act(instance_norm_time_masked(_conv(module.in_conv_layer, out, lengths)[0], lengths))
    lens = lengths
    for first, second in zip(module.first_conv_layers, module.second_conv_layers):
        y = act(instance_norm_time_masked(_conv(first, out, lens)[0], lens))
        # the strided conv pads at the input's lengths; the norm after it
        # runs at the lengths it returns
        y, y_lens = _conv(second, y, lens)
        y = act(instance_norm_time_masked(y, y_lens))
        out, _ = avg_pool_time_ceil_masked(out, lens, second.stride[0])
        out = y + out
        lens = y_lens
    mu, _ = _conv(module.mean_layer, out, lens)
    log_sigma, _ = _conv(module.std_layer, out, lens)
    return mu, log_sigma, lens


def decoder_apply_masked(
    module: Decoder, z: torch.Tensor, cond: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (B, c_in, T_c) + content lengths -> (dec, out_lengths); a sample's
    output length is L_c * prod(upsample)."""
    act = module.act
    out = act(instance_norm_time_masked(_conv(module.in_conv_layer, z, lengths)[0], lengths))
    lens = lengths
    for l, up in enumerate(module.cfg.upsample[: module.cfg.n_conv_blocks]):
        y = instance_norm_time_masked(_conv(module.first_conv_layers[l], out, lens)[0], lens)
        y = act(adain(y, _dense(module.conv_affine_layers[2 * l], cond)))
        y, _ = _conv(module.second_conv_layers[l], y, lens)
        if up > 1:
            y = pixel_shuffle_time(y, up)
            lens = lens * up
        y = instance_norm_time_masked(y, lens)
        y = act(adain(y, _dense(module.conv_affine_layers[2 * l + 1], cond)))
        out = y + (upsample_nearest_time(out, up) if up > 1 else out)
    return _conv(module.out_conv_layer, out, lens)[0], lens


def ae_inference_masked(
    ae: AE,
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    x_cond: torch.Tensor,
    cond_lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged-batch one-shot conversion on (B, T, C) mels, as ``AE.inference``.

    Returns (dec, dec_lengths): dec (B, T_out, n_mels) whose first
    dec_lengths[b] = ceil(x_lengths[b] / 8) * 8 frames of sample b (at the
    shipped 8x subsample) equal ``ae.inference`` on the pair alone at its
    true lengths.
    """
    emb = speaker_encoder_apply_masked(
        ae.speaker_encoder, x_cond.transpose(1, 2), cond_lengths
    )
    mu, _, c_lens = content_encoder_apply_masked(
        ae.content_encoder, x.transpose(1, 2), x_lengths
    )
    dec, dec_lens = decoder_apply_masked(ae.decoder, mu, emb, c_lens)
    return dec.transpose(1, 2), dec_lens
