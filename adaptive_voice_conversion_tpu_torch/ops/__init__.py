"""Model building blocks on (B, C, T) activations, PyTorch's conv layout.

The JAX package keeps activations channels-last (B, T, C); the tests
transpose at their boundary. Weights use PyTorch's layouts: conv
(C_out, C_in, K), dense (C_out, C_in).
"""

from .padding import reflect_pad_time, conv_pad_amounts
from .conv import conv1d, dense, conv_bank, conv_bank_in, make_fused_bank_weight
from .norm import instance_norm_time, adain, act_fn
from .resample import (
    pixel_shuffle_time,
    upsample_nearest_time,
    avg_pool_time_ceil,
    global_avg_pool_time,
)

__all__ = [
    "reflect_pad_time",
    "conv_pad_amounts",
    "conv1d",
    "dense",
    "conv_bank",
    "conv_bank_in",
    "make_fused_bank_weight",
    "instance_norm_time",
    "adain",
    "act_fn",
    "pixel_shuffle_time",
    "upsample_nearest_time",
    "avg_pool_time_ceil",
    "global_avg_pool_time",
]
