"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A request
for ``cuda`` on a host without a visible GPU raises: the port never carries
on silently on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for and absent.

    Under a process group (core/mesh.py) a rank is one GPU: ``None`` and a
    bare ``cuda`` resolve to ``cuda:LOCAL_RANK`` (torchrun's variable);
    a device with an index stays as it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def set_precision(precision: Optional[str]) -> None:
    """Map the serving ``precision`` knob onto PyTorch's TF32 switches.

    ``None``/``"default"`` leave PyTorch's defaults (f32 matmuls exact,
    cuDNN convolutions in TF32). ``"high"`` allows TF32 for both.
    ``"highest"`` turns TF32 off for both, so every f32 matmul and
    convolution keeps full f32 precision.
    """
    if precision not in (None, "default", "high", "highest"):
        raise ValueError(
            f"precision={precision!r}: expected None/'default'/'high'/'highest'"
        )
    if precision in (None, "default"):
        return
    allow = precision == "high"
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
