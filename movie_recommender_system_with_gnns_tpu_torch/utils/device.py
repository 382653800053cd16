"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a GPU
and without an explicit ``device="cpu"`` they raise: a run that was meant for
the card never quietly carries on on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the port's plain PyTorch path on the host")
    return dev


def as_dtype(dtype: Optional[Union[str, torch.dtype]]) -> Optional[torch.dtype]:
    """``"bfloat16"`` / ``"float32"`` / a torch dtype / None -> torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out
