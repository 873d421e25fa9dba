"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); else the given device.

    Never falls back to the CPU quietly: a caller that wants the CPU says so.
    Also pins float32 matmuls and convolutions to full float32 (no TF32), so
    distance rankings and distortions keep float32 precision on the card.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def as_f32(X, device: torch.device) -> torch.Tensor:
    """``X`` (array-like or tensor) as a contiguous float32 tensor on device."""
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.array(X, dtype=np.float32))   # owned copy
    return X.to(device=device, dtype=torch.float32).contiguous()


def to_device(t, device: torch.device) -> torch.Tensor:
    """Copy a host tensor (or array) to ``device`` without a host sync.

    A plain host-to-device copy from pageable memory blocks the host until
    the device has caught up; staging through pinned memory with
    ``non_blocking=True`` does not (the caching host allocator keeps the
    staging buffer alive until the copy has run).
    """
    t = torch.as_tensor(t)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
