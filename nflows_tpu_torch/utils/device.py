"""Device selection for the port's entry points.

Entry points run on the card unless the caller names another device.
With no device given and no CUDA present they raise: the port never
carries on quietly on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``cuda``, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} was asked for but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
