"""Binary masks for coupling layers (counterpart of
nflows_tpu/utils/masks.py; reference nflows/utils/torchutils.py:59-70)."""

from __future__ import annotations

import numpy as np

__all__ = ["create_alternating_binary_mask"]


def create_alternating_binary_mask(features: int, even: bool = True) -> np.ndarray:
    """Checkerboard mask: 1s on even (or odd) indices."""
    if not isinstance(features, int) or isinstance(features, bool) or features <= 0:
        raise TypeError("Number of features must be a positive integer.")
    mask = np.zeros(features, dtype=np.float32)
    mask[(0 if even else 1)::2] = 1.0
    return mask
