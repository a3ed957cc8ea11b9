"""Linear-algebra helpers of the linear transforms (counterpart of
nflows_tpu/utils/linalg.py:39-56; reference nflows/utils/torchutils.py:103-122).

Plain PyTorch: ``torch.linalg`` on the tensor's device, as the JAX package
leaves these to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from nflows_tpu_torch.nn.primitives import default_generator

__all__ = ["logabsdet", "random_orthogonal"]


def logabsdet(x: torch.Tensor) -> torch.Tensor:
    """log|det x| via slogdet."""
    return torch.linalg.slogdet(x).logabsdet


def random_orthogonal(size: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Haar-random orthogonal [size, size] matrix on the CPU: the Q of a
    Gaussian matrix's QR drawn from ``generator`` (None = fresh seed), its
    columns' signs fixed by the signs of R's diagonal."""
    x = torch.randn(size, size, generator=default_generator(generator))
    q, r = torch.linalg.qr(x)
    d = torch.sign(torch.diagonal(r))
    return q * d[None, :]
