"""Shape helpers (counterpart of nflows_tpu/utils/shapes.py; reference
nflows/utils/torchutils.py:17-56)."""

from __future__ import annotations

import torch

__all__ = ["is_positive_int", "sum_except_batch", "split_leading_dim",
           "merge_leading_dims", "repeat_rows"]


def is_positive_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool) and x > 0


def sum_except_batch(x: torch.Tensor, num_batch_dims: int = 1) -> torch.Tensor:
    """Sum all but the first ``num_batch_dims`` dims."""
    if not isinstance(num_batch_dims, int) or num_batch_dims < 0:
        raise TypeError("Number of batch dimensions must be a non-negative integer.")
    dims = tuple(range(num_batch_dims, x.ndim))
    return x.sum(dim=dims) if dims else x


def split_leading_dim(x: torch.Tensor, shape) -> torch.Tensor:
    """Reshape the leading dim into the given (possibly -1) shape."""
    return x.reshape(*shape, *x.shape[1:])


def merge_leading_dims(x: torch.Tensor, num_dims: int) -> torch.Tensor:
    """Flatten the first ``num_dims`` dims into one."""
    if not is_positive_int(num_dims):
        raise TypeError("Number of leading dims must be a positive integer.")
    if num_dims > x.ndim:
        raise ValueError("Number of leading dims can't be greater than total dims.")
    return x.reshape(-1, *x.shape[num_dims:])


def repeat_rows(x: torch.Tensor, num_reps: int) -> torch.Tensor:
    """Each row of ``x`` repeated ``num_reps`` times contiguously:
    [a, b] -> [a, a, ..., b, b, ...]."""
    if not is_positive_int(num_reps):
        raise TypeError("Number of repetitions must be a positive integer.")
    return torch.repeat_interleave(x, num_reps, dim=0)
