"""Bin-lookup helpers shared by the plain spline code
(counterpart of nflows_tpu/ops/binning.py).

The JAX package selects bin parameters with a one-hot multiply-reduce,
because a gather along a short trailing axis lowers poorly on the TPU.
PyTorch has a cheap ``gather``, so the port finds the bin index with the
same sum-of-ge rule and gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["bin_index", "select_bin", "normalize_bins", "pad_zero_left",
           "edges_on", "unit_knots", "softplus"]


def bin_index(bin_edges: torch.Tensor, inputs: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Index of the bin holding each input: [...] int64 in [0, K-1].

    ``bin_edges`` is [..., K+1] and monotone. The top edge is nudged up by
    ``eps`` so an input equal to the right boundary lands in the last bin
    (reference torchutils.searchsorted)."""
    num_bins = bin_edges.shape[-1] - 1
    edges = torch.cat([bin_edges[..., :-1], bin_edges[..., -1:] + eps], dim=-1)
    ge = (inputs[..., None] >= edges).sum(dim=-1) - 1
    return ge.clamp(0, num_bins - 1)


def select_bin(params: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``params[..., idx]`` per element: params [..., K], idx [...]."""
    return torch.gather(params, -1, idx[..., None])[..., 0]


def normalize_bins(unnormalized: torch.Tensor, num_bins: int,
                   min_size: float) -> torch.Tensor:
    """softmax + minimum-size floor (reference splines/*.py)."""
    return min_size + (1.0 - min_size * num_bins) * torch.softmax(unnormalized, dim=-1)


def pad_zero_left(x: torch.Tensor) -> torch.Tensor:
    """Prepend a zero along the last axis."""
    return F.pad(x, (1, 0))


def edges_on(unnormalized: torch.Tensor, num_bins: int, min_size: float,
             lo: float, hi: float):
    """Bin sizes [..., K] and cumulative edges [..., K+1] on [lo, hi] from
    unnormalised sizes, both endpoints pinned (reference splines/*.py)."""
    sizes = normalize_bins(unnormalized, num_bins, min_size)
    cum = pad_zero_left(torch.cumsum(sizes, dim=-1))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum[..., 1:] - cum[..., :-1], cum


def unit_knots(sizes: torch.Tensor) -> torch.Tensor:
    """Knots [..., K+1] on [0, 1] from bin sizes [..., K] that sum to 1:
    running sums with the last pinned to exactly 1, zero prepended."""
    cum = torch.cumsum(sizes, dim=-1)
    return pad_zero_left(
        torch.cat([cum[..., :-1], torch.ones_like(cum[..., -1:])], dim=-1))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jnp.logaddexp(x, 0)`` computes it (no
    threshold, unlike ``F.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
