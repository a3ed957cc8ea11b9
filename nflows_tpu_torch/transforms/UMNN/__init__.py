"""The reference's import path (nflows/transforms/UMNN/__init__.py):
``from nflows_tpu_torch.transforms.UMNN import MonotonicNormalizer,
IntegrandNet``. The implementation is the native Clenshaw-Curtis
quadrature of nflows_tpu_torch/transforms/umnn.py."""

from nflows_tpu_torch.transforms.umnn import IntegrandNet, MonotonicNormalizer

__all__ = ["MonotonicNormalizer", "IntegrandNet"]
