"""Alias of the reference's module path nflows/transforms/UMNN/MonotonicNormalizer.py."""

from nflows_tpu_torch.transforms.umnn import IntegrandNet, MonotonicNormalizer  # noqa: F401
