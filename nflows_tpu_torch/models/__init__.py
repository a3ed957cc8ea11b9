"""Prebuilt models (counterpart of nflows_tpu/models)."""

from nflows_tpu_torch.models.nsf import NeuralSplineFlow

__all__ = ["NeuralSplineFlow"]
