"""Prebuilt models (counterpart of nflows_tpu/models)."""

from nflows_tpu_torch.models.iaf import InverseAutoregressiveFlow
from nflows_tpu_torch.models.nsf import NeuralSplineFlow
from nflows_tpu_torch.models.nsf_ar import NeuralSplineFlowAR

__all__ = ["NeuralSplineFlow", "NeuralSplineFlowAR", "InverseAutoregressiveFlow"]
