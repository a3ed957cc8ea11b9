"""Flows (counterpart of nflows_tpu/flows)."""

from nflows_tpu_torch.flows.autoregressive import MaskedAutoregressiveFlow
from nflows_tpu_torch.flows.base import Flow

__all__ = ["Flow", "MaskedAutoregressiveFlow"]
