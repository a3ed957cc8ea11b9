"""Flows (counterpart of nflows_tpu/flows)."""

from nflows_tpu_torch.flows.autoregressive import MaskedAutoregressiveFlow
from nflows_tpu_torch.flows.base import Flow
from nflows_tpu_torch.flows.realnvp import SimpleRealNVP

__all__ = ["Flow", "MaskedAutoregressiveFlow", "SimpleRealNVP"]
