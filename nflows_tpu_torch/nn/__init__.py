"""Conditioner building blocks (counterpart of nflows_tpu/nn)."""

from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.nn.primitives import Dense, Dropout, glu

__all__ = ["nets", "Dense", "Dropout", "glu"]
