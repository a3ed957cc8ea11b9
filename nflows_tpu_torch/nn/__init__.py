"""Conditioner building blocks (counterpart of nflows_tpu/nn)."""

from nflows_tpu_torch.nn import made, nde, nets
from nflows_tpu_torch.nn.made import MADE, MaskedDense
from nflows_tpu_torch.nn.nde import MixtureOfGaussiansMADE
from nflows_tpu_torch.nn.primitives import Dense, Dropout, glu

__all__ = ["made", "nde", "nets", "Dense", "Dropout", "glu", "MADE", "MaskedDense",
           "MixtureOfGaussiansMADE"]
