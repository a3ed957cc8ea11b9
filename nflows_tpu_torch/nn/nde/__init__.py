"""Neural density estimators (counterpart of nflows_tpu/nn/nde; reference
nflows/nn/nde/__init__.py)."""

from nflows_tpu_torch.nn.nde.made import MixtureOfGaussiansMADE

__all__ = ["MixtureOfGaussiansMADE"]
