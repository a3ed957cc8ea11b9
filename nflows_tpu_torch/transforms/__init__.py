"""Transforms (counterpart of nflows_tpu/transforms)."""

from nflows_tpu_torch.transforms.autoregressive import (
    AutoregressiveTransform,
    MaskedAffineAutoregressiveTransform,
    MaskedPiecewiseRationalQuadraticAutoregressiveTransform,
)
from nflows_tpu_torch.transforms.base import (
    CompositeTransform,
    InputOutsideDomain,
    InverseNotAvailable,
    InverseTransform,
    Transform,
)
from nflows_tpu_torch.transforms.coupling import (
    CouplingTransform,
    PiecewiseCouplingTransform,
    PiecewiseRationalQuadraticCouplingTransform,
)
from nflows_tpu_torch.transforms.permutations import (
    Permutation,
    RandomPermutation,
    ReversePermutation,
)

__all__ = [
    "Transform", "CompositeTransform", "InverseTransform",
    "InverseNotAvailable", "InputOutsideDomain",
    "Permutation", "RandomPermutation", "ReversePermutation",
    "CouplingTransform", "PiecewiseCouplingTransform",
    "PiecewiseRationalQuadraticCouplingTransform",
    "AutoregressiveTransform", "MaskedAffineAutoregressiveTransform",
    "MaskedPiecewiseRationalQuadraticAutoregressiveTransform",
]
