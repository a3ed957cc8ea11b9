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
    AdditiveCouplingTransform,
    AffineCouplingTransform,
    CouplingTransform,
    PiecewiseCouplingTransform,
    PiecewiseCubicCouplingTransform,
    PiecewiseLinearCouplingTransform,
    PiecewiseLinearRationalCouplingTransform,
    PiecewiseQuadraticCouplingTransform,
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
    "CouplingTransform", "AffineCouplingTransform", "AdditiveCouplingTransform",
    "PiecewiseCouplingTransform",
    "PiecewiseLinearCouplingTransform", "PiecewiseQuadraticCouplingTransform",
    "PiecewiseCubicCouplingTransform", "PiecewiseRationalQuadraticCouplingTransform",
    "PiecewiseLinearRationalCouplingTransform",
    "AutoregressiveTransform", "MaskedAffineAutoregressiveTransform",
    "MaskedPiecewiseRationalQuadraticAutoregressiveTransform",
]
