"""Transforms (counterpart of nflows_tpu/transforms)."""

from nflows_tpu_torch.transforms.autoregressive import (
    AutoregressiveTransform,
    MaskedAffineAutoregressiveTransform,
    MaskedPiecewiseCubicAutoregressiveTransform,
    MaskedPiecewiseLinearAutoregressiveTransform,
    MaskedPiecewiseLinearRationalAutoregressiveTransform,
    MaskedPiecewiseQuadraticAutoregressiveTransform,
    MaskedPiecewiseRationalQuadraticAutoregressiveTransform,
    MaskedUMNNAutoregressiveTransform,
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
    UMNNCouplingTransform,
)
from nflows_tpu_torch.transforms.linear import Linear, NaiveLinear, precompute_linear_caches
from nflows_tpu_torch.transforms.lu import LULinear
from nflows_tpu_torch.transforms.nonlinearities import (
    CauchyCDF,
    CauchyCDFInverse,
    CompositeCDFTransform,
    Exp,
    GatedLinearUnit,
    LeakyReLU,
    Logit,
    LogTanh,
    PiecewiseCubicCDF,
    PiecewiseLinearCDF,
    PiecewiseLinearRationalCDF,
    PiecewiseQuadraticCDF,
    PiecewiseRationalQuadraticCDF,
    Sigmoid,
    Tanh,
)
from nflows_tpu_torch.transforms.normalization import ActNorm, BatchNorm
from nflows_tpu_torch.transforms.orthogonal import HouseholderSequence
from nflows_tpu_torch.transforms.permutations import (
    Permutation,
    RandomPermutation,
    ReversePermutation,
)
from nflows_tpu_torch.transforms.qr import QRLinear
from nflows_tpu_torch.transforms.svd import SVDLinear
from nflows_tpu_torch.transforms.umnn import IntegrandNet, MonotonicNormalizer

__all__ = [
    "Transform", "CompositeTransform", "InverseTransform",
    "InverseNotAvailable", "InputOutsideDomain",
    "Permutation", "RandomPermutation", "ReversePermutation",
    "CouplingTransform", "AffineCouplingTransform", "AdditiveCouplingTransform",
    "PiecewiseCouplingTransform",
    "PiecewiseLinearCouplingTransform", "PiecewiseQuadraticCouplingTransform",
    "PiecewiseCubicCouplingTransform", "PiecewiseRationalQuadraticCouplingTransform",
    "PiecewiseLinearRationalCouplingTransform", "UMNNCouplingTransform",
    "AutoregressiveTransform", "MaskedAffineAutoregressiveTransform",
    "MaskedPiecewiseLinearAutoregressiveTransform",
    "MaskedPiecewiseQuadraticAutoregressiveTransform",
    "MaskedPiecewiseCubicAutoregressiveTransform",
    "MaskedPiecewiseRationalQuadraticAutoregressiveTransform",
    "MaskedPiecewiseLinearRationalAutoregressiveTransform",
    "MaskedUMNNAutoregressiveTransform",
    "Exp", "Tanh", "LogTanh", "LeakyReLU", "Sigmoid", "Logit", "GatedLinearUnit",
    "CauchyCDF", "CauchyCDFInverse", "CompositeCDFTransform",
    "PiecewiseLinearCDF", "PiecewiseQuadraticCDF", "PiecewiseCubicCDF",
    "PiecewiseRationalQuadraticCDF", "PiecewiseLinearRationalCDF",
    "IntegrandNet", "MonotonicNormalizer",
    "Linear", "NaiveLinear", "precompute_linear_caches", "LULinear", "QRLinear",
    "SVDLinear", "HouseholderSequence", "BatchNorm", "ActNorm",
]
