"""Invertible elementwise nonlinearities and learned-CDF transforms
(counterpart of nflows_tpu/transforms/nonlinearities.py; reference
nflows/transforms/nonlinearities.py).

Piecewise maps are full-width ``torch.where`` selects with each branch's
operand made safe, so nothing turns NaN in the values or the gradients.
Where the reference raises on an input outside the domain, the JAX package
clamps (``Exp.inverse`` at the smallest normal number, ``Tanh`` and
``CauchyCDF`` at 1e-7, ``Sigmoid`` at ``eps``), and so does the port.

The learned CDFs keep one parameter row a feature (``[*shape, P]``,
``nn.Parameter``s under the JAX leaf names) and share it across the batch
by an ``expand``. With ``tails="linear"`` the spline is the family's
linear-tail dispatch (``ops/splines``): on a CUDA tensor its kernel, B1 for
the rational-quadratic CDF and B5, B6, B7, B8 for the linear-rational,
linear, quadratic and cubic ones, which the dispatch hands a dense
``[N, F, P]`` copy of the expanded rows. The bounded splines
(``tails=None``) and the elementwise nonlinearities are plain PyTorch on
the card as well: the JAX package runs them outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.ops import splines
from nflows_tpu_torch.ops.binning import softplus
from nflows_tpu_torch.transforms.base import (
    CompositeTransform,
    InverseTransform,
    Transform,
)
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = [
    "Exp", "Tanh", "LogTanh", "LeakyReLU", "Sigmoid", "Logit",
    "GatedLinearUnit", "CauchyCDF", "CauchyCDFInverse", "CompositeCDFTransform",
    "PiecewiseLinearCDF", "PiecewiseQuadraticCDF", "PiecewiseCubicCDF",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseLinearRationalCDF",
]

_sum = shapeutils.sum_except_batch


class Exp(Transform):
    """y = exp(x) (reference nonlinearities.py:18-32)."""

    def forward(self, inputs, context=None):
        return torch.exp(inputs), _sum(inputs)

    def inverse(self, inputs, context=None):
        outputs = torch.log(inputs.clamp(min=torch.finfo(inputs.dtype).tiny))
        return outputs, -_sum(outputs)


class Tanh(Transform):
    """(reference nonlinearities.py:35-48)."""

    def forward(self, inputs, context=None):
        outputs = torch.tanh(inputs)
        return outputs, _sum(torch.log1p(-outputs ** 2))

    def inverse(self, inputs, context=None):
        eps = 1e-7
        x = inputs.clamp(-1 + eps, 1 - eps)
        outputs = 0.5 * torch.log((1 + x) / (1 - x))
        return outputs, _sum(-torch.log1p(-x ** 2))


class LogTanh(Transform):
    """Tanh core with alpha log(beta x) tails beyond |x| > cut_point,
    matched in value and derivative (reference nonlinearities.py:51-113)."""

    def __init__(self, cut_point: float = 1.0):
        super().__init__()
        if cut_point <= 0:
            raise ValueError("Cut point must be positive.")
        self.cut_point = float(cut_point)
        self.inv_cut_point = float(np.tanh(cut_point))
        self.alpha = float((1 - np.tanh(np.tanh(cut_point))) / cut_point)
        self.beta = float(np.exp(
            (np.tanh(cut_point) - self.alpha * np.log(cut_point)) / self.alpha))

    def forward(self, inputs, context=None):
        mask_right = inputs > self.cut_point
        mask_left = inputs < -self.cut_point
        tanh_out = torch.tanh(inputs)
        safe_right = torch.where(mask_right, inputs, torch.ones_like(inputs))
        safe_left = torch.where(mask_left, inputs, -torch.ones_like(inputs))
        right_out = self.alpha * torch.log(self.beta * safe_right)
        left_out = -self.alpha * torch.log(-self.beta * safe_left)
        outputs = torch.where(mask_right, right_out,
                              torch.where(mask_left, left_out, tanh_out))
        lad_mid = torch.log1p(-tanh_out.clamp(-1 + 1e-7, 1 - 1e-7) ** 2)
        lad_right = torch.log(self.alpha / safe_right)
        lad_left = torch.log(-self.alpha / safe_left)
        logabsdet = torch.where(mask_right, lad_right,
                                torch.where(mask_left, lad_left, lad_mid))
        return outputs, _sum(logabsdet)

    def inverse(self, inputs, context=None):
        mask_right = inputs > self.inv_cut_point
        mask_left = inputs < -self.inv_cut_point
        safe_mid = inputs.clamp(-self.inv_cut_point, self.inv_cut_point)
        mid_out = 0.5 * torch.log((1 + safe_mid) / (1 - safe_mid))
        right_out = torch.exp(inputs / self.alpha) / self.beta
        left_out = -torch.exp(-inputs / self.alpha) / self.beta
        outputs = torch.where(mask_right, right_out,
                              torch.where(mask_left, left_out, mid_out))
        log_ab = float(np.log(self.alpha * self.beta))
        lad_mid = -torch.log1p(-safe_mid ** 2)
        lad_right = -log_ab + inputs / self.alpha
        lad_left = -log_ab - inputs / self.alpha
        logabsdet = torch.where(mask_right, lad_right,
                                torch.where(mask_left, lad_left, lad_mid))
        return outputs, _sum(logabsdet)


class LeakyReLU(Transform):
    """(reference nonlinearities.py:116-136)."""

    def __init__(self, negative_slope: float = 1e-2):
        super().__init__()
        if negative_slope <= 0:
            raise ValueError("Slope must be positive.")
        self.negative_slope = float(negative_slope)

    def forward(self, inputs, context=None):
        outputs = torch.where(inputs >= 0, inputs, self.negative_slope * inputs)
        mask = (inputs < 0).to(inputs.dtype)
        return outputs, _sum(float(np.log(self.negative_slope)) * mask)

    def inverse(self, inputs, context=None):
        outputs = torch.where(inputs >= 0, inputs, inputs / self.negative_slope)
        mask = (inputs < 0).to(inputs.dtype)
        return outputs, _sum(-float(np.log(self.negative_slope)) * mask)


class Sigmoid(Transform):
    """Tempered sigmoid, the temperature fixed or learned (reference
    nonlinearities.py:139-169). A fixed temperature is a plain float, not a
    parameter or a buffer, as in the JAX package (where it is no trainable
    leaf); with ``learn_temperature=True`` it is a [1] parameter
    ``temperature``."""

    def __init__(self, temperature=1.0, eps: float = 1e-6,
                 learn_temperature: bool = False, device=None):
        super().__init__()
        self.eps = eps
        self.learn_temperature = learn_temperature
        if learn_temperature:
            self.temperature = nn.Parameter(
                torch.tensor([float(temperature)], device=device))
        else:
            self.temperature = None
            self.fixed_temperature = float(temperature)

    def _temp(self, like):
        if self.learn_temperature:
            return self.temperature
        return torch.full((1,), self.fixed_temperature, dtype=like.dtype, device=like.device)

    def forward(self, inputs, context=None):
        t = self._temp(inputs)
        z = t * inputs
        return torch.sigmoid(z), _sum(torch.log(t) - softplus(-z) - softplus(z))

    def inverse(self, inputs, context=None):
        t = self._temp(inputs)
        x = inputs.clamp(self.eps, 1 - self.eps)
        outputs = (1 / t) * (torch.log(x) - torch.log1p(-x))
        return outputs, -_sum(torch.log(t) - softplus(-t * outputs) - softplus(t * outputs))


class Logit(InverseTransform):
    """(reference nonlinearities.py:172-174)."""

    def __init__(self, temperature=1.0, eps: float = 1e-6):
        super().__init__(Sigmoid(temperature=temperature, eps=eps))


class GatedLinearUnit(Transform):
    """Context-gated scaling y = x sigmoid(context) (reference
    nonlinearities.py:177-189). The context must be [batch, 1]."""

    def forward(self, inputs, context=None):
        gate = torch.sigmoid(context)
        return inputs * gate, torch.log(gate).reshape(-1)

    def inverse(self, inputs, context=None):
        gate = torch.sigmoid(context)
        return inputs / gate, -torch.log(gate).reshape(-1)


class CauchyCDF(Transform):
    """(reference nonlinearities.py:192-211)."""

    def __init__(self, location=None, scale=None, features=None):
        super().__init__()

    def forward(self, inputs, context=None):
        outputs = (1 / np.pi) * torch.atan(inputs) + 0.5
        return outputs, _sum(-float(np.log(np.pi)) - torch.log1p(inputs ** 2))

    def inverse(self, inputs, context=None):
        eps = 1e-7
        x = inputs.clamp(eps, 1 - eps)
        outputs = torch.tan(np.pi * (x - 0.5))
        return outputs, -_sum(-float(np.log(np.pi)) - torch.log1p(outputs ** 2))


class CauchyCDFInverse(InverseTransform):
    """(reference nonlinearities.py:214-216)."""

    def __init__(self, location=None, scale=None, features=None):
        super().__init__(CauchyCDF(location=location, scale=scale, features=features))


class CompositeCDFTransform(CompositeTransform):
    """squash -> cdf -> unsquash (reference nonlinearities.py:219-223). The
    squashing transform is one module in two places, as in the JAX package."""

    def __init__(self, squashing_transform, cdf_transform):
        super().__init__(
            [squashing_transform, cdf_transform, InverseTransform(squashing_transform)])


def _share_across_batch(params, batch_size):
    return params[None].expand(batch_size, *params.shape)


class _LearnedCDF(Transform):
    """A spline CDF with one trainable parameter row a feature, shared by
    the batch. Subclasses name their parameters (``_PARAMS``) and their
    bounded and linear-tail splines."""

    _PARAMS: tuple = ()

    def __init__(self, tails, tail_bound, **spline_kw):
        super().__init__()
        self.tails = tails
        self.tail_bound = tail_bound
        self.spline_kw = spline_kw

    @staticmethod
    def _shape(shape):
        return (shape,) if isinstance(shape, int) else tuple(shape)

    def _spline(self, inputs, inverse):
        batch_size = inputs.shape[0]
        params = [_share_across_batch(getattr(self, name), batch_size)
                  for name in self._PARAMS]
        if self.tails is None:
            outputs, logabsdet = self._bounded(inputs, *params, inverse=inverse,
                                               **self.spline_kw)
        else:
            outputs, logabsdet = self._unconstrained(
                inputs, *params, inverse=inverse, tails=self.tails,
                tail_bound=self.tail_bound, **self.spline_kw)
        return outputs, _sum(logabsdet)

    def forward(self, inputs, context=None):
        return self._spline(inputs, inverse=False)

    def inverse(self, inputs, context=None):
        return self._spline(inputs, inverse=True)


def _normal(shape, generator, device):
    return nn.Parameter(torch.randn(shape, generator=generator).to(device))


def _uniform(shape, generator, device, low=0.0, high=1.0):
    return nn.Parameter(
        (low + (high - low) * torch.rand(shape, generator=generator)).to(device))


class PiecewiseLinearRationalCDF(_LearnedCDF):
    """Elementwise learned linear-rational-spline CDF (Dolatabadi et al.
    2020, arXiv:2001.05168), beyond the reference library: the LRS
    counterpart of :class:`PiecewiseRationalQuadraticCDF`. With linear
    tails it takes K - 1 derivatives, and on a CUDA tensor runs B5."""

    _PARAMS = ("unnormalized_widths", "unnormalized_heights", "unnormalized_derivatives",
               "unnormalized_lambdas")
    _bounded = staticmethod(splines.linear_rational_spline)
    _unconstrained = staticmethod(splines.unconstrained_linear_rational_spline)

    def __init__(self, shape, num_bins=10, tails=None, tail_bound=1.0,
                 min_bin_width=splines.linear_rational.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.linear_rational.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.linear_rational.DEFAULT_MIN_DERIVATIVE,
                 min_lambda=splines.linear_rational.DEFAULT_MIN_LAMBDA,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(tails, tail_bound, min_bin_width=min_bin_width,
                         min_bin_height=min_bin_height, min_derivative=min_derivative,
                         min_lambda=min_lambda)
        generator = default_generator(generator)
        shape = self._shape(shape)
        num_derivatives = (num_bins - 1) if tails == "linear" else (num_bins + 1)
        self.unnormalized_widths = _uniform((*shape, num_bins), generator, device)
        self.unnormalized_heights = _uniform((*shape, num_bins), generator, device)
        self.unnormalized_derivatives = _uniform((*shape, num_derivatives), generator, device)
        self.unnormalized_lambdas = _uniform((*shape, num_bins), generator, device, -0.5, 0.5)


class PiecewiseLinearCDF(_LearnedCDF):
    """Elementwise linear-spline CDF with per-feature trainable parameters
    shared across the batch (reference nonlinearities.py:230-263). With
    linear tails, on a CUDA tensor, B6."""

    _PARAMS = ("unnormalized_pdf",)
    _bounded = staticmethod(splines.linear_spline)
    _unconstrained = staticmethod(splines.unconstrained_linear_spline)

    def __init__(self, shape, num_bins=10, tails=None, tail_bound=1.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(tails, tail_bound)
        generator = default_generator(generator)
        self.unnormalized_pdf = _normal((*self._shape(shape), num_bins), generator, device)


class PiecewiseQuadraticCDF(_LearnedCDF):
    """(reference nonlinearities.py:266-319). With linear tails it takes
    K - 1 heights, and on a CUDA tensor runs B7."""

    _PARAMS = ("unnormalized_widths", "unnormalized_heights")
    _bounded = staticmethod(splines.quadratic_spline)
    _unconstrained = staticmethod(splines.unconstrained_quadratic_spline)

    def __init__(self, shape, num_bins=10, tails=None, tail_bound=1.0,
                 min_bin_width=splines.quadratic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.quadratic.DEFAULT_MIN_BIN_HEIGHT,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(tails, tail_bound, min_bin_width=min_bin_width,
                         min_bin_height=min_bin_height)
        generator = default_generator(generator)
        shape = self._shape(shape)
        num_heights = num_bins + 1 if tails is None else num_bins - 1
        self.unnormalized_widths = _normal((*shape, num_bins), generator, device)
        self.unnormalized_heights = _normal((*shape, num_heights), generator, device)


class PiecewiseCubicCDF(_LearnedCDF):
    """(reference nonlinearities.py:322-383). With linear tails, on a CUDA
    tensor, B8."""

    _PARAMS = ("unnormalized_widths", "unnormalized_heights", "unnorm_derivatives_left",
               "unnorm_derivatives_right")
    _bounded = staticmethod(splines.cubic_spline)
    _unconstrained = staticmethod(splines.unconstrained_cubic_spline)

    def __init__(self, shape, num_bins=10, tails=None, tail_bound=1.0,
                 min_bin_width=splines.cubic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.cubic.DEFAULT_MIN_BIN_HEIGHT,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(tails, tail_bound, min_bin_width=min_bin_width,
                         min_bin_height=min_bin_height)
        generator = default_generator(generator)
        shape = self._shape(shape)
        self.unnormalized_widths = _normal((*shape, num_bins), generator, device)
        self.unnormalized_heights = _normal((*shape, num_bins), generator, device)
        self.unnorm_derivatives_left = _normal((*shape, 1), generator, device)
        self.unnorm_derivatives_right = _normal((*shape, 1), generator, device)


class PiecewiseRationalQuadraticCDF(_LearnedCDF):
    """(reference nonlinearities.py:386-467). With linear tails it takes
    K - 1 derivatives, and on a CUDA tensor runs B1. ``identity_init``
    starts it at the identity: zero widths and heights, and derivatives
    whose softplus is 1 - min_derivative."""

    _PARAMS = ("unnormalized_widths", "unnormalized_heights", "unnormalized_derivatives")
    _bounded = staticmethod(splines.rational_quadratic_spline)
    _unconstrained = staticmethod(splines.unconstrained_rational_quadratic_spline)

    def __init__(self, shape, num_bins=10, tails=None, tail_bound=1.0,
                 identity_init=False,
                 min_bin_width=splines.rational_quadratic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.rational_quadratic.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.rational_quadratic.DEFAULT_MIN_DERIVATIVE,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(tails, tail_bound, min_bin_width=min_bin_width,
                         min_bin_height=min_bin_height, min_derivative=min_derivative)
        shape = self._shape(shape)
        num_derivatives = (num_bins - 1) if tails == "linear" else (num_bins + 1)
        if identity_init:
            constant = float(np.log(np.exp(1 - min_derivative) - 1))
            self.unnormalized_widths = nn.Parameter(torch.zeros(*shape, num_bins, device=device))
            self.unnormalized_heights = nn.Parameter(
                torch.zeros(*shape, num_bins, device=device))
            self.unnormalized_derivatives = nn.Parameter(
                torch.full((*shape, num_derivatives), constant, device=device))
        else:
            generator = default_generator(generator)
            self.unnormalized_widths = _uniform((*shape, num_bins), generator, device)
            self.unnormalized_heights = _uniform((*shape, num_bins), generator, device)
            self.unnormalized_derivatives = _uniform((*shape, num_derivatives), generator,
                                                     device)
