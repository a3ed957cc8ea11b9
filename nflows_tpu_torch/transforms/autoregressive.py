"""Masked autoregressive transforms (counterpart of
nflows_tpu/transforms/autoregressive.py; reference
nflows/transforms/autoregressive.py).

Forward (the density direction) is one MADE pass, parallel over features.
The inverse is sequential: feature k needs the features before k already
inverted. It is the JAX package's iteration exactly: start from zeros, run
as many MADE passes as there are features, each followed by the elementwise
inverse of the given inputs; the logabsdet is the last pass's. On the card
that is D small launches a layer; the whole-chain kernel B9
(``ops/cuda/maf_flow_kernel.py``) runs it in one.

Ported: the affine (MAF), linear, quadratic, cubic, rational-quadratic
(NSF-AR), linear-rational and UMNN transformers. With linear tails on a
CUDA tensor the quadratic, rational-quadratic and linear-rational splines
are kernels B7, B1 and B5 (``ops/splines``); the linear and cubic
transformers take no tails and run the bounded splines, and the UMNN one
its quadrature, in plain PyTorch on the card, as the JAX package runs them
outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nflows_tpu_torch.nn import made as made_module
from nflows_tpu_torch.ops import splines
from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.base import Transform
from nflows_tpu_torch.transforms.umnn import MonotonicNormalizer
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = [
    "AutoregressiveTransform",
    "MaskedAffineAutoregressiveTransform",
    "MaskedPiecewiseLinearAutoregressiveTransform",
    "MaskedPiecewiseQuadraticAutoregressiveTransform",
    "MaskedPiecewiseCubicAutoregressiveTransform",
    "MaskedPiecewiseRationalQuadraticAutoregressiveTransform",
    "MaskedPiecewiseLinearRationalAutoregressiveTransform",
    "MaskedUMNNAutoregressiveTransform",
]


class AutoregressiveTransform(Transform):
    """Elementwise transform whose parameters come from an autoregressive
    net (reference autoregressive.py:24-61).

    NOTE: the inverse costs D forward passes of the conditioner.
    """

    def __init__(self, autoregressive_net):
        super().__init__()
        self.autoregressive_net = autoregressive_net

    def forward(self, inputs, context=None):
        autoregressive_params = self.autoregressive_net(inputs, context)
        return self._elementwise_forward(inputs, autoregressive_params)

    def inverse(self, inputs, context=None):
        num_inputs = int(np.prod(inputs.shape[1:]))
        outputs = torch.zeros_like(inputs)
        logabsdet = torch.zeros(inputs.shape[0], dtype=inputs.dtype,
                                device=inputs.device)
        for _ in range(num_inputs):
            autoregressive_params = self.autoregressive_net(outputs, context)
            outputs, logabsdet = self._elementwise_inverse(
                inputs, autoregressive_params)
        return outputs, logabsdet

    def _output_dim_multiplier(self):
        raise NotImplementedError()

    def _elementwise_forward(self, inputs, autoregressive_params):
        raise NotImplementedError()

    def _elementwise_inverse(self, inputs, autoregressive_params):
        raise NotImplementedError()


class MaskedAffineAutoregressiveTransform(AutoregressiveTransform):
    """MAF affine transform: softplus scale (reference
    autoregressive.py:64-128)."""

    _EPSILON = 1e-3

    def __init__(self, features, hidden_features, context_features=None,
                 num_blocks=2, use_residual_blocks=True, random_mask=False,
                 generator=None, activation=F.relu, dropout_probability=0.0,
                 use_batch_norm=False, device=None):
        self.features = features
        super().__init__(_made(
            features, hidden_features, context_features, num_blocks,
            self._output_dim_multiplier(), use_residual_blocks, random_mask, generator,
            activation, dropout_probability, use_batch_norm, device))

    def _output_dim_multiplier(self):
        return 2

    def _scale_and_shift(self, autoregressive_params):
        params = autoregressive_params.reshape(
            -1, self.features, self._output_dim_multiplier())
        scale = splines.rational_quadratic._softplus(params[..., 0]) + self._EPSILON
        return scale, params[..., 1]

    def _elementwise_forward(self, inputs, autoregressive_params):
        scale, shift = self._scale_and_shift(autoregressive_params)
        outputs = scale * inputs + shift
        return outputs, shapeutils.sum_except_batch(torch.log(scale), num_batch_dims=1)

    def _elementwise_inverse(self, inputs, autoregressive_params):
        scale, shift = self._scale_and_shift(autoregressive_params)
        outputs = (inputs - shift) / scale
        return outputs, -shapeutils.sum_except_batch(torch.log(scale), num_batch_dims=1)


class _MaskedPiecewiseAutoregressive(AutoregressiveTransform):
    """Shared reshape logic for spline AR transforms."""

    def _reshape_params(self, inputs, autoregressive_params):
        return autoregressive_params.reshape(
            inputs.shape[0], self.features, self._output_dim_multiplier())

    def _hidden_scale(self):
        if hasattr(self.autoregressive_net, "hidden_features"):
            return 1.0 / np.sqrt(self.autoregressive_net.hidden_features)
        return 1.0

    def _elementwise_forward(self, inputs, autoregressive_params):
        return self._elementwise(inputs, autoregressive_params, inverse=False)

    def _elementwise_inverse(self, inputs, autoregressive_params):
        return self._elementwise(inputs, autoregressive_params, inverse=True)


def _made(features, hidden_features, context_features, num_blocks, output_multiplier,
          use_residual_blocks, random_mask, generator, activation, dropout_probability,
          use_batch_norm, device):
    return made_module.MADE(
        features=features,
        hidden_features=hidden_features,
        context_features=context_features,
        num_blocks=num_blocks,
        output_multiplier=output_multiplier,
        use_residual_blocks=use_residual_blocks,
        random_mask=random_mask,
        generator=generator,
        activation=activation,
        dropout_probability=dropout_probability,
        use_batch_norm=use_batch_norm,
        device=device,
    )


class MaskedPiecewiseLinearAutoregressiveTransform(_MaskedPiecewiseAutoregressive):
    """Linear-spline AR transform (reference autoregressive.py:196-246): the
    bounded spline on [0, 1], no tails and no rescale of the pdf."""

    def __init__(self, num_bins, features, hidden_features, context_features=None,
                 num_blocks=2, use_residual_blocks=True, random_mask=False, generator=None,
                 activation=F.relu, dropout_probability=0.0, use_batch_norm=False,
                 device=None):
        self.num_bins = num_bins
        self.features = features
        super().__init__(_made(
            features, hidden_features, context_features, num_blocks,
            self._output_dim_multiplier(), use_residual_blocks, random_mask, generator,
            activation, dropout_probability, use_batch_norm, device))

    def _output_dim_multiplier(self):
        return self.num_bins

    def _elementwise(self, inputs, autoregressive_params, inverse=False):
        unnormalized_pdf = self._reshape_params(inputs, autoregressive_params)
        outputs, logabsdet = splines.linear_spline(inputs, unnormalized_pdf, inverse=inverse)
        return outputs, shapeutils.sum_except_batch(logabsdet)


class MaskedPiecewiseQuadraticAutoregressiveTransform(_MaskedPiecewiseAutoregressive):
    """Quadratic-spline AR transform (reference autoregressive.py:249-334).
    As in the reference, only the widths are rescaled by 1/sqrt(hidden)
    (autoregressive.py:305-307). With linear tails on a CUDA tensor the
    spline is kernel B7."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_bins=10, num_blocks=2, tails=None, tail_bound=1.0,
                 use_residual_blocks=True, random_mask=False, generator=None,
                 activation=F.relu, dropout_probability=0.0, use_batch_norm=False,
                 min_bin_width=splines.quadratic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.quadratic.DEFAULT_MIN_BIN_HEIGHT,
                 device=None):
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.features = features
        super().__init__(_made(
            features, hidden_features, context_features, num_blocks,
            self._output_dim_multiplier(), use_residual_blocks, random_mask, generator,
            activation, dropout_probability, use_batch_norm, device))

    def _output_dim_multiplier(self):
        if self.tails == "linear":
            return self.num_bins * 2 - 1
        return self.num_bins * 2 + 1

    def _elementwise(self, inputs, autoregressive_params, inverse=False):
        transform_params = self._reshape_params(inputs, autoregressive_params)
        unnormalized_widths = transform_params[..., :self.num_bins] * self._hidden_scale()
        unnormalized_heights = transform_params[..., self.num_bins:]
        kwargs = dict(min_bin_width=self.min_bin_width, min_bin_height=self.min_bin_height)
        if self.tails is None:
            spline_fn = splines.quadratic_spline
        elif self.tails == "linear":
            spline_fn = splines.unconstrained_quadratic_spline
            kwargs.update(tails=self.tails, tail_bound=self.tail_bound)
        else:
            raise ValueError
        outputs, logabsdet = spline_fn(inputs, unnormalized_widths, unnormalized_heights,
                                       inverse=inverse, **kwargs)
        return outputs, shapeutils.sum_except_batch(logabsdet)


class MaskedPiecewiseCubicAutoregressiveTransform(_MaskedPiecewiseAutoregressive):
    """Cubic-spline AR transform (reference autoregressive.py:337-401): the
    bounded spline on [0, 1], widths and heights rescaled by
    1/sqrt(hidden)."""

    def __init__(self, num_bins, features, hidden_features, context_features=None,
                 num_blocks=2, use_residual_blocks=True, random_mask=False, generator=None,
                 activation=F.relu, dropout_probability=0.0, use_batch_norm=False,
                 device=None):
        self.num_bins = num_bins
        self.features = features
        super().__init__(_made(
            features, hidden_features, context_features, num_blocks,
            self._output_dim_multiplier(), use_residual_blocks, random_mask, generator,
            activation, dropout_probability, use_batch_norm, device))

    def _output_dim_multiplier(self):
        return self.num_bins * 2 + 2

    def _elementwise(self, inputs, autoregressive_params, inverse=False):
        transform_params = self._reshape_params(inputs, autoregressive_params)
        K = self.num_bins
        s = self._hidden_scale()
        outputs, logabsdet = splines.cubic_spline(
            inputs, transform_params[..., :K] * s, transform_params[..., K:2 * K] * s,
            transform_params[..., 2 * K:2 * K + 1], transform_params[..., 2 * K + 1:],
            inverse=inverse)
        return outputs, shapeutils.sum_except_batch(logabsdet)


class MaskedPiecewiseRationalQuadraticAutoregressiveTransform(_MaskedPiecewiseAutoregressive):
    """RQ-spline AR transform, NSF-AR (reference autoregressive.py:404-495).
    With linear tails on a CUDA tensor the spline is kernel B1, as in the
    coupling."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_bins=10, tails=None, tail_bound=1.0, num_blocks=2,
                 use_residual_blocks=True, random_mask=False, generator=None,
                 activation=F.relu, dropout_probability=0.0,
                 use_batch_norm=False,
                 min_bin_width=splines.rational_quadratic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.rational_quadratic.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.rational_quadratic.DEFAULT_MIN_DERIVATIVE,
                 device=None):
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative
        self.features = features
        super().__init__(_made(
            features, hidden_features, context_features, num_blocks,
            self._output_dim_multiplier(), use_residual_blocks, random_mask, generator,
            activation, dropout_probability, use_batch_norm, device))

    def _output_dim_multiplier(self):
        if self.tails == "linear":
            return self.num_bins * 3 - 1
        elif self.tails is None:
            return self.num_bins * 3 + 1
        raise ValueError

    def _elementwise(self, inputs, autoregressive_params, inverse=False):
        transform_params = self._reshape_params(inputs, autoregressive_params)
        # the AR variant rescales widths AND heights by 1/sqrt(hidden)
        s = self._hidden_scale()
        unnormalized_widths = transform_params[..., : self.num_bins] * s
        unnormalized_heights = transform_params[..., self.num_bins: 2 * self.num_bins] * s
        unnormalized_derivatives = transform_params[..., 2 * self.num_bins:]

        kwargs = {}
        if self.tails is None:
            spline_fn = splines.rational_quadratic_spline
        elif self.tails == "linear":
            spline_fn = splines.unconstrained_rational_quadratic_spline
            kwargs = {"tails": self.tails, "tail_bound": self.tail_bound}
        else:
            raise ValueError
        outputs, logabsdet = spline_fn(
            inputs=inputs,
            unnormalized_widths=unnormalized_widths,
            unnormalized_heights=unnormalized_heights,
            unnormalized_derivatives=unnormalized_derivatives,
            inverse=inverse,
            min_bin_width=self.min_bin_width,
            min_bin_height=self.min_bin_height,
            min_derivative=self.min_derivative,
            **kwargs,
        )
        return outputs, shapeutils.sum_except_batch(logabsdet)


class MaskedPiecewiseLinearRationalAutoregressiveTransform(_MaskedPiecewiseAutoregressive):
    """Linear-rational-spline AR transform (Dolatabadi et al. 2020,
    arXiv:2001.05168), beyond the reference library: widths and heights
    rescaled by 1/sqrt(hidden); an analytic linear inverse a step, the
    ancestral inverse still D sequential passes. With linear tails on a
    CUDA tensor the spline is kernel B5."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_bins=10, tails=None, tail_bound=1.0, num_blocks=2,
                 use_residual_blocks=True, random_mask=False, generator=None,
                 activation=F.relu, dropout_probability=0.0, use_batch_norm=False,
                 min_bin_width=splines.linear_rational.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.linear_rational.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.linear_rational.DEFAULT_MIN_DERIVATIVE,
                 min_lambda=splines.linear_rational.DEFAULT_MIN_LAMBDA,
                 device=None):
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative
        self.min_lambda = min_lambda
        self.features = features
        super().__init__(_made(
            features, hidden_features, context_features, num_blocks,
            self._output_dim_multiplier(), use_residual_blocks, random_mask, generator,
            activation, dropout_probability, use_batch_norm, device))

    def _output_dim_multiplier(self):
        if self.tails == "linear":
            return self.num_bins * 4 - 1
        elif self.tails is None:
            return self.num_bins * 4 + 1
        raise ValueError

    def _elementwise(self, inputs, autoregressive_params, inverse=False):
        transform_params = self._reshape_params(inputs, autoregressive_params)
        K = self.num_bins
        s = self._hidden_scale()
        kwargs = dict(min_bin_width=self.min_bin_width, min_bin_height=self.min_bin_height,
                      min_derivative=self.min_derivative, min_lambda=self.min_lambda)
        if self.tails is None:
            spline_fn = splines.linear_rational_spline
        elif self.tails == "linear":
            spline_fn = splines.unconstrained_linear_rational_spline
            kwargs.update(tails=self.tails, tail_bound=self.tail_bound)
        else:
            raise ValueError
        outputs, logabsdet = spline_fn(
            inputs, transform_params[..., :K] * s, transform_params[..., K:2 * K] * s,
            transform_params[..., 3 * K:], transform_params[..., 2 * K:3 * K],
            inverse=inverse, **kwargs)
        return outputs, shapeutils.sum_except_batch(logabsdet)


class MaskedUMNNAutoregressiveTransform(AutoregressiveTransform):
    """UMNN autoregressive transform (reference autoregressive.py:131-192):
    the MADE emits a ``cond_size`` embedding a feature, and the shared
    :class:`~nflows_tpu_torch.transforms.umnn.MonotonicNormalizer`
    integrates it (transforms/umnn.py). The MADE's weights come first from
    ``generator``, then the integrand net's. Its inverse runs the
    normalizer's 25-halving bisection in each of the D passes."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_blocks=2, use_residual_blocks=True, random_mask=False, generator=None,
                 activation=F.relu, dropout_probability=0.0, use_batch_norm=False,
                 integrand_net_layers=(50, 50, 50), cond_size=20, nb_steps=20,
                 solver="CCParallel", device=None):
        generator = default_generator(generator)
        self.features = features
        self.cond_size = cond_size
        super().__init__(_made(
            features, hidden_features, context_features, num_blocks,
            self._output_dim_multiplier(), use_residual_blocks, random_mask, generator,
            activation, dropout_probability, use_batch_norm, device))
        self.transformer = MonotonicNormalizer(
            list(integrand_net_layers), cond_size, nb_steps, solver, generator=generator,
            device=device)

    def _output_dim_multiplier(self):
        return self.cond_size

    def _elementwise_forward(self, inputs, autoregressive_params):
        h = autoregressive_params.reshape(inputs.shape[0], inputs.shape[1], -1)
        z, jac = self.transformer.forward(inputs, h)
        return z, torch.log(jac).sum(dim=1)

    def _elementwise_inverse(self, inputs, autoregressive_params):
        h = autoregressive_params.reshape(inputs.shape[0], inputs.shape[1], -1)
        x = self.transformer.inverse_transform(inputs, h)
        _, jac = self.transformer.forward(x, h)
        return x, -torch.log(jac).sum(dim=1)
