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

Ported: the affine (MAF) and the rational-quadratic (NSF-AR) transformers.
The linear, quadratic, cubic, linear-rational and UMNN ones are still to
port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nflows_tpu_torch.nn import made as made_module
from nflows_tpu_torch.ops import splines
from nflows_tpu_torch.transforms.base import Transform
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = [
    "AutoregressiveTransform",
    "MaskedAffineAutoregressiveTransform",
    "MaskedPiecewiseRationalQuadraticAutoregressiveTransform",
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
        super().__init__(made_module.MADE(
            features=features,
            hidden_features=hidden_features,
            context_features=context_features,
            num_blocks=num_blocks,
            output_multiplier=self._output_dim_multiplier(),
            use_residual_blocks=use_residual_blocks,
            random_mask=random_mask,
            generator=generator,
            activation=activation,
            dropout_probability=dropout_probability,
            use_batch_norm=use_batch_norm,
            device=device,
        ))

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
        super().__init__(made_module.MADE(
            features=features,
            hidden_features=hidden_features,
            context_features=context_features,
            num_blocks=num_blocks,
            output_multiplier=self._output_dim_multiplier(),
            use_residual_blocks=use_residual_blocks,
            random_mask=random_mask,
            generator=generator,
            activation=activation,
            dropout_probability=dropout_probability,
            use_batch_norm=use_batch_norm,
            device=device,
        ))

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
