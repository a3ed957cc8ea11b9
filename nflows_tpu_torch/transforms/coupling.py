"""Coupling layers (counterpart of nflows_tpu/transforms/coupling.py;
reference nflows/transforms/coupling.py).

A coupling transform splits the features by a fixed binary mask: the
identity half feeds a conditioner net whose output parameterises an
elementwise bijection of the transform half. This slice ports the RQ
spline coupling on [N, D] inputs.

The conditioner's output columns are feature-major (column ``t*M + j`` is
parameter j of transformed feature t), as in the JAX package, so weights
carried across keep their meaning under the same reshape.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from nflows_tpu_torch.ops import splines
from nflows_tpu_torch.transforms.base import Transform
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["CouplingTransform", "PiecewiseCouplingTransform",
           "PiecewiseRationalQuadraticCouplingTransform"]


class CouplingTransform(Transform):
    """Base class for coupling layers.

    Args:
        mask: 1-dim array; ``mask[i] > 0`` means feature i is transformed,
            ``mask[i] <= 0`` means it passes through unchanged.
        transform_net_create_fn: callable (in_features, out_features) -> net.

    The JAX class's optional unconditional transform of the identity half
    is not ported yet.
    """

    def __init__(self, mask, transform_net_create_fn, device=None):
        super().__init__()
        mask = np.asarray(mask)
        if mask.ndim != 1:
            raise ValueError("Mask must be a 1-dim tensor.")
        if mask.size <= 0:
            raise ValueError("Mask can't be empty.")
        self.features = len(mask)
        identity_idx = np.where(mask <= 0)[0]
        transform_idx = np.where(mask > 0)[0]
        self.num_identity_features = len(identity_idx)
        self.num_transform_features = len(transform_idx)

        def index(a):
            return torch.as_tensor(a, dtype=torch.int64).to(device)

        self.register_buffer("identity_features", index(identity_idx))
        self.register_buffer("transform_features", index(transform_idx))
        # concat([identity, transform]) indexed by this puts features back
        self.register_buffer("inverse_permutation", index(
            np.argsort(np.concatenate([identity_idx, transform_idx]))))

        self.transform_net = transform_net_create_fn(
            self.num_identity_features,
            self.num_transform_features * self._transform_dim_multiplier())

    def _check(self, inputs):
        if inputs.ndim == 4:
            raise NotImplementedError("image (4D) couplings are not ported yet")
        if inputs.ndim != 2:
            raise ValueError("Inputs must be a 2D or a 4D tensor.")
        if inputs.shape[1] != self.features:
            raise ValueError(
                f"Expected features = {self.features}, got {inputs.shape[1]}.")

    def _merge(self, identity_split, transform_split):
        both = torch.cat([identity_split, transform_split], dim=1)
        return torch.index_select(both, 1, self.inverse_permutation)

    def forward(self, inputs, context=None):
        self._check(inputs)
        identity_split = torch.index_select(inputs, 1, self.identity_features)
        transform_split = torch.index_select(inputs, 1, self.transform_features)
        transform_params = self.transform_net(identity_split, context)
        transform_split, logabsdet = self._coupling_transform_forward(
            transform_split, transform_params)
        return self._merge(identity_split, transform_split), logabsdet

    def inverse(self, inputs, context=None):
        self._check(inputs)
        identity_split = torch.index_select(inputs, 1, self.identity_features)
        transform_split = torch.index_select(inputs, 1, self.transform_features)
        transform_params = self.transform_net(identity_split, context)
        transform_split, logabsdet = self._coupling_transform_inverse(
            transform_split, transform_params)
        return self._merge(identity_split, transform_split), logabsdet

    def _transform_dim_multiplier(self):
        raise NotImplementedError()

    def _coupling_transform_forward(self, inputs, transform_params):
        raise NotImplementedError()

    def _coupling_transform_inverse(self, inputs, transform_params):
        raise NotImplementedError()


class PiecewiseCouplingTransform(CouplingTransform):
    """Shared parameter reshaping for spline couplings."""

    def _coupling_transform_forward(self, inputs, transform_params):
        return self._coupling_transform(inputs, transform_params, inverse=False)

    def _coupling_transform_inverse(self, inputs, transform_params):
        return self._coupling_transform(inputs, transform_params, inverse=True)

    def _coupling_transform(self, inputs, transform_params, inverse=False):
        b, d = inputs.shape
        transform_params = transform_params.reshape(b, d, -1)
        outputs, logabsdet = self._piecewise_cdf(inputs, transform_params, inverse)
        return outputs, shapeutils.sum_except_batch(logabsdet)

    def _piecewise_cdf(self, inputs, transform_params, inverse=False):
        raise NotImplementedError()

    def _softmax_rescale(self, *param_groups):
        """Divide softmax inputs by sqrt(hidden) for init quality
        (reference coupling.py:554-563)."""
        net = self.transform_net
        if hasattr(net, "hidden_features"):
            s = 1.0 / np.sqrt(net.hidden_features)
        else:
            warnings.warn(
                "Inputs to the softmax are not scaled down: initialization might be bad.")
            s = 1.0
        return tuple(p * s for p in param_groups)


class PiecewiseRationalQuadraticCouplingTransform(PiecewiseCouplingTransform):
    """RQ-spline coupling: the NSF flagship (reference coupling.py:502-582)."""

    def __init__(self, mask, transform_net_create_fn, num_bins=10, tails=None,
                 tail_bound=1.0, apply_unconditional_transform=False,
                 img_shape=None,
                 min_bin_width=splines.rational_quadratic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.rational_quadratic.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.rational_quadratic.DEFAULT_MIN_DERIVATIVE,
                 device=None):
        if apply_unconditional_transform:
            raise NotImplementedError(
                "the unconditional RQ CDF on the identity half is not ported yet")
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative
        super().__init__(mask, transform_net_create_fn, device=device)

    def _transform_dim_multiplier(self):
        if self.tails == "linear":
            return self.num_bins * 3 - 1
        return self.num_bins * 3 + 1

    def _piecewise_cdf(self, inputs, transform_params, inverse=False):
        K = self.num_bins
        unnormalized_widths = transform_params[..., :K]
        unnormalized_heights = transform_params[..., K:2 * K]
        unnormalized_derivatives = transform_params[..., 2 * K:]
        unnormalized_widths, unnormalized_heights = self._softmax_rescale(
            unnormalized_widths, unnormalized_heights)
        kwargs = dict(min_bin_width=self.min_bin_width,
                      min_bin_height=self.min_bin_height,
                      min_derivative=self.min_derivative)
        if self.tails is None:
            spline_fn = splines.rational_quadratic_spline
        else:
            spline_fn = splines.unconstrained_rational_quadratic_spline
            kwargs.update(tails=self.tails, tail_bound=self.tail_bound)
        return spline_fn(
            inputs=inputs,
            unnormalized_widths=unnormalized_widths,
            unnormalized_heights=unnormalized_heights,
            unnormalized_derivatives=unnormalized_derivatives,
            inverse=inverse,
            **kwargs,
        )
