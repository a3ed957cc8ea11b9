"""Coupling layers (counterpart of nflows_tpu/transforms/coupling.py;
reference nflows/transforms/coupling.py).

A coupling transform splits the features by a fixed binary mask: the
identity half feeds a conditioner net whose output parameterises an
elementwise bijection of the transform half; an optional unconditional
transform maps the identity half itself. Ported: the affine (RealNVP) and
additive (NICE) couplings, the spline couplings (linear, quadratic, cubic,
rational-quadratic, linear-rational), each with its learned CDF on the
identity half (``apply_unconditional_transform=True``), and the UMNN
coupling, on [N, D] inputs.

The conditioner's output columns are feature-major (column ``t*M + j`` is
parameter j of transformed feature t), as in the JAX package, so weights
carried across keep their meaning under the same reshape.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.ops import splines
from nflows_tpu_torch.transforms import nonlinearities
from nflows_tpu_torch.transforms.base import Transform
from nflows_tpu_torch.transforms.umnn import MonotonicNormalizer, UnconditionalMonotonicTransform
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["CouplingTransform", "AffineCouplingTransform",
           "AdditiveCouplingTransform", "PiecewiseCouplingTransform",
           "PiecewiseLinearCouplingTransform",
           "PiecewiseQuadraticCouplingTransform",
           "PiecewiseCubicCouplingTransform",
           "PiecewiseRationalQuadraticCouplingTransform",
           "PiecewiseLinearRationalCouplingTransform",
           "UMNNCouplingTransform"]


class CouplingTransform(Transform):
    """Base class for coupling layers.

    Args:
        mask: 1-dim array; ``mask[i] > 0`` means feature i is transformed,
            ``mask[i] <= 0`` means it passes through unchanged.
        transform_net_create_fn: callable (in_features, out_features) -> net.
        unconditional_transform: optional callable (features) -> Transform
            applied to the identity half.

    Forward runs the conditioner on the identity half as it came in, then
    the unconditional transform; the inverse undoes the unconditional
    transform first and runs the conditioner on its output. The logabsdet
    is the sum of the two in both directions.
    """

    def __init__(self, mask, transform_net_create_fn, unconditional_transform=None,
                 device=None):
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
        self.unconditional_transform = (
            unconditional_transform(features=self.num_identity_features)
            if unconditional_transform is not None else None)

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
        if self.unconditional_transform is not None:
            identity_split, logabsdet_identity = self.unconditional_transform.forward(
                identity_split, context)
            logabsdet = logabsdet + logabsdet_identity
        return self._merge(identity_split, transform_split), logabsdet

    def inverse(self, inputs, context=None):
        self._check(inputs)
        identity_split = torch.index_select(inputs, 1, self.identity_features)
        transform_split = torch.index_select(inputs, 1, self.transform_features)
        logabsdet_identity = None
        if self.unconditional_transform is not None:
            identity_split, logabsdet_identity = self.unconditional_transform.inverse(
                identity_split, context)
        transform_params = self.transform_net(identity_split, context)
        transform_split, logabsdet = self._coupling_transform_inverse(
            transform_split, transform_params)
        if logabsdet_identity is not None:
            logabsdet = logabsdet_identity + logabsdet
        return self._merge(identity_split, transform_split), logabsdet

    def _transform_dim_multiplier(self):
        raise NotImplementedError()

    def _coupling_transform_forward(self, inputs, transform_params):
        raise NotImplementedError()

    def _coupling_transform_inverse(self, inputs, transform_params):
        raise NotImplementedError()


def _default_scale_activation(x):
    """sigmoid(x + 2) + 1e-3, scales in (1e-3, 1.001) (reference coupling.py:224)."""
    return torch.sigmoid(x + 2.0) + 1e-3


def _general_scale_activation(x):
    """Clamped softplus, scales in (1e-3, 3] (reference coupling.py:225).
    ``torch.logaddexp(x, 0)`` is the JAX package's softplus; ``F.softplus``
    turns linear above 20 and would depart from it."""
    return torch.clamp(torch.logaddexp(x, torch.zeros_like(x)) + 1e-3, 0.0, 3.0)


class AffineCouplingTransform(CouplingTransform):
    """RealNVP scale-and-shift coupling (reference coupling.py:212-252): the
    conditioner gives the shift first and the unconstrained scale second,
    T columns each."""

    DEFAULT_SCALE_ACTIVATION = staticmethod(_default_scale_activation)
    GENERAL_SCALE_ACTIVATION = staticmethod(_general_scale_activation)

    def __init__(self, mask, transform_net_create_fn, unconditional_transform=None,
                 scale_activation=_default_scale_activation, device=None):
        self.scale_activation = scale_activation
        super().__init__(mask, transform_net_create_fn, unconditional_transform,
                         device=device)

    def _transform_dim_multiplier(self):
        return 2

    def _scale_and_shift(self, transform_params):
        unconstrained_scale = transform_params[:, self.num_transform_features:]
        shift = transform_params[:, :self.num_transform_features]
        return self.scale_activation(unconstrained_scale), shift

    def _coupling_transform_forward(self, inputs, transform_params):
        scale, shift = self._scale_and_shift(transform_params)
        log_scale = torch.log(scale)
        return inputs * scale + shift, shapeutils.sum_except_batch(log_scale)

    def _coupling_transform_inverse(self, inputs, transform_params):
        scale, shift = self._scale_and_shift(transform_params)
        log_scale = torch.log(scale)
        return (inputs - shift) / scale, -shapeutils.sum_except_batch(log_scale)


class AdditiveCouplingTransform(AffineCouplingTransform):
    """NICE additive coupling: shift only, logabsdet 0 (reference
    coupling.py:255-269)."""

    def _transform_dim_multiplier(self):
        return 1

    def _scale_and_shift(self, transform_params):
        return torch.ones_like(transform_params), transform_params


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

    def _softmax_rescale(self, *param_groups, include_channels=False):
        """Divide softmax inputs by sqrt(hidden) for init quality.

        The quadratic and cubic couplings scale only when the net has
        ``hidden_features`` (reference coupling.py:407-409, 478-480), and the
        linear-rational one follows them; only the RQ coupling also falls
        back to ``hidden_channels`` and warns otherwise (coupling.py:554-563):
        ``include_channels=True`` for that variant."""
        net = self.transform_net
        s = 1.0
        if hasattr(net, "hidden_features"):
            s = 1.0 / np.sqrt(net.hidden_features)
        elif include_channels and hasattr(net, "hidden_channels"):
            s = 1.0 / np.sqrt(net.hidden_channels)
        elif include_channels:
            warnings.warn(
                "Inputs to the softmax are not scaled down: initialization might be bad.")
        return tuple(p * s for p in param_groups)


def _cdf_on_identity_half(apply_unconditional_transform, cdf_class, img_shape, generator,
                          device, **kwargs):
    """The ``unconditional_transform`` argument of a spline coupling: its
    family's learned CDF over the identity half (and ``img_shape``) with
    the coupling's bins, tails and minimum sizes, or None."""
    if not apply_unconditional_transform:
        return None
    return lambda features: cdf_class(
        shape=[features] + (list(img_shape) if img_shape else []), generator=generator,
        device=device, **kwargs)


class PiecewiseLinearCouplingTransform(PiecewiseCouplingTransform):
    """Linear-spline coupling (Müller et al. 2018; reference
    coupling.py:299-352)."""

    def __init__(self, mask, transform_net_create_fn, num_bins=10, tails=None,
                 tail_bound=1.0, apply_unconditional_transform=False,
                 img_shape=None, generator=None, device=None):
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        super().__init__(mask, transform_net_create_fn, _cdf_on_identity_half(
            apply_unconditional_transform, nonlinearities.PiecewiseLinearCDF, img_shape,
            generator, device, num_bins=num_bins, tails=tails, tail_bound=tail_bound),
            device=device)

    def _transform_dim_multiplier(self):
        return self.num_bins

    def _piecewise_cdf(self, inputs, transform_params, inverse=False):
        if self.tails is None:
            return splines.linear_spline(inputs, transform_params, inverse=inverse)
        return splines.unconstrained_linear_spline(
            inputs, transform_params, inverse=inverse, tails=self.tails,
            tail_bound=self.tail_bound)


class PiecewiseQuadraticCouplingTransform(PiecewiseCouplingTransform):
    """Quadratic-spline coupling (Müller et al. 2018; reference
    coupling.py:355-426)."""

    def __init__(self, mask, transform_net_create_fn, num_bins=10, tails=None,
                 tail_bound=1.0, apply_unconditional_transform=False,
                 img_shape=None,
                 min_bin_width=splines.quadratic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.quadratic.DEFAULT_MIN_BIN_HEIGHT,
                 generator=None, device=None):
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        super().__init__(mask, transform_net_create_fn, _cdf_on_identity_half(
            apply_unconditional_transform, nonlinearities.PiecewiseQuadraticCDF, img_shape,
            generator, device, num_bins=num_bins, tails=tails, tail_bound=tail_bound,
            min_bin_width=min_bin_width, min_bin_height=min_bin_height), device=device)

    def _transform_dim_multiplier(self):
        if self.tails == "linear":
            return self.num_bins * 2 - 1
        return self.num_bins * 2 + 1

    def _piecewise_cdf(self, inputs, transform_params, inverse=False):
        K = self.num_bins
        unnormalized_widths, unnormalized_heights = self._softmax_rescale(
            transform_params[..., :K], transform_params[..., K:])
        kwargs = dict(min_bin_width=self.min_bin_width,
                      min_bin_height=self.min_bin_height)
        if self.tails is None:
            spline_fn = splines.quadratic_spline
        else:
            spline_fn = splines.unconstrained_quadratic_spline
            kwargs.update(tails=self.tails, tail_bound=self.tail_bound)
        return spline_fn(inputs, unnormalized_widths, unnormalized_heights,
                         inverse=inverse, **kwargs)


class PiecewiseCubicCouplingTransform(PiecewiseCouplingTransform):
    """Cubic-spline coupling (reference coupling.py:429-499)."""

    def __init__(self, mask, transform_net_create_fn, num_bins=10, tails=None,
                 tail_bound=1.0, apply_unconditional_transform=False,
                 img_shape=None,
                 min_bin_width=splines.cubic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.cubic.DEFAULT_MIN_BIN_HEIGHT,
                 generator=None, device=None):
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        super().__init__(mask, transform_net_create_fn, _cdf_on_identity_half(
            apply_unconditional_transform, nonlinearities.PiecewiseCubicCDF, img_shape,
            generator, device, num_bins=num_bins, tails=tails, tail_bound=tail_bound,
            min_bin_width=min_bin_width, min_bin_height=min_bin_height), device=device)

    def _transform_dim_multiplier(self):
        return self.num_bins * 2 + 2

    def _piecewise_cdf(self, inputs, transform_params, inverse=False):
        K = self.num_bins
        unnormalized_widths, unnormalized_heights = self._softmax_rescale(
            transform_params[..., :K], transform_params[..., K:2 * K])
        kwargs = dict(min_bin_width=self.min_bin_width,
                      min_bin_height=self.min_bin_height)
        if self.tails is None:
            spline_fn = splines.cubic_spline
        else:
            spline_fn = splines.unconstrained_cubic_spline
            kwargs.update(tails=self.tails, tail_bound=self.tail_bound)
        return spline_fn(inputs, unnormalized_widths, unnormalized_heights,
                         transform_params[..., 2 * K:2 * K + 1],
                         transform_params[..., 2 * K + 1:], inverse=inverse, **kwargs)


class PiecewiseRationalQuadraticCouplingTransform(PiecewiseCouplingTransform):
    """RQ-spline coupling: the NSF flagship (reference coupling.py:502-582)."""

    def __init__(self, mask, transform_net_create_fn, num_bins=10, tails=None,
                 tail_bound=1.0, apply_unconditional_transform=False,
                 img_shape=None,
                 min_bin_width=splines.rational_quadratic.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.rational_quadratic.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.rational_quadratic.DEFAULT_MIN_DERIVATIVE,
                 generator=None, device=None):
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative
        super().__init__(mask, transform_net_create_fn, _cdf_on_identity_half(
            apply_unconditional_transform, nonlinearities.PiecewiseRationalQuadraticCDF,
            img_shape, generator, device, num_bins=num_bins, tails=tails,
            tail_bound=tail_bound, min_bin_width=min_bin_width,
            min_bin_height=min_bin_height, min_derivative=min_derivative), device=device)

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
            unnormalized_widths, unnormalized_heights, include_channels=True)
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


class PiecewiseLinearRationalCouplingTransform(PiecewiseCouplingTransform):
    """Linear-rational-spline coupling (Dolatabadi et al. 2020,
    arXiv:2001.05168), beyond the reference library: the RQ coupling's
    contract with a per-bin split point lambda and a linear inverse
    (ops/splines/linear_rational.py)."""

    def __init__(self, mask, transform_net_create_fn, num_bins=10, tails=None,
                 tail_bound=1.0, apply_unconditional_transform=False,
                 img_shape=None,
                 min_bin_width=splines.linear_rational.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.linear_rational.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.linear_rational.DEFAULT_MIN_DERIVATIVE,
                 min_lambda=splines.linear_rational.DEFAULT_MIN_LAMBDA,
                 generator=None, device=None):
        self.num_bins = num_bins
        self.tails = tails
        self.tail_bound = tail_bound
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative
        self.min_lambda = min_lambda
        super().__init__(mask, transform_net_create_fn, _cdf_on_identity_half(
            apply_unconditional_transform, nonlinearities.PiecewiseLinearRationalCDF,
            img_shape, generator, device, num_bins=num_bins, tails=tails,
            tail_bound=tail_bound, min_bin_width=min_bin_width,
            min_bin_height=min_bin_height, min_derivative=min_derivative,
            min_lambda=min_lambda), device=device)

    def _transform_dim_multiplier(self):
        # widths K + heights K + lambdas K + derivatives (K-1 | K+1)
        if self.tails == "linear":
            return self.num_bins * 4 - 1
        return self.num_bins * 4 + 1

    def _piecewise_cdf(self, inputs, transform_params, inverse=False):
        K = self.num_bins
        unnormalized_widths, unnormalized_heights = self._softmax_rescale(
            transform_params[..., :K], transform_params[..., K:2 * K])
        kwargs = dict(min_bin_width=self.min_bin_width,
                      min_bin_height=self.min_bin_height,
                      min_derivative=self.min_derivative,
                      min_lambda=self.min_lambda)
        if self.tails is None:
            spline_fn = splines.linear_rational_spline
        else:
            spline_fn = splines.unconstrained_linear_rational_spline
            kwargs.update(tails=self.tails, tail_bound=self.tail_bound)
        return spline_fn(inputs, unnormalized_widths, unnormalized_heights,
                         transform_params[..., 3 * K:], transform_params[..., 2 * K:3 * K],
                         inverse=inverse, **kwargs)


class UMNNCouplingTransform(CouplingTransform):
    """Unconstrained monotonic neural network coupling (reference
    coupling.py:145-209; Wehenkel & Louppe, NeurIPS 2019), on [N, D]
    inputs; a 4-D input raises ``NotImplementedError`` as the other
    couplings do.

    The conditioner emits a ``cond_size`` embedding a transformed feature
    (feature-major, as the other couplings' parameters); the shared
    :class:`~nflows_tpu_torch.transforms.umnn.MonotonicNormalizer`
    integrates a positive integrand net by Clenshaw-Curtis quadrature.
    ``apply_unconditional_transform=True`` puts a cond_size-0 normalizer
    on the identity half (``UnconditionalMonotonicTransform``), the
    reference's configuration (coupling.py:171-173). All of it is plain
    PyTorch on the card, as the JAX package runs it outside any Pallas
    kernel.
    """

    def __init__(self, mask, transform_net_create_fn, integrand_net_layers=(50, 50, 50),
                 cond_size=20, nb_steps=20, solver="CCParallel",
                 apply_unconditional_transform=False, generator=None, device=None):
        generator = default_generator(generator)
        unconditional_transform = None
        if apply_unconditional_transform:
            def unconditional_transform(features):
                return UnconditionalMonotonicTransform(
                    features, integrand_net_layers=integrand_net_layers, nb_steps=nb_steps,
                    solver=solver, generator=generator, device=device)
        self.cond_size = cond_size
        super().__init__(mask, transform_net_create_fn, unconditional_transform,
                         device=device)
        self.transformer = MonotonicNormalizer(
            list(integrand_net_layers), cond_size, nb_steps, solver, generator=generator,
            device=device)

    def _transform_dim_multiplier(self):
        return self.cond_size

    def _params(self, inputs, transform_params):
        return transform_params.reshape(inputs.shape[0], inputs.shape[1], -1)

    def _coupling_transform_forward(self, inputs, transform_params):
        z, jac = self.transformer.forward(inputs, self._params(inputs, transform_params))
        return z, torch.log(jac).sum(dim=1)

    def _coupling_transform_inverse(self, inputs, transform_params):
        params = self._params(inputs, transform_params)
        x = self.transformer.inverse_transform(inputs, params)
        _, jac = self.transformer.forward(x, params)
        return x, -torch.log(jac).sum(dim=1)
