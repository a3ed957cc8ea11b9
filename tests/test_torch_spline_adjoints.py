"""The hand-derived adjoints of the linear-rational, linear, quadratic and
cubic splines' forward branches (``*_forward_adjoint_plain`` in
``ops/splines``, the plain versions of ``csrc/{lrs,linear,quadratic,
cubic}_spline_bwd.cuh``, which the training kernels B3 and B4 run) against
``torch.autograd`` of the port's plain splines and against ``jax.grad`` of
the JAX package's splines, on the same numpy inputs: points inside every bin
and in both tails, parameters from N(0, scale).

Tolerance, as for the RQ spline's adjoint (tests/test_torch_rq_spline_adjoint.py).
Float64 against autograd: 1e-10 absolute and relative (the two differ only
in the order of a few operations). Float32 against autograd and against
``jax.grad``: 1e-4 absolute plus 1e-4 relative for parameters at scale 0.5;
at scale 1 a bin can be ~1e-2 wide with a slope near 1e-3, where gradients
reach ~1e2 and fp32 rounding alone moves them by 1e-3 of their value, so
those are held to 2e-3 relative. Inputs exactly on +-B are left out (JAX's
``clip`` halves the derivative at its tie, torch's ``clamp`` does not), and
so are exact ties of a ``min`` (none occurs with these draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.ops import splines as jax_splines
from nflows_tpu_torch.ops import binning
from nflows_tpu_torch.ops.splines import cubic, linear, linear_rational, quadratic

torch.set_num_threads(1)

B = 3.0

# family -> (parameter widths for K, the port's plain spline, its adjoint,
# the JAX spline, how many leading parameter arrays wh_scale multiplies)
FAMILIES = {
    "lrs": (lambda K: (K, K, K - 1, K),
            linear_rational.unconstrained_linear_rational_spline_plain,
            linear_rational.linear_rational_spline_forward_adjoint_plain,
            jax_splines.unconstrained_linear_rational_spline, 2),
    "linear": (lambda K: (K,),
               linear.unconstrained_linear_spline_plain,
               linear.linear_spline_forward_adjoint_plain,
               jax_splines.unconstrained_linear_spline, 1),
    "quadratic": (lambda K: (K, K - 1),
                  quadratic.unconstrained_quadratic_spline_plain,
                  quadratic.quadratic_spline_forward_adjoint_plain,
                  jax_splines.unconstrained_quadratic_spline, 2),
    "cubic": (lambda K: (K, K, 1, 1),
              cubic.unconstrained_cubic_spline_plain,
              cubic.cubic_spline_forward_adjoint_plain,
              jax_splines.unconstrained_cubic_spline, 2),
}


def _inputs(family, K, seed, scale, n=600):
    rng = np.random.default_rng(seed)
    # a grid through every bin and both tails, jittered off the bin edges
    x = np.linspace(-B - 1.0, B + 1.0, n) + 1e-3 * rng.standard_normal(n)
    x = x[np.abs(np.abs(x) - B) > 1e-6].astype(np.float32)
    n = x.shape[0]
    params = [np.float32(scale) * rng.standard_normal((n, k)).astype(np.float32)
              for k in FAMILIES[family][0](K)]
    g_out, g_lad = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    return x, params, g_out, g_lad


def _bins_hit(family, x, w, K):
    """Indices of the bins the inside points fall in."""
    inside = x.abs() <= B
    if family == "linear":   # K equal-width bins
        u = (x[inside] + B) / (2 * B)
        return set(torch.clamp(torch.floor(u * K), 0, K - 1).long().tolist())
    _, cum = binning.edges_on(w, K, 1e-3, -B, B)
    return set(torch.searchsorted(cum[inside][:, 1:-1].contiguous(),
                                  x[inside][:, None]).flatten().tolist())


def _autograd(family, x, params, g_out, g_lad):
    leaves = [t.clone().requires_grad_(True) for t in (x, *params)]
    out, lad = FAMILIES[family][1](*leaves, tail_bound=B)
    return torch.autograd.grad((out, lad), leaves, (g_out, g_lad))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("dtype,scale,atol,rtol", [
    (torch.float64, 1.0, 1e-10, 1e-10),
    (torch.float32, 0.5, 1e-4, 1e-4),
    (torch.float32, 1.0, 1e-4, 2e-3),
])
def test_adjoint_matches_autograd(family, K, dtype, scale, atol, rtol):
    x, params, g_out, g_lad = _inputs(family, K, seed=K, scale=scale)
    x, g_out, g_lad = (torch.from_numpy(a).to(dtype) for a in (x, g_out, g_lad))
    params = [torch.from_numpy(p).to(dtype) for p in params]
    assert _bins_hit(family, x, params[0], K) == set(range(K))   # every bin
    assert (x > B).any() and (x < -B).any()                       # both tails
    got = FAMILIES[family][2](x, *params, g_out, g_lad, tail_bound=B)
    ref = _autograd(family, x, params, g_out, g_lad)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("scale,rtol", [(0.5, 1e-4), (1.0, 2e-3)])
def test_adjoint_matches_jax_grad(family, K, scale, rtol):
    x, params, g_out, g_lad = _inputs(family, K, seed=10 + K, scale=scale)
    jax_fn = FAMILIES[family][3]

    def mixed(*arrays):
        out, lad = jax_fn(*arrays, inverse=False, tail_bound=B)
        return jnp.sum(out * g_out) + jnp.sum(lad * g_lad)

    ref = jax.grad(mixed, argnums=tuple(range(1 + len(params))))(x, *params)
    got = FAMILIES[family][2](*[torch.from_numpy(a) for a in (x, *params, g_out, g_lad)],
                              tail_bound=B)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=rtol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_wh_scale_is_the_folded_weights(family):
    """The training kernels hand the adjoint parameters already scaled by
    ``wh_scale`` (the widths and heights; every parameter of the linear and
    quadratic splines) and want the cotangents of the unscaled ones: the
    adjoint with ``wh_scale`` equals autograd through the scaling."""
    K, s = 8, 0.0625
    x, params, g_out, g_lad = (
        [torch.from_numpy(p).double() for p in a] if isinstance(a, list)
        else torch.from_numpy(a).double() for a in _inputs(family, K, seed=3, scale=8.0))
    n_scaled = FAMILIES[family][4]
    raw = [p.clone().requires_grad_(True) for p in params]
    scaled = [p * s if i < n_scaled else p for i, p in enumerate(raw)]
    out, lad = FAMILIES[family][1](x, *scaled, tail_bound=B)
    ref = torch.autograd.grad((out, lad), raw, (g_out, g_lad))
    got = FAMILIES[family][2](x, *[p.detach() for p in scaled], g_out, g_lad, tail_bound=B,
                              wh_scale=s)
    for i, (g, r) in enumerate(zip(got[1:], ref)):
        torch.testing.assert_close(g, r, atol=1e-10, rtol=1e-10)
        assert g.abs().max() > 0, f"parameter array {i} got no cotangent"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_outside_the_tails_the_layer_is_the_identity(family):
    x, params, g_out, g_lad = _inputs(family, 8, seed=4, scale=1.0)
    x, g_out, g_lad = (torch.from_numpy(a) for a in (x, g_out, g_lad))
    g_x, *g_params = FAMILIES[family][2](x, *[torch.from_numpy(p) for p in params], g_out,
                                         g_lad, tail_bound=B)
    outside = x.abs() > B
    assert outside.any()
    assert torch.equal(g_x[outside], g_out[outside])
    assert not any(g[outside].any() for g in g_params)
