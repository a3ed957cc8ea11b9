"""The hand-derived adjoint of the RQ spline's forward branch
(``rq_spline_forward_adjoint_plain``, the plain version of
``csrc/rq_spline_bwd.cuh``) against ``torch.autograd`` of the plain spline
and against ``jax.grad`` of the JAX package's spline, on the same numpy
inputs: points inside every bin and in both tails, parameters from N(0, 1).

Tolerance. Float64 against autograd: 1e-10 absolute and relative (the two
differ only in the order of a few operations). Float32 against autograd and
against ``jax.grad``: 1e-4 absolute plus 1e-4 relative for parameters at
scale 0.5; with N(0, 1) parameters a bin can be ~1e-2 wide with a slope near
1e-3, where gradients reach ~1e2 and fp32 rounding alone moves them by 1e-3
of their value, so those are held to 2e-3 relative. Inputs exactly on +-B are
left out: JAX's ``clip`` halves the derivative at its tie, torch's ``clamp``
does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.ops import splines as jax_splines
from nflows_tpu_torch.ops.splines import rational_quadratic as rq

torch.set_num_threads(1)

B = 3.0


def _inputs(K, seed, scale, n=600):
    rng = np.random.default_rng(seed)
    # a grid through every bin and both tails, jittered off the bin edges
    x = np.linspace(-B - 1.0, B + 1.0, n) + 1e-3 * rng.standard_normal(n)
    x = x[np.abs(np.abs(x) - B) > 1e-6].astype(np.float32)
    n = x.shape[0]
    w, h, d = (np.float32(scale) * rng.standard_normal((n, k)).astype(np.float32)
               for k in (K, K, K - 1))
    g_out, g_lad = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    return x, w, h, d, g_out, g_lad


def _autograd(x, w, h, d, g_out, g_lad):
    leaves = [t.clone().requires_grad_(True) for t in (x, w, h, d)]
    out, lad = rq.unconstrained_rational_quadratic_spline_plain(*leaves, tail_bound=B)
    return torch.autograd.grad((out, lad), leaves, (g_out, g_lad))


def _bins_hit(x, w, K):
    """Indices of the bins the inside points fall in."""
    widths, cum = rq._edges(w, K, rq.DEFAULT_MIN_BIN_WIDTH, -B, B)
    inside = x.abs() <= B
    return set(torch.searchsorted(cum[inside][:, 1:-1].contiguous(),
                                  x[inside][:, None]).flatten().tolist())


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("dtype,scale,atol,rtol", [
    (torch.float64, 1.0, 1e-10, 1e-10),
    (torch.float32, 0.5, 1e-4, 1e-4),
    (torch.float32, 1.0, 1e-4, 2e-3),
])
def test_adjoint_matches_autograd(K, dtype, scale, atol, rtol):
    arrays = [torch.from_numpy(a).to(dtype) for a in _inputs(K, seed=K, scale=scale)]
    x, w = arrays[0], arrays[1]
    assert _bins_hit(x, w, K) == set(range(K))      # every bin
    assert (x > B).any() and (x < -B).any()          # both tails
    got = rq.rq_spline_forward_adjoint_plain(*arrays, tail_bound=B)
    for g, ref in zip(got, _autograd(*arrays)):
        torch.testing.assert_close(g, ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("scale,rtol", [(0.5, 1e-4), (1.0, 2e-3)])
def test_adjoint_matches_jax_grad(K, scale, rtol):
    x, w, h, d, g_out, g_lad = _inputs(K, seed=10 + K, scale=scale)

    def mixed(x, w, h, d):
        out, lad = jax_splines.unconstrained_rational_quadratic_spline(
            x, w, h, d, inverse=False, tails="linear", tail_bound=B)
        return jnp.sum(out * g_out) + jnp.sum(lad * g_lad)

    ref = jax.grad(mixed, argnums=(0, 1, 2, 3))(x, w, h, d)
    got = rq.rq_spline_forward_adjoint_plain(
        *[torch.from_numpy(a) for a in (x, w, h, d, g_out, g_lad)], tail_bound=B)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=rtol)


def test_outside_the_tails_the_layer_is_the_identity():
    x, w, h, d, g_out, g_lad = (torch.from_numpy(a) for a in _inputs(8, seed=3, scale=1.0))
    g_x, g_w, g_h, g_d = rq.rq_spline_forward_adjoint_plain(
        x, w, h, d, g_out, g_lad, tail_bound=B)
    outside = x.abs() > B
    assert outside.any()
    assert torch.equal(g_x[outside], g_out[outside])
    assert not g_w[outside].any() and not g_h[outside].any() and not g_d[outside].any()


def test_boundary_bins_have_no_slope_gradient_at_the_edges():
    """In the first bin only the upper slope is a parameter, in the last only
    the lower one: the slopes at +-B are constants."""
    K = 4
    x, w, h, d, g_out, g_lad = (torch.from_numpy(a) for a in _inputs(K, seed=5, scale=0.3))
    _, cum = rq._edges(w, K, rq.DEFAULT_MIN_BIN_WIDTH, -B, B)
    _, _, _, g_d = rq.rq_spline_forward_adjoint_plain(x, w, h, d, g_out, g_lad, tail_bound=B)
    first = (x >= -B) & (x < cum[:, 1])
    last = (x <= B) & (x >= cum[:, K - 1])
    assert first.any() and last.any()
    assert g_d[first][:, 0].abs().min() > 0 and not g_d[first][:, 1:].any()
    assert g_d[last][:, -1].abs().min() > 0 and not g_d[last][:, :-1].any()
