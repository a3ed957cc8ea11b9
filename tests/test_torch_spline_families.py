"""The port's linear-rational, linear, quadratic and cubic splines (the plain
versions of kernels B5-B8, and their autograd wrappers) against the JAX
package: the XLA implementation and the Pallas kernel in interpret mode, on
the same numpy inputs; fp32 on the CPU.

Tolerances: 1e-4 absolute on outputs and logabsdet (the fp32 interop bar),
except the cubic logabsdet, 5e-4 absolute, the bar the JAX package holds
its own cubic kernel to against its XLA path (tests/ops/test_pallas_cubic.py):
the log of a cubic's slope whose coefficients divide by the squared bin
width. Round trips: the JAX package's own bars for its kernels
(tests/ops/test_pallas_*.py): 1e-4 for the linear and quadratic splines,
1e-3 for the linear-rational (a forward Möbius piece, then its linear
inverse, each rounding through divisions by the piece's weights), 5e-3 for
the cubic (its bisection root). Gradients: 1e-4 absolute and relative, as
the RQ spline's (tests/test_torch_rq_spline.py), with parameters at scale
0.5; inputs exactly on +-B are left out of gradient checks (JAX's clip
splits the derivative of its tie, torch's clamp does not; ROADMAP §C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.ops import splines as jax_splines
from nflows_tpu.ops.pallas.cubic_spline import cubic_spline_pallas
from nflows_tpu.ops.pallas.linear_spline import linear_spline_pallas
from nflows_tpu.ops.pallas.lrs_spline import lrs_spline_pallas
from nflows_tpu.ops.pallas.quadratic_spline import quadratic_spline_pallas
from nflows_tpu_torch.ops import splines
from nflows_tpu_torch.ops.cuda import (
    _spline_common,
    cubic_spline,
    linear_spline,
    lrs_spline,
    quadratic_spline,
)

torch.set_num_threads(1)

B = 3.0
ATOL = 1e-4
ROUND_TRIP = {"lrs": 1e-3, "linear": ATOL, "quadratic": ATOL, "cubic": 5e-3}

# name -> (parameter widths for K, JAX XLA, JAX Pallas, port dispatching
# function, port plain version, wrapper module, wrapper, logabsdet atol)
FAMILIES = {
    "lrs": (lambda K: (K, K, K - 1, K),
            jax_splines.unconstrained_linear_rational_spline, lrs_spline_pallas,
            splines.unconstrained_linear_rational_spline,
            splines.linear_rational.unconstrained_linear_rational_spline_plain,
            lrs_spline, lrs_spline.lrs_spline_cuda, ATOL),
    "linear": (lambda K: (K,),
               jax_splines.unconstrained_linear_spline, linear_spline_pallas,
               splines.unconstrained_linear_spline,
               splines.linear.unconstrained_linear_spline_plain,
               linear_spline, linear_spline.linear_spline_cuda, ATOL),
    "quadratic": (lambda K: (K, K - 1),
                  jax_splines.unconstrained_quadratic_spline, quadratic_spline_pallas,
                  splines.unconstrained_quadratic_spline,
                  splines.quadratic.unconstrained_quadratic_spline_plain,
                  quadratic_spline, quadratic_spline.quadratic_spline_cuda, ATOL),
    "cubic": (lambda K: (K, K, 1, 1),
              jax_splines.unconstrained_cubic_spline, cubic_spline_pallas,
              splines.unconstrained_cubic_spline,
              splines.cubic.unconstrained_cubic_spline_plain,
              cubic_spline, cubic_spline.cubic_spline_cuda, 5e-4),
}


def _inputs(family, K, seed=0, shape=(64, 6), on_bound=True, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (2.5 * rng.standard_normal(shape)).astype(np.float32)  # tails included
    if on_bound:
        x.reshape(-1)[:4] = [B, -B, np.nextafter(B, 0), -np.nextafter(B, 0)]
    params = [(scale * rng.standard_normal(shape + (p,))).astype(np.float32)
              for p in FAMILIES[family][0](K)]
    return [x] + params


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(a, b, atol=ATOL, rtol=0.0):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_jax_xla_and_pallas(family, K, inverse):
    _, jax_fn, pallas_fn, port_fn, _, _, _, lad_atol = FAMILIES[family]
    arrays = _inputs(family, K, seed=K)
    out, lad = port_fn(*_torch(arrays), inverse=inverse, tail_bound=B)
    ref_out, ref_lad = jax_fn(*arrays, inverse=inverse, tail_bound=B)
    pl_out, pl_lad = pallas_fn(*arrays, inverse=inverse, tail_bound=B, interpret=True)
    _close(out, ref_out)
    _close(lad, ref_lad, lad_atol)
    _close(out, pl_out)
    _close(lad, pl_lad, lad_atol)
    # outside [-B, B]: identity with zero logabsdet
    x = arrays[0]
    outside = np.abs(x) > B
    assert outside.any()
    np.testing.assert_array_equal(out.numpy()[outside], x[outside])
    np.testing.assert_array_equal(lad.numpy()[outside], 0.0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("K", [4, 8])
def test_wrapper_on_cpu_is_the_plain_version_and_round_trips(family, K):
    *_, plain, module, wrapper, _ = FAMILIES[family]
    x, *params = _torch(_inputs(family, K, seed=10 + K))
    before = module.launch_count
    y, lad = wrapper(x, *params, tail_bound=B)
    y_plain, lad_plain = plain(x, *params, tail_bound=B)
    assert torch.equal(y, y_plain) and torch.equal(lad, lad_plain)
    x_rec, lad_inv = wrapper(y, *params, inverse=True, tail_bound=B)
    assert module.launch_count == before  # a CPU tensor launches nothing
    trip = ROUND_TRIP[family]
    _close(x_rec, x, trip)
    _close(lad + lad_inv, torch.zeros_like(lad), trip)


def _jax_grads(family, arrays, inverse):
    """Gradients of a fixed mix of outputs and logabsdet, by jax.grad."""
    jax_fn = FAMILIES[family][1]

    def loss(*args):
        out, lad = jax_fn(*args, inverse=inverse, tail_bound=B)
        return jnp.sum(out * 1.3) + jnp.sum(lad * 0.7)
    return jax.grad(loss, argnums=tuple(range(len(arrays))))(*arrays)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_gradients_match_jax(family, inverse):
    """Every input's gradient, through the dispatching function; for the
    cubic inverse this is the Newton re-attachment's implicit derivative."""
    port_fn = FAMILIES[family][3]
    arrays = _inputs(family, 4, seed=30, on_bound=False, scale=0.5)
    leaves = [t.clone().requires_grad_(True) for t in _torch(arrays)]
    out, lad = port_fn(*leaves, inverse=inverse, tail_bound=B)
    (out * 1.3 + lad * 0.7).sum().backward()
    for leaf, ref in zip(leaves, _jax_grads(family, arrays, inverse)):
        _close(leaf.grad, ref, ATOL, 1e-4)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("inverse", [False, True])
def test_autograd_wrapper_gradients_match_jax(family, inverse, monkeypatch):
    """The autograd Function around each kernel (forward = kernel, backward =
    plain version under autograd). On the CPU the kernel's place is taken by
    the plain forward, so the backward wiring itself is what runs."""
    *_, plain, module, _, _ = FAMILIES[family]

    def plain_forward(*tensors, **statics):
        with torch.no_grad():
            return plain(*tensors, **statics)
    monkeypatch.setattr(module, "_launch", plain_forward)

    arrays = _inputs(family, 8, seed=20, on_bound=False, scale=0.5)
    leaves = [t.clone().requires_grad_(True) for t in _torch(arrays)]
    statics = dict(inverse=inverse, tail_bound=B)
    out, lad = _spline_common.KernelSpline.apply(module._launch, plain, statics, *leaves)
    (out * 1.3 + lad * 0.7).sum().backward()
    for leaf, ref in zip(leaves, _jax_grads(family, arrays, inverse)):
        _close(leaf.grad, ref, ATOL, 1e-4)


def test_cubic_inverse_has_parameter_sensitivity():
    """Without the Newton re-attachment the bisection root would carry no
    gradient to the parameters; with it the widths' gradient is non-zero."""
    arrays = _inputs("cubic", 8, seed=40, on_bound=False, scale=0.5)
    x, w, h, dl, dr = [t.clone().requires_grad_(True) for t in _torch(arrays)]
    out, _ = splines.unconstrained_cubic_spline(x, w, h, dl, dr, inverse=True, tail_bound=B)
    out.sum().backward()
    assert w.grad.abs().max() > 1e-3 and h.grad.abs().max() > 1e-3


def _unit_inputs(seed, shape=(64, 6)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, size=shape).astype(np.float32)  # clamps included
    x.reshape(-1)[:2] = [0.0, 1.0]
    return rng, x


@pytest.mark.parametrize("inverse", [False, True])
def test_constrained_splines_match_jax(inverse):
    """The splines without tails, on [0, 1]: LRS with K+1 derivatives,
    linear, quadratic with K+1 and with K-1 heights, cubic."""
    K = 6
    rng, x = _unit_inputs(50)
    p = lambda k: rng.standard_normal(x.shape + (k,)).astype(np.float32)  # noqa: E731
    cases = {
        "lrs": (splines.linear_rational_spline, jax_splines.linear_rational_spline,
                [x, p(K), p(K), p(K + 1), p(K)], ATOL),
        "linear": (splines.linear_spline, jax_splines.linear_spline, [x, p(K)], ATOL),
        "quadratic": (splines.quadratic_spline, jax_splines.quadratic_spline,
                      [x, p(K), p(K + 1)], ATOL),
        "quadratic, K-1 heights": (splines.quadratic_spline, jax_splines.quadratic_spline,
                                   [x, p(K), p(K - 1)], ATOL),
        "cubic": (splines.cubic_spline, jax_splines.cubic_spline,
                  [x, p(K), p(K), p(1), p(1)], 5e-4),
    }
    for name, (port_fn, jax_fn, arrays, lad_atol) in cases.items():
        out, lad = port_fn(*_torch(arrays), inverse=inverse)
        ref_out, ref_lad = jax_fn(*arrays, inverse=inverse)
        _close(out, ref_out)
        _close(lad, ref_lad, lad_atol)


def test_linear_forward_at_the_right_boundary_takes_the_last_bin():
    """floor(x K) at x = 1 is K; the clamp puts it in bin K-1, whose top is
    the top of the range and whose logabsdet is the last bin's."""
    up = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    out, lad = splines.linear_spline(torch.ones(3), up)
    _close(out, torch.ones(3))
    _close(lad, torch.log(torch.softmax(up, -1)[:, -1] * 5))


def test_unsupported_tails_and_shapes_raise():
    x, w, hq = _torch(_inputs("quadratic", 4, seed=1))
    with pytest.raises(NotImplementedError):
        splines.unconstrained_quadratic_spline(x, w, hq, tails="circular")
    with pytest.raises(ValueError):
        splines.unconstrained_quadratic_spline(x, w, torch.zeros(*x.shape, 5))
    with pytest.raises(ValueError):
        splines.linear_rational_spline(x, w, w, torch.zeros(*x.shape, 5), w,
                                       min_bin_width=0.3)
