"""The port's RQ spline (kernel B1's plain version and its autograd wrapper)
against the JAX package: the XLA implementation and the Pallas kernel in
interpret mode. Same numpy inputs into both; fp32 on the CPU.

Tolerance: atol 1e-4, rtol 0 on outputs and logabsdet (the fp32 interop
bar); gradients atol 1e-4 and rtol 1e-4. The relative part is needed by
the inverse direction, whose input gradients reach ~20 here (one over the
slope of a steep bin): fp32 rounding alone differs there by 7.4e-6 of the
value (measured 1.4e-4 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.ops import splines as jax_splines
from nflows_tpu.ops.pallas.rq_spline import rq_spline_pallas
from nflows_tpu_torch.ops.cuda import rq_spline as b1
from nflows_tpu_torch.ops.cuda._spline_common import KernelSpline
from nflows_tpu_torch.ops.splines import rational_quadratic as rq

torch.set_num_threads(1)

B = 3.0
ATOL = 1e-4


def _inputs(K, seed=0, shape=(64, 6), on_bound=True, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (2.5 * rng.standard_normal(shape)).astype(np.float32)  # tails included
    if on_bound:
        x.reshape(-1)[:4] = [B, -B, np.nextafter(B, 0), -np.nextafter(B, 0)]
    w = (scale * rng.standard_normal(shape + (K,))).astype(np.float32)
    h = (scale * rng.standard_normal(shape + (K,))).astype(np.float32)
    d = (scale * rng.standard_normal(shape + (K - 1,))).astype(np.float32)
    return x, w, h, d


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _close_grad(a, b):
    _close(a, b, rtol=1e-4)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_jax_xla_and_pallas(K, inverse):
    x, w, h, d = _inputs(K, seed=K)
    out, lad = rq.unconstrained_rational_quadratic_spline(
        *_torch(x, w, h, d), inverse=inverse, tail_bound=B)
    ref_out, ref_lad = jax_splines.unconstrained_rational_quadratic_spline(
        x, w, h, d, inverse=inverse, tails="linear", tail_bound=B)
    pl_out, pl_lad = rq_spline_pallas(x, w, h, d, inverse=inverse,
                                      tail_bound=B, interpret=True)
    _close(out, ref_out)
    _close(lad, ref_lad)
    _close(out, pl_out)
    _close(lad, pl_lad)
    # outside [-B, B]: identity with zero logabsdet
    outside = np.abs(x) > B
    assert outside.any()
    np.testing.assert_array_equal(out.numpy()[outside], x[outside])
    np.testing.assert_array_equal(lad.numpy()[outside], 0.0)


@pytest.mark.parametrize("K", [4, 8])
def test_wrapper_on_cpu_is_the_plain_version_and_round_trips(K):
    x, w, h, d = _torch(*_inputs(K, seed=10 + K))
    y, lad = b1.rq_spline_cuda(x, w, h, d, tail_bound=B)
    y_plain, lad_plain = rq.unconstrained_rational_quadratic_spline_plain(
        x, w, h, d, tail_bound=B)
    assert torch.equal(y, y_plain) and torch.equal(lad, lad_plain)
    x_rec, lad_inv = b1.rq_spline_cuda(y, w, h, d, inverse=True, tail_bound=B)
    _close(x_rec, x)
    _close(lad + lad_inv, torch.zeros_like(lad))


def _jax_grads(x, w, h, d, inverse):
    """Gradients of a fixed mix of outputs and logabsdet. Inputs exactly on
    +-B are left out of the gradient tests: there JAX's clip splits the
    derivative of its tie in half (once per clip, so 1/4), while torch's
    clamp passes the one-sided derivative through. Parameters are drawn at
    scale 0.5: with N(0, 1) parameters an inverse gradient through a bin of
    slope ~1e-3 differs in fp32 by 1.4e-3 of its value (measured), which is
    rounding, not the code under test."""
    def loss(x, w, h, d):
        out, lad = jax_splines.unconstrained_rational_quadratic_spline(
            x, w, h, d, inverse=inverse, tails="linear", tail_bound=B)
        return jnp.sum(out * 1.3) + jnp.sum(lad * 0.7)
    return jax.grad(loss, argnums=(0, 1, 2, 3))(x, w, h, d)


@pytest.mark.parametrize("inverse", [False, True])
def test_autograd_wrapper_gradients_match_jax(inverse, monkeypatch):
    """The autograd Function around B1 (forward = kernel, backward = plain
    version under autograd). On the CPU the kernel's place is taken by the
    plain forward, so the backward wiring itself is what runs."""
    plain = rq.unconstrained_rational_quadratic_spline_plain

    def plain_forward(*tensors, **statics):
        with torch.no_grad():
            return plain(*tensors, **statics)
    monkeypatch.setattr(b1, "_launch", plain_forward)

    arrays = _inputs(8, seed=20, on_bound=False, scale=0.5)
    leaves = [t.clone().requires_grad_(True) for t in _torch(*arrays)]
    out, lad = KernelSpline.apply(b1._launch, plain, dict(inverse=inverse, tail_bound=B),
                                  *leaves)
    (out * 1.3 + lad * 0.7).sum().backward()
    for leaf, ref in zip(leaves, _jax_grads(*arrays, inverse)):
        _close_grad(leaf.grad, ref)


def test_plain_gradients_match_jax():
    arrays = _inputs(4, seed=30, on_bound=False, scale=0.5)
    leaves = [t.clone().requires_grad_(True) for t in _torch(*arrays)]
    out, lad = b1.rq_spline_cuda(*leaves, tail_bound=B)
    (out * 1.3 + lad * 0.7).sum().backward()
    for leaf, ref in zip(leaves, _jax_grads(*arrays, False)):
        _close_grad(leaf.grad, ref)


def test_constrained_spline_matches_jax():
    x, w, h, _ = _inputs(6, seed=40)
    x = np.clip(x / 8.0 + 0.5, 0.0, 1.0)
    d = np.random.default_rng(41).standard_normal(w.shape[:-1] + (7,)).astype(np.float32)
    for inverse in (False, True):
        out, lad = rq.rational_quadratic_spline(*_torch(x, w, h, d), inverse=inverse)
        ref_out, ref_lad = jax_splines.rational_quadratic_spline(
            x, w, h, d, inverse=inverse)
        _close(out, ref_out)
        _close(lad, ref_lad)
