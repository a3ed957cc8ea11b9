"""The port's elementwise nonlinearities and learned CDFs
(``nflows_tpu_torch.transforms.nonlinearities``) against the JAX package's
on the CPU, on the same numpy inputs and, for the CDFs, after
``load_jax_params``: each of the fifteen classes forward and inverse, at
the domain edges where the JAX package clamps instead of raising
(``Exp.inverse`` at 0, ``Tanh`` and ``CauchyCDF`` inverses at their ends,
``Sigmoid`` and ``Logit`` at 0 and 1), ``LogTanh`` on both sides of its
cut point, ``Sigmoid`` fixed and learned, ``GatedLinearUnit`` with a
[N, 1] context, a ``CompositeCDFTransform``; the five spline CDFs bounded
and with linear tails, their parameters' gradients against ``jax.grad``,
and ``identity_init``.

Tolerances: 1e-4 absolute on outputs and logabsdet (the fp32 interop bar,
MIGRATION.md), except where a value is large by construction: at a clamped
edge the outputs reach 8.3 (Tanh), 1.6e6 (CauchyCDF at 1e-7 from an end)
and the logabsdet 87 (Exp at 0), so there the bar is 1e-4 of the largest
|value| as well (rtol 1e-6 on a fp32 number of that size is one or two
ulps). Tanh's forward logabsdet log1p(-tanh(x)^2) cancels for |x| past
3: one ulp between XLA's tanh and PyTorch's moves it by up to 1.4e-5 of
its size (measured, at x = 4.5, a logabsdet of -10.5), so there the bar is
1e-4 of the size. LogTanh's inverse tails are exp(y / alpha) / beta,
up to 4e3 on these inputs: 1e-6 of the size beside 1e-4. The cubic CDF's logabsdet 5e-4, the JAX package's bar for its cubic
splines (tests/ops/test_pallas_cubic.py). Parameter gradients are sums over
the batch: 1e-4 absolute plus 1e-4 of their size.
"""

import jax
import numpy as np
import pytest
import torch

from nflows_tpu.core.module import combine, partition
from nflows_tpu.transforms import nonlinearities as jnl
from nflows_tpu_torch import load_jax_params
from nflows_tpu_torch.interop import _jax_key_to_name
from nflows_tpu_torch.transforms import nonlinearities as tnl

torch.set_num_threads(1)

ATOL = 1e-4
F = 3
B = 3.0


def _leaves(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _load(jmod, tmod):
    load_jax_params(tmod, _leaves(jmod))
    return tmod


def _close(a, b, atol=ATOL, rtol=0.0):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


def _normal(seed, shape=(64, F), scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _unit(seed, shape=(64, F)):
    """Points of (0, 1) and the two ends."""
    u = np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)
    u[0, :] = 0.0
    u[1, :] = 1.0
    return u


def _compare(jt, tt, x, direction, context=None, atol=ATOL, rtol=0.0):
    tc = None if context is None else torch.from_numpy(context)
    with torch.no_grad():
        y, lad = getattr(tt, direction)(torch.from_numpy(x), tc)
    j_y, j_lad = getattr(jt, direction)(x, context)
    assert torch.isfinite(y).all() and torch.isfinite(lad).all()
    assert tuple(lad.shape) == (x.shape[0],)
    _close(y, j_y, atol, rtol)
    _close(lad, j_lad, atol, rtol)


# name -> (JAX transform, port transform, forward inputs, inverse inputs)
ELEMENTWISE = {
    "Exp": (jnl.Exp(), tnl.Exp(), _normal(1), _unit(2) * 5.0),
    "Tanh": (jnl.Tanh(), tnl.Tanh(), _normal(3), 2.0 * _unit(4) - 1.0),
    "LeakyReLU": (jnl.LeakyReLU(0.1), tnl.LeakyReLU(0.1), _normal(5), _normal(6)),
    "Sigmoid_fixed": (jnl.Sigmoid(temperature=2.0), tnl.Sigmoid(temperature=2.0),
                      _normal(7), _unit(8)),
    "Logit": (jnl.Logit(temperature=0.5), tnl.Logit(temperature=0.5), _unit(9), _normal(10)),
    "CauchyCDF": (jnl.CauchyCDF(), tnl.CauchyCDF(), _normal(11), _unit(12)),
    "CauchyCDFInverse": (jnl.CauchyCDFInverse(), tnl.CauchyCDFInverse(), _unit(13),
                         _normal(14)),
}
# values made large by a clamp at a domain edge (see the module doc)
EDGE_RTOL = {("Tanh", "forward"): 1e-4, ("Exp", "inverse"): 1e-6, ("Tanh", "inverse"): 1e-6,
             ("CauchyCDF", "inverse"): 1e-6, ("CauchyCDFInverse", "forward"): 1e-6,
             ("Sigmoid_fixed", "inverse"): 1e-6, ("Logit", "forward"): 1e-6}


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_matches_jax(name, direction):
    jt, tt, x_fwd, x_inv = ELEMENTWISE[name]
    assert not list(tt.parameters())
    x = x_fwd if direction == "forward" else x_inv
    _compare(jt, tt, x, direction, rtol=EDGE_RTOL.get((name, direction), 0.0))


def test_domain_edges_clamp_as_in_jax():
    """The JAX package clamps where the reference raises: log of the
    smallest normal number, atanh and tan of 1e-7 inside the ends, the
    logit of eps inside them."""
    zero = np.zeros((1, 1), np.float32)
    one = np.ones((1, 1), np.float32)
    y, lad = tnl.Exp().inverse(torch.from_numpy(zero))
    assert float(y) == pytest.approx(float(np.log(np.finfo(np.float32).tiny)))
    assert float(lad) == pytest.approx(-float(y))
    for edge in (one, -one):
        y, _ = tnl.Tanh().inverse(torch.from_numpy(edge))
        assert np.isfinite(float(y)) and np.sign(float(y)) == np.sign(edge[0, 0])
    y, _ = tnl.CauchyCDF().inverse(torch.from_numpy(zero))
    assert np.isfinite(float(y)) and float(y) < -1e6
    y, _ = tnl.Sigmoid(eps=1e-6).inverse(torch.from_numpy(one))
    top = np.float32(1 - 1e-6)
    assert float(y) == pytest.approx(float(np.log(top) - np.log1p(-top)), rel=1e-6)


@pytest.mark.parametrize("cut_point", [1.0, 0.5])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_logtanh_matches_jax_on_both_sides_of_its_cut(cut_point, direction):
    jt, tt = jnl.LogTanh(cut_point), tnl.LogTanh(cut_point)
    assert (tt.alpha, tt.beta, tt.inv_cut_point) == (jt.alpha, jt.beta, jt.inv_cut_point)
    cut = cut_point if direction == "forward" else tt.inv_cut_point
    x = _normal(15, scale=2.0)
    x[0] = [cut, -cut, 0.0]
    x[1] = [cut * 1.001, -cut * 1.001, 0.999 * cut]
    x[2] = [4.0 * cut, -4.0 * cut, -0.999 * cut]
    assert (x > cut).any() and (x < -cut).any() and (np.abs(x) < cut).any()
    _compare(jt, tt, x, direction, rtol=1e-6 if direction == "inverse" else 0.0)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_sigmoid_with_a_learned_temperature_matches_jax(direction):
    jt = jnl.Sigmoid(temperature=1.5, learn_temperature=True)
    tt = _load(jt, tnl.Sigmoid(temperature=0.3, learn_temperature=True))
    assert [n for n, _ in tt.named_parameters()] == ["temperature"]
    assert float(tt.temperature.detach()) == 1.5
    x = _normal(16) if direction == "forward" else _unit(17)
    _compare(jt, tt, x, direction, rtol=1e-6)


def test_a_fixed_temperature_is_no_leaf():
    """A fixed temperature is neither a parameter nor a persistent buffer
    (the JAX module has no leaf for it, and load_jax_params would report a
    missing key); a Logit of it carries as a JAX Logit does."""
    for t in (tnl.Sigmoid(temperature=2.0), tnl.Logit(temperature=2.0)):
        assert not t.state_dict()
    assert _leaves(jnl.Sigmoid(temperature=2.0)) == {}
    _load(jnl.Logit(2.0), tnl.Logit(2.0))


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_gated_linear_unit_matches_jax(direction):
    context = _normal(18, shape=(64, 1))
    _compare(jnl.GatedLinearUnit(), tnl.GatedLinearUnit(), _normal(19), direction,
             context=context)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_composite_cdf_transform_matches_jax(direction):
    """Sigmoid squash, a bounded RQ CDF, then the squash's inverse: one
    Sigmoid in two places in both packages."""
    jt = jnl.CompositeCDFTransform(
        jnl.Sigmoid(learn_temperature=True),
        jnl.PiecewiseRationalQuadraticCDF([F], num_bins=4, key=jax.random.key(0)))
    tt = tnl.CompositeCDFTransform(
        tnl.Sigmoid(learn_temperature=True),
        tnl.PiecewiseRationalQuadraticCDF([F], num_bins=4))
    assert tt.transforms[0] is tt.transforms[2].transform
    _load(jt, tt)
    _compare(jt, tt, _normal(20), direction)


CDFS = {
    "linear": (jnl.PiecewiseLinearCDF, tnl.PiecewiseLinearCDF),
    "quadratic": (jnl.PiecewiseQuadraticCDF, tnl.PiecewiseQuadraticCDF),
    "cubic": (jnl.PiecewiseCubicCDF, tnl.PiecewiseCubicCDF),
    "rq": (jnl.PiecewiseRationalQuadraticCDF, tnl.PiecewiseRationalQuadraticCDF),
    "lrs": (jnl.PiecewiseLinearRationalCDF, tnl.PiecewiseLinearRationalCDF),
}
# the parameters of each CDF and their last dims (K bins): linear tails
# take K - 1 derivatives (rq, lrs) and K - 1 heights (quadratic)
WIDTHS = {
    "linear": {"unnormalized_pdf": lambda K, lin: K},
    "quadratic": {"unnormalized_widths": lambda K, lin: K,
                  "unnormalized_heights": lambda K, lin: K - 1 if lin else K + 1},
    "cubic": {"unnormalized_widths": lambda K, lin: K, "unnormalized_heights": lambda K, lin: K,
              "unnorm_derivatives_left": lambda K, lin: 1,
              "unnorm_derivatives_right": lambda K, lin: 1},
    "rq": {"unnormalized_widths": lambda K, lin: K, "unnormalized_heights": lambda K, lin: K,
           "unnormalized_derivatives": lambda K, lin: K - 1 if lin else K + 1},
    "lrs": {"unnormalized_widths": lambda K, lin: K, "unnormalized_heights": lambda K, lin: K,
            "unnormalized_derivatives": lambda K, lin: K - 1 if lin else K + 1,
            "unnormalized_lambdas": lambda K, lin: K},
}


def _cdf_pair(family, tails, seed=0, bins=5):
    jcls, tcls = CDFS[family]
    kw = dict(num_bins=bins, tails=tails, tail_bound=B)
    jt = jcls([F], key=jax.random.key(seed), **kw)
    return jt, _load(jt, tcls([F], **kw))


def _cdf_inputs(tails, seed):
    if tails is None:
        return _unit(seed)
    x = _normal(seed)
    x[0] = [B, -B, B + 0.5]
    return x


def _lad_atol(family):
    return 5e-4 if family == "cubic" else ATOL


@pytest.mark.parametrize("tails", [None, "linear"])
@pytest.mark.parametrize("family", sorted(CDFS))
def test_cdf_matches_jax(family, tails):
    jt, tt = _cdf_pair(family, tails)
    shapes = {n: tuple(p.shape) for n, p in tt.named_parameters()}
    assert shapes == {n: (F, w(5, tails == "linear")) for n, w in WIDTHS[family].items()}
    for direction, seed in (("forward", 21), ("inverse", 22)):
        x = _cdf_inputs(tails, seed)
        with torch.no_grad():
            y, lad = getattr(tt, direction)(torch.from_numpy(x))
        j_y, j_lad = getattr(jt, direction)(x)
        _close(y, j_y)
        _close(lad, j_lad, _lad_atol(family))


@pytest.mark.parametrize("tails", [None, "linear"])
@pytest.mark.parametrize("family", sorted(CDFS))
def test_cdf_parameter_gradients_match_jax_grad(family, tails):
    """d/dparams of sum(1.3 y + 0.7 logabsdet) over the batch, both
    directions: the expand over the batch sums each row's cotangents back
    onto its parameter row, as JAX's broadcast_to does."""
    jt, tt = _cdf_pair(family, tails, seed=1)
    for direction, seed in (("forward", 23), ("inverse", 24)):
        x = _cdf_inputs(tails, seed)
        params, rest = partition(jt)

        def loss(p, x=x, direction=direction, rest=rest):
            y, lad = getattr(combine(p, rest), direction)(x)
            return (1.3 * y).sum() + (0.7 * lad).sum()

        j_grads = {_jax_key_to_name(k): v for k, v in _leaves(jax.grad(loss)(params)).items()}
        tt.zero_grad()
        y, lad = getattr(tt, direction)(torch.from_numpy(x))
        ((1.3 * y).sum() + (0.7 * lad).sum()).backward()
        t_grads = {n: p.grad.numpy() for n, p in tt.named_parameters()}
        assert set(t_grads) == set(j_grads)
        for n, g in t_grads.items():
            assert np.abs(g).max() > 0.0, n
            np.testing.assert_allclose(g, j_grads[n], atol=ATOL, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("tails", [None, "linear"])
def test_identity_init_is_the_identity_in_both_packages(tails):
    jt = jnl.PiecewiseRationalQuadraticCDF([F], num_bins=6, tails=tails, tail_bound=B,
                                           identity_init=True)
    tt = tnl.PiecewiseRationalQuadraticCDF([F], num_bins=6, tails=tails, tail_bound=B,
                                           identity_init=True)
    for (k, v), (n, p) in zip(sorted(_leaves(jt).items()), sorted(tt.state_dict().items())):
        assert _jax_key_to_name(k) == n
        np.testing.assert_array_equal(p.numpy(), v)
    x = _cdf_inputs(tails, 25)
    for direction in ("forward", "inverse"):
        with torch.no_grad():
            y, lad = getattr(tt, direction)(torch.from_numpy(x))
        j_y, j_lad = getattr(jt, direction)(x)
        for out, l in ((y, lad), (j_y, j_lad)):
            _close(out, x, 1e-5)
            _close(l, np.zeros(x.shape[0]), 1e-5)


def test_cdf_shares_its_rows_across_the_batch():
    """One parameter row a feature: every sample sees the same spline."""
    tt = tnl.PiecewiseQuadraticCDF(F, num_bins=4, tails="linear", tail_bound=B,
                                   generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_normal(26))
    y, lad = tt(x)
    y1, lad1 = tt(x[5:6])
    assert torch.equal(y[5:6], y1) and torch.equal(lad[5:6], lad1)


@pytest.mark.parametrize("module", ["nonlinearities", "umnn", "autoregressive", "coupling"])
def test_exports_match_jax(module):
    """Each ported module exports the JAX module's names, and the transforms
    package every class the JAX package re-exports from it."""
    import importlib

    import nflows_tpu.transforms as jax_transforms
    import nflows_tpu_torch.transforms as torch_transforms

    jmod = importlib.import_module(f"nflows_tpu.transforms.{module}")
    tmod = importlib.import_module(f"nflows_tpu_torch.transforms.{module}")
    assert sorted(tmod.__all__) == sorted(jmod.__all__)
    for name in jmod.__all__:
        if hasattr(jax_transforms, name):
            assert getattr(torch_transforms, name) is getattr(tmod, name)
