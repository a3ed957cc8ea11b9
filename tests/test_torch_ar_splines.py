"""The port's linear, quadratic, cubic and linear-rational masked
autoregressive transforms against the JAX package's on the CPU, after
``load_jax_params``: each transform forward and inverse, with and without a
context, with the tails each takes (the quadratic and linear-rational ones
bounded and with linear tails; the linear and cubic ones take no tails and
run the bounded splines on [0, 1]); flows of 3 layers built from them
(``log_prob``, and sampling compared as ``transform.inverse`` of the same
base noise); each family's width rescale and parameter count; and the
fused serving and training paths, which take none of these transforms.

Tolerances, as tests/test_torch_autoregressive.py sets them: forward and
``log_prob`` 1e-4 (the fp32 interop bar); the inverse 2e-4 on outputs and
logabsdet (a fixed point of as many MADE passes as there are features,
each feeding its rounding into the next); the round trip 2e-4. The cubic
spline's logabsdet 5e-4 and its inverse 1e-3, the JAX package's bars for
its cubic splines (tests/ops/test_pallas_cubic.py): its inverse solves a
cubic a bin.
"""

import jax
import numpy as np
import pytest
import torch

from nflows_tpu.distributions import StandardNormal as JaxStandardNormal
from nflows_tpu.flows.base import Flow as JaxFlow
from nflows_tpu.transforms import autoregressive as jax_ar
from nflows_tpu.transforms.base import CompositeTransform as JaxComposite
from nflows_tpu.transforms.permutations import ReversePermutation as JaxReverse
from nflows_tpu_torch import CompiledFlow, Flow, fused_trainer, load_jax_params
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf
from nflows_tpu_torch.transforms import CompositeTransform, ReversePermutation
from nflows_tpu_torch.transforms import autoregressive as torch_ar

torch.set_num_threads(1)

HIDDEN = 16
B = 3.0
# kind -> (class name, constructor arguments, parameters a feature at K = 4)
TRANSFORMS = {
    "linear": ("MaskedPiecewiseLinearAutoregressiveTransform", dict(num_bins=4), 4),
    "cubic": ("MaskedPiecewiseCubicAutoregressiveTransform", dict(num_bins=4), 10),
    "quadratic": ("MaskedPiecewiseQuadraticAutoregressiveTransform",
                  dict(num_bins=4, tails=None), 9),
    "quadratic_linear_tails": ("MaskedPiecewiseQuadraticAutoregressiveTransform",
                               dict(num_bins=4, tails="linear", tail_bound=B), 7),
    "lrs": ("MaskedPiecewiseLinearRationalAutoregressiveTransform",
            dict(num_bins=4, tails=None), 17),
    "lrs_linear_tails": ("MaskedPiecewiseLinearRationalAutoregressiveTransform",
                         dict(num_bins=4, tails="linear", tail_bound=B), 15),
}


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _bounded(kind):
    return not kind.endswith("linear_tails")


def _transform_pair(kind, features, context_features, seed=0):
    name, extra, _ = TRANSFORMS[kind]
    kw = dict(features=features, hidden_features=HIDDEN, num_blocks=2,
              context_features=context_features, **extra)
    jt = getattr(jax_ar, name)(key=jax.random.key(seed), **kw)
    tt = getattr(torch_ar, name)(device="cpu", **kw)
    load_jax_params(tt, _jax_params(jt))
    return jt, tt.eval()


def _inputs(kind, seed, shape):
    rng = np.random.default_rng(seed)
    if _bounded(kind):
        return rng.uniform(0.02, 0.98, size=shape).astype(np.float32)
    x = (1.5 * rng.standard_normal(shape)).astype(np.float32)
    x.reshape(-1)[:2] = [B + 0.5, -B - 0.5]
    return x


def _tols(kind):
    """(forward logabsdet, inverse outputs and logabsdet)."""
    return (5e-4, 1e-3) if kind == "cubic" else (1e-4, 2e-4)


def _close(a, b, atol):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("context_features", [None, 3])
@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_transform_matches_jax(kind, context_features):
    features = 5
    jt, tt = _transform_pair(kind, features, context_features, seed=len(kind))
    x = _inputs(kind, 1, (33, features))
    ctx = (None if context_features is None
           else np.random.default_rng(2).standard_normal((33, context_features)).astype(
               np.float32))
    tctx = None if ctx is None else torch.from_numpy(ctx)
    lad_tol, inv_tol = _tols(kind)
    with torch.no_grad():
        y, lad = tt.forward(torch.from_numpy(x), tctx)
        back, lad_back = tt.inverse(torch.from_numpy(x), tctx)
        again, _ = tt.forward(back, tctx)
    jy, jlad = jt.forward(x, ctx)
    jback, jlad_back = jt.inverse(x, ctx)
    _close(y, jy, 1e-4)
    _close(lad, jlad, lad_tol)
    _close(back, jback, inv_tol)
    _close(lad_back, jlad_back, inv_tol)
    _close(again, x, inv_tol)


RESCALED = {"linear": (), "quadratic": ("widths",), "cubic": ("widths", "heights"),
            "lrs": ("widths", "heights")}


@pytest.mark.parametrize("kind", sorted(RESCALED))
def test_parameter_counts_and_width_rescales(kind):
    """Parameters a feature: quadratic 2K - 1 with linear tails and 2K + 1
    without, cubic 2K + 2, linear-rational 4K - 1 / 4K + 1, linear K. The
    1/sqrt(hidden) rescale before the spline: linear none, quadratic the
    widths only (the reference's rule), cubic and linear-rational widths and
    heights."""
    for k in (kind, f"{kind}_linear_tails"):
        if k in TRANSFORMS:
            _, tt = _transform_pair(k, 5, None)
            per_feature = TRANSFORMS[k][2]
            assert tt._output_dim_multiplier() == per_feature
            assert tt.autoregressive_net.final_layer.out_features == 5 * per_feature
    _, tt = _transform_pair(kind, 5, None)
    s = tt._hidden_scale()
    assert s == pytest.approx(1.0 / np.sqrt(HIDDEN))
    K, M = tt.num_bins, tt._output_dim_multiplier()
    x = torch.from_numpy(_inputs(kind, 3, (8, 5)))
    params = torch.randn(8, 5, M, generator=torch.Generator().manual_seed(0))
    expected = params.clone()
    for group in RESCALED[kind]:
        cols = slice(0, K) if group == "widths" else slice(K, 2 * K)
        expected[..., cols] *= s
    with torch.no_grad():
        got, got_lad = tt._elementwise(x, params.reshape(8, -1))
        want, want_lad = _plain_spline(tt, x, expected)
    assert torch.equal(got, want) and torch.equal(got_lad, want_lad.sum(dim=1))


def _plain_spline(tt, x, params):
    """The transform's bounded spline on ``params`` as given, no rescale."""
    from nflows_tpu_torch.ops import splines

    K = tt.num_bins
    if isinstance(tt, torch_ar.MaskedPiecewiseLinearAutoregressiveTransform):
        return splines.linear_spline(x, params)
    if isinstance(tt, torch_ar.MaskedPiecewiseQuadraticAutoregressiveTransform):
        return splines.quadratic_spline(x, params[..., :K], params[..., K:])
    if isinstance(tt, torch_ar.MaskedPiecewiseCubicAutoregressiveTransform):
        return splines.cubic_spline(x, params[..., :K], params[..., K:2 * K],
                                    params[..., 2 * K:2 * K + 1], params[..., 2 * K + 1:])
    return splines.linear_rational_spline(x, params[..., :K], params[..., K:2 * K],
                                          params[..., 3 * K:], params[..., 2 * K:3 * K])


def _flow_pair(kind, features, seed=0, layers=3):
    name, extra, _ = TRANSFORMS[kind]
    keys = jax.random.split(jax.random.key(seed), layers)
    jchain, tchain = [], []
    for i in range(layers):
        kw = dict(features=features, hidden_features=HIDDEN, num_blocks=2, **extra)
        jchain += [JaxReverse(features), getattr(jax_ar, name)(key=keys[i], **kw)]
        tchain += [ReversePermutation(features, device="cpu"),
                   getattr(torch_ar, name)(device="cpu", **kw)]
    jflow = JaxFlow(JaxComposite(jchain), JaxStandardNormal([features]))
    tflow = Flow(CompositeTransform(tchain), StandardNormal([features]))
    load_jax_params(tflow, _jax_params(jflow))
    return jflow, tflow.eval()


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_flow_matches_jax(kind):
    """log_prob, and sampling as the inverse chain of the same base noise
    (noise in (0, 1) for the bounded splines, whose domain it is)."""
    features = 5
    jflow, tflow = _flow_pair(kind, features, seed=len(kind))
    x = _inputs(kind, 4, (33, features))
    z = _inputs(kind, 5, (33, features))
    lad_tol, inv_tol = _tols(kind)
    with torch.no_grad():
        lp = tflow.log_prob(torch.from_numpy(x))
        s, s_lad = tflow.transform.inverse(torch.from_numpy(z))
    _close(lp, jflow.log_prob(x), lad_tol)
    j_s, j_lad = jflow.transform.inverse(z)
    _close(s, j_s, inv_tol)
    _close(s_lad, j_lad, inv_tol)


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_fusers_refuse_the_new_transforms(kind):
    """``fuse_maf`` takes exactly the affine and RQ AR classes (B9 has no
    stage for these transformers): it refuses each new class, CompiledFlow
    serves the flow unfused, and no fused trainer takes it."""
    _, tflow = _flow_pair(kind, 4, layers=2)
    with pytest.raises(ValueError, match="only affine / RQ-spline"):
        fuse_maf(tflow)
    served = CompiledFlow(tflow, batch_size=16, features=4, device="cpu")
    assert not served.is_fused
    x = torch.from_numpy(_inputs(kind, 6, (16, 4)))
    with torch.no_grad():
        assert torch.equal(served.log_prob(x), tflow.log_prob(x))
    assert fused_trainer(tflow, 128, required=False) is None
