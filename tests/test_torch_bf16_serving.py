"""Serving with bf16 weights on the CPU: the JAX package's default
deployment (``fuse_nsf``, ``fuse_maf`` and ``fuse_mademog`` with
``dtype=bfloat16``, ``CompiledFlow(dtype=bfloat16)``) against the port's.

- ``_extract`` in bf16 of B2, B9 and B11 equals the JAX one bit for bit: the
  softmax rescale and the masks are folded in fp32 before the cast.
- The bf16 plain versions of B2, B9 and B11 (every GEMM with its operand
  rounded to bf16 and the products summed in fp32) against the JAX Pallas
  kernels with bf16 weights in interpret mode, on the same weights and
  inputs. Tolerance: outputs atol 5e-4, logabsdet and log_prob 1e-3, rtol 0.
  An fp32 rounding difference ahead of a bf16 rounding can move that operand
  by 2^-9 of itself; measured up to 6.1e-5 on outputs and 1.0e-4 on the
  logabsdet. Each case also holds the plain result at least ten times
  further from the JAX fp32 kernel than from the bf16 one in mean |delta|,
  which a plain version that forgot to round would fail (the mean, since a
  rounding tie that flips moves a few samples of a fixed point by up to
  4e-4: the NSF-AR's inverse, 3 of 128).
- Round trips in bf16 through the plain B2 and B9 (1e-4).
- ``CompiledFlow(dtype=torch.bfloat16)``: the fused route equals the bf16
  fused views; the unfused route refuses fp32 arrays with a TypeError and,
  given bf16 ones, matches the JAX unfused endpoint (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.distributions import StandardNormal as JaxStandardNormal
from nflows_tpu.flows import MaskedAutoregressiveFlow as JaxMAF
from nflows_tpu.flows.base import Flow as JaxFlow
from nflows_tpu.models import NeuralSplineFlow as JaxNSF
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.nn import nets as jax_nets
from nflows_tpu.nn.nde.made import MixtureOfGaussiansMADE as JaxMoG
from nflows_tpu.ops.pallas import maf_fused as jax_maf_fused
from nflows_tpu.ops.pallas import mademog_fused as jax_mog_fused
from nflows_tpu.ops.pallas import nsf_fused as jax_nsf_fused
from nflows_tpu.ops.pallas.maf_flow_kernel import maf_flow_kernel_call
from nflows_tpu.ops.pallas.nsf_flow_kernel import nsf_flow_kernel_call
from nflows_tpu.serving import CompiledFlow as JaxCompiledFlow
from nflows_tpu.transforms import CompositeTransform as JaxComposite
from nflows_tpu.transforms import MaskedAffineAutoregressiveTransform as JaxAffineAR
from nflows_tpu.transforms import RandomPermutation as JaxRandomPermutation
from nflows_tpu.transforms import coupling as jax_coupling
from nflows_tpu.transforms.permutations import Permutation as JaxPermutation
from nflows_tpu_torch import (
    CompiledFlow,
    Flow,
    MaskedAutoregressiveFlow,
    MixtureOfGaussiansMADE,
    NeuralSplineFlow,
    NeuralSplineFlowAR,
    load_jax_params,
)
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.ops.cuda import (
    maf_flow_kernel,
    maf_fused,
    mademog_fused,
    nsf_flow_kernel,
    nsf_fused,
)
from nflows_tpu_torch.transforms import (
    AffineCouplingTransform,
    CompositeTransform,
    MaskedAffineAutoregressiveTransform,
    Permutation,
    PiecewiseCubicCouplingTransform,
    PiecewiseRationalQuadraticCouplingTransform,
    RandomPermutation,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
D, C, HIDDEN, N = 6, 3, 32, 128
OUT_ATOL, LAD_ATOL = 5e-4, 1e-3
COUPLINGS = {
    "rq": (jax_coupling.PiecewiseRationalQuadraticCouplingTransform,
           PiecewiseRationalQuadraticCouplingTransform),
    "cubic": (jax_coupling.PiecewiseCubicCouplingTransform, PiecewiseCubicCouplingTransform),
    "affine": (jax_coupling.AffineCouplingTransform, AffineCouplingTransform),
}


def _params(jax_module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax_module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _carry(jax_module, module):
    load_jax_params(module, _params(jax_module))
    return jax_module, module.eval()


def _x(n=N, width=D, seed=1, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, width))).astype(np.float32)


def _coupling_pair(family, context=None, layers=2, seed=0):
    """``layers`` x [permutation, ``family`` coupling with a 2-block
    ResidualNet] in both packages on the same weights."""
    jcls, tcls = COUPLINGS[family]
    kw = {} if family == "affine" else dict(num_bins=4, tails="linear", tail_bound=3.0)
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed), layers)
    mask = np.ones(D, dtype=np.float32)
    mask[::2] = -1
    jchain, tchain = [], []
    for i in range(layers):
        perm = rng.permutation(D)
        jchain.append(JaxPermutation(perm))
        tchain.append(Permutation(perm, device="cpu"))
        jchain.append(jcls(mask=mask, transform_net_create_fn=lambda i_, o_, k=keys[i]:
                           jax_nets.ResidualNet(i_, o_, hidden_features=HIDDEN, num_blocks=2,
                                                context_features=context, key=k), **kw))
        tchain.append(tcls(mask=mask, transform_net_create_fn=lambda i_, o_: nets.ResidualNet(
            i_, o_, hidden_features=HIDDEN, num_blocks=2, context_features=context,
            device="cpu"), device="cpu", **kw))
        mask = -mask
    jflow = JaxFlow(transform=JaxComposite(jchain), distribution=JaxStandardNormal([D]))
    return _carry(jflow, Flow(CompositeTransform(tchain), StandardNormal([D])))


def _ar_pair(kind, seed=0):
    """A MAF (affine), an NSF-AR (rq, 4 bins) or a conditional MAF
    (context 3) of 5 features, 2 layers of a 2-block residual MADE, in both
    packages on the same weights."""
    kw = dict(features=5, hidden_features=HIDDEN, num_layers=2, num_blocks_per_layer=2)
    if kind == "maf":
        return _carry(JaxMAF(key=jax.random.key(seed), **kw),
                      MaskedAutoregressiveFlow(device="cpu", **kw))
    if kind == "nsf_ar":
        kw.update(num_bins=4, tail_bound=3.0)
        return _carry(JaxNSFAR(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw),
                      NeuralSplineFlowAR(device="cpu", **kw))
    rng, keys = np.random.default_rng(seed), jax.random.split(jax.random.key(seed), 2)
    jchain, tchain = [], []
    for i in range(2):
        jchain += [JaxRandomPermutation(5, rng=rng),
                   JaxAffineAR(features=5, hidden_features=HIDDEN, context_features=C,
                               num_blocks=2, key=keys[i])]
        tchain += [RandomPermutation(5, device="cpu"),
                   MaskedAffineAutoregressiveTransform(5, HIDDEN, context_features=C,
                                                      num_blocks=2, device="cpu")]
    jflow = JaxFlow(transform=JaxComposite(jchain), distribution=JaxStandardNormal([5]))
    return _carry(jflow, Flow(CompositeTransform(tchain), StandardNormal([5])))


def _mog_pair(context=None, seed=0):
    kw = dict(features=5, hidden_features=HIDDEN, context_features=context, num_blocks=2,
              num_mixture_components=4)
    return _carry(JaxMoG(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw),
                  MixtureOfGaussiansMADE(device="cpu", **kw))


def _same_bits(t, j, name):
    """A port tensor and a JAX array hold the same values in the same dtype."""
    j = np.asarray(j)
    assert t.shape == j.shape, name
    if t.dtype == BF16:
        assert j.dtype == jnp.bfloat16, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                      j.view(np.uint16), err_msg=name)
    else:
        assert t.dtype == torch.float32 and j.dtype == np.float32, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


def _hold(got, bf16_ref, fp32_ref, atols):
    """``got`` (a tuple of arrays) within ``atols`` of the JAX bf16 kernel's
    results, and, array by array, at least ten times further from the JAX
    fp32 kernel's in mean |delta|."""
    for g, r16, r32, atol in zip(got, bf16_ref, fp32_ref, atols):
        g, r16, r32 = np.asarray(g), np.asarray(r16), np.asarray(r32)
        np.testing.assert_allclose(g, r16, atol=atol, rtol=0)
        gap16, gap32 = float(np.abs(g - r16).mean()), float(np.abs(g - r32).mean())
        assert gap32 >= 10.0 * gap16, (gap16, gap32)


# -- _extract in bf16, bit for bit ------------------------------------------------


@pytest.mark.parametrize("family,context", [("rq", None), ("affine", None), ("cubic", None),
                                            ("rq", C)])
def test_b2_extract_in_bf16_is_the_jax_one(family, context):
    jflow, tflow = _coupling_pair(family, context)
    j_idx, j_w, j_static, *_ = jax_nsf_fused._extract(jflow, jnp.bfloat16)
    t_idx, t_w, t_static, *_ = nsf_fused._extract(tflow, BF16)
    assert [tuple(i) for i in t_idx] == [tuple(i) for i in j_idx]
    assert sorted(t_w) == sorted(j_w) and t_static == j_static
    for name in j_w:
        _same_bits(t_w[name], j_w[name], name)
    assert {t_w[k].dtype for k in nsf_flow_kernel.MATRICES if k in t_w} == {BF16}


@pytest.mark.parametrize("kind", ["maf", "nsf_ar", "conditional_maf"])
def test_b9_extract_in_bf16_is_the_jax_one(kind):
    jflow, tflow = _ar_pair(kind)
    j = jax_maf_fused._extract(jflow, jnp.bfloat16)
    t = maf_fused._extract(tflow, BF16)
    assert tuple(t[0]) == tuple(j[0]) and t[2:] == tuple(j[2:])
    assert sorted(t[1]) == sorted(j[1])
    for name in j[1]:
        _same_bits(t[1][name], j[1][name], name)


@pytest.mark.parametrize("context", [None, C])
def test_b11_extract_in_bf16_is_the_jax_one(context):
    jm, tm = _mog_pair(context)
    jw, jstatic, jcf = jax_mog_fused._extract(jm, jnp.bfloat16)
    tw, tstatic, tcf = mademog_fused._extract(tm, BF16)
    assert (tstatic, tcf) == (jstatic, jcf) and sorted(tw) == sorted(jw)
    for name in jw:
        _same_bits(tw[name], jw[name], name)


# -- the bf16 plain versions against the JAX kernels in interpret mode -------------


def _b2_jax(jflow, x, c, inverse, dtype):
    j_idx, j_w, j_static, *_ = jax_nsf_fused._extract(jflow, dtype)
    ctx = {} if c is None else dict(ctx_t=jnp.asarray(c.T), wc0=j_w["wc0"], wcb=j_w["wcb"],
                                    bcb=j_w["bcb"])
    y, lad = nsf_flow_kernel_call(
        jnp.asarray(x.T), j_w["w0"], j_w["b0"], j_w["wb"], j_w["bb"], j_w["wf"], j_w["bf"],
        j_idx, inverse=inverse, lanes=N, interpret=True, **ctx, **j_static)
    return np.asarray(y).T, np.asarray(lad)[0]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("family,context", [("rq", None), ("affine", None), ("rq", C)])
def test_b2_plain_in_bf16_matches_the_jax_kernel(family, context, inverse):
    jflow, tflow = _coupling_pair(family, context, seed=3)
    x = _x(seed=4)
    c = None if context is None else _x(width=context, seed=5, scale=1.0)
    t_idx, t_w, t_static, *_ = nsf_fused._extract(tflow, BF16)
    before = nsf_flow_kernel.bf16_launch_count + nsf_flow_kernel.launch_count
    y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(
        torch.from_numpy(x), t_w, t_idx, inverse=inverse,
        context=None if c is None else torch.from_numpy(c), **t_static)
    assert nsf_flow_kernel.bf16_launch_count + nsf_flow_kernel.launch_count == before
    assert y.dtype == lad.dtype == torch.float32
    _hold((y, lad), _b2_jax(jflow, x, c, inverse, jnp.bfloat16),
          _b2_jax(jflow, x, c, inverse, jnp.float32), (OUT_ATOL, LAD_ATOL))


def _b9_jax(jflow, x, c, inverse, dtype):
    static, w, nb, _, tr, skw, _ = jax_maf_fused._extract(jflow, dtype)
    ctx = {} if c is None else dict(ctx_t=jnp.asarray(c.T), wci=w["wci"], bci=w["bci"],
                                    wcb=w["wcb"], bcb=w["bcb"])
    y, lad = maf_flow_kernel_call(
        jnp.asarray(x.T), w["wi"], w["bi"], w["wb"], w["bb"], w["wf"], w["bf"], static,
        inverse=inverse, num_blocks=nb, transformer=tr, spline_kw=skw, lanes=N,
        interpret=True, **ctx)
    return np.asarray(y).T, np.asarray(lad)[0]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["maf", "nsf_ar", "conditional_maf"])
def test_b9_plain_in_bf16_matches_the_jax_kernel(kind, inverse):
    jflow, tflow = _ar_pair(kind, seed=6)
    x = _x(width=5, seed=7, scale=1.5)
    c = _x(width=C, seed=8, scale=1.0) if kind == "conditional_maf" else None
    static, w, nb, _, tr, skw, _ = maf_fused._extract(tflow, BF16)
    with torch.no_grad():
        y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
            torch.from_numpy(x), w, static, inverse=inverse, num_blocks=nb, transformer=tr,
            spline_kw=skw, context=None if c is None else torch.from_numpy(c))
    _hold((y, lad), _b9_jax(jflow, x, c, inverse, jnp.bfloat16),
          _b9_jax(jflow, x, c, inverse, jnp.float32), (OUT_ATOL, LAD_ATOL))


@pytest.mark.parametrize("context", [None, C])
def test_b11_plain_in_bf16_matches_the_jax_kernel(context):
    jm, tm = _mog_pair(context, seed=9)
    x = _x(width=5, seed=10, scale=1.5)
    c = None if context is None else _x(width=context, seed=11, scale=1.0)

    def jax_lp(dtype):
        jw, jstatic, _ = jax_mog_fused._extract(jm, dtype)
        return np.asarray(jax_mog_fused.mademog_log_prob_call(
            jnp.asarray(x.T), jw, jstatic, lanes=N, interpret=True,
            ctx_t=None if c is None else jnp.asarray(c.T)))[0]

    tw, tstatic, _ = mademog_fused._extract(tm, BF16)
    lp = mademog_fused.mademog_log_prob_cuda(
        torch.from_numpy(x), tw, tstatic, None if c is None else torch.from_numpy(c))
    _hold((lp,), (jax_lp(jnp.bfloat16),), (jax_lp(jnp.float32),), (LAD_ATOL,))


# -- round trips ---------------------------------------------------------------------


def test_bf16_round_trips_through_the_plain_b2_and_b9():
    _, cflow = _coupling_pair("rq", C, seed=12)
    idx, w, static, *_ = nsf_fused._extract(cflow, BF16)
    x, c = torch.from_numpy(_x(seed=13)), torch.from_numpy(_x(width=C, seed=14, scale=1.0))
    y, lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, w, idx, inverse=False, context=c,
                                                   **static)
    back, lad_inv = nsf_flow_kernel.nsf_flow_kernel_plain(y, w, idx, inverse=True, context=c,
                                                          **static)
    torch.testing.assert_close(back, x, atol=1e-4, rtol=0)
    torch.testing.assert_close(lad + lad_inv, torch.zeros_like(lad), atol=1e-4, rtol=0)
    for kind in ("maf", "nsf_ar"):
        _, aflow = _ar_pair(kind, seed=15)
        fused = maf_fused.fuse_maf(aflow, dtype=BF16)
        x = torch.from_numpy(_x(width=5, seed=16, scale=1.5))
        with torch.no_grad():
            z, lad = fused.forward(x)
            back, lad_inv = fused.inverse(z)
        torch.testing.assert_close(back, x, atol=1e-4, rtol=0)
        torch.testing.assert_close(lad + lad_inv, torch.zeros_like(lad), atol=1e-4, rtol=0)


# -- CompiledFlow(dtype=torch.bfloat16) ---------------------------------------------------


def test_compiled_flow_in_bf16_serves_the_bf16_fused_views():
    _, nsf = _coupling_pair("rq", seed=17)
    _, maf = _ar_pair("maf", seed=18)
    _, mog = _mog_pair(C, seed=19)
    for model, features, context, fuse in (
            (nsf, D, None, nsf_fused.fuse_nsf), (maf, 5, None, maf_fused.fuse_maf),
            (mog, 5, C, mademog_fused.fuse_mademog)):
        served = CompiledFlow(model, batch_size=64, features=features, context_features=context,
                              num_samples=2, dtype=BF16, device="cpu")
        assert served.is_fused
        view = fuse(model, dtype=BF16)
        x = torch.from_numpy(_x(n=64, width=features, seed=20, scale=1.5))
        c = None if context is None else torch.from_numpy(_x(n=64, width=context, seed=21))
        with torch.no_grad():
            lp = served.log_prob(x, c)
            # the fused route takes bf16 arrays too, widened to fp32
            lp_b = served.log_prob(x.to(BF16), None if c is None else c.to(BF16))
            want = view.log_prob(x, c)
            want_b = view.log_prob(x.to(BF16).float(), None if c is None else c.to(BF16).float())
        assert lp.dtype == lp_b.dtype == torch.float32
        torch.testing.assert_close(lp, want, atol=0, rtol=0)
        torch.testing.assert_close(lp_b, want_b, atol=0, rtol=0)
        g = torch.Generator().manual_seed(0)
        samples = served.sample(g, None if c is None else c.to(BF16))
        assert samples.dtype == torch.float32 and torch.isfinite(samples).all()


def test_compiled_flow_in_bf16_unfused_matches_the_jax_endpoint():
    cfg = dict(features=D, hidden_features=HIDDEN, num_layers=2, num_blocks_per_layer=2,
               num_bins=4, tail_bound=3.0, stacked=False)
    jflow, tflow = _carry(JaxNSF(key=jax.random.key(22), rng=np.random.default_rng(22), **cfg),
                          NeuralSplineFlow(device="cpu", **cfg))
    served = CompiledFlow(tflow, batch_size=64, features=D, dtype=BF16, use_fused=False,
                          device="cpu")
    jserved = JaxCompiledFlow(jflow, batch_size=64, features=D, dtype=jnp.bfloat16,
                              use_fused=False)
    assert not served.is_fused and not jserved.is_fused
    x = _x(n=64, seed=23, scale=1.5)
    with pytest.raises(TypeError, match="bfloat16"):
        served.log_prob(torch.from_numpy(x))
    with torch.no_grad():
        lp = served.log_prob(torch.from_numpy(x).to(BF16))
        lp32 = tflow.log_prob(torch.from_numpy(x))
    want = np.asarray(jserved.log_prob(jnp.asarray(x, jnp.bfloat16)))
    assert lp.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(lp.numpy(), want, atol=1e-4, rtol=0)
    assert float((lp - lp32).abs().max()) > 1e-3      # the price of the rounded input
    assert served.sample(torch.Generator().manual_seed(0)).dtype == torch.float32


def test_compiled_flow_in_bf16_unfused_needs_a_bf16_context():
    _, tflow = _coupling_pair("rq", C, seed=24)
    served = CompiledFlow(tflow, batch_size=16, features=D, context_features=C, dtype=BF16,
                          use_fused=False, device="cpu")
    x = torch.from_numpy(_x(n=16, seed=25)).to(BF16)
    c = torch.from_numpy(_x(n=16, width=C, seed=26))
    with pytest.raises(TypeError, match="context"):
        served.log_prob(x, c)
    with torch.no_grad():
        lp = served.log_prob(x, c.to(BF16))
        want = tflow.log_prob(x.float(), c.to(BF16).float())
    torch.testing.assert_close(lp, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        CompiledFlow(tflow, batch_size=16, features=D, context_features=C,
                     dtype=torch.float16, device="cpu")
