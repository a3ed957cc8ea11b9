"""Kernels B1 to B12 on the card, each against its plain PyTorch version
on the same CUDA tensors, and the serving and training paths through them:
B2, B3 and B4 for all seven coupling families; B9 and B10 with a context,
and B10's inverse direction (an IAF trained by reverse KL); B3, B4, B10
and B12 on thread-block clusters of every size; B2, B9 and B11
with bf16 weights, and CompiledFlow(dtype=torch.bfloat16); B2 on both of
its routes (the tensor-core kernel and the SIMT one), every family, both
weight types, with and without a context, and one GEMM of its wgmma
route alone; B9's one-pass direction on both of its routes (MAF, NSF-AR and
IAF, both weight types, with and without a context); B11 on both of its
routes (both weight types, with and without a context, the final layer in
one pass and in two); a window of eager steps replayed as a CUDA graph
against the per-step loop; B1 and B5-B8 as a learned CDF calls them and B7
and B5 as the AR transforms call them, and the launches of a coupling flow
with a CDF on every identity half and of an AR spline flow served unfused.

The CUDA kernels have no CPU mode, so without a CUDA device every test
here skips. On a machine with a Hopper card and nvcc (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, as in chip_smoke.py: B1 1e-4 on outputs and 1e-3 on the
per-element logabsdet (a log of ratios of small bin quantities, which
loses more digits); B1 gradients 1e-4 absolute and relative; B2 1e-3 on
outputs and logabsdet (fp32 GEMMs summed in another order than cuBLAS);
its other families the same, or, where an inverse chain amplifies rounding
(the affine one divides by scales down to 1e-3), within twice the fp32
plain version's distance from float64. B3 and B4: log_prob 1e-3 as B2; gradients 2e-4 of the plain version's plus
1e-3 of its size (the bar the JAX package holds its training kernels to,
with a relative part because a weight gradient is a sum over the batch taken
by atomics in another order than autograd's); two launches on the same
inputs agree within 1e-5 plus 1e-4 relative (only the order of the atomic
adds differs). B5-B8 as B1: outputs 1e-4 and logabsdet 1e-3 against their
plain versions (the plain fp32 versions are within 2.4e-5 of float64 on
these inputs), gradients 1e-4 absolute and relative. B1 and B7 at every
layout of their group of lanes (K from 1 to 200, 1 to 140,001 elements):
the same bands, or twice the plain fp32 version's distance from float64
(at K = 200 that version lies up to 5.9e-4 from float64 on the
logabsdet). The bf16-weight
instantiations of B2, B9 and B11, at full width, against their bf16 plain
versions: the bands of benchmarks/hw_numerics.py:68-123 (5e-3 on outputs,
2e-2 on logabsdet and log_prob), and a mean |delta| at most a quarter of
the kernel's mean |delta| to the fp32 plain version (it rounds where the
plain version rounds).
"""

import numpy as np
import pytest
import torch

from nflows_tpu_torch import (
    CompiledFlow,
    NeuralSplineFlow,
    create_train_state,
    fused_trainer,
    make_train_step,
)
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel, nsf_train, rq_spline
from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf
from nflows_tpu_torch.ops.splines import rational_quadratic as rq

pytestmark = pytest.mark.cuda

B = 3.0


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _spline_inputs(K, device, seed=0, shape=(512, 3)):
    rng = np.random.default_rng(seed)
    x = (2.5 * rng.standard_normal(shape)).astype(np.float32)
    x.reshape(-1)[:4] = [B, -B, B + 0.5, -B - 0.5]
    arrays = [x] + [(0.5 * rng.standard_normal(shape + (k,))).astype(np.float32)
                    for k in (K, K, K - 1)]
    return [torch.from_numpy(a).to(device) for a in arrays]


def _flow(device, features=6, **overrides):
    cfg = dict(hidden_features=64, num_layers=3, num_blocks_per_layer=2, num_bins=8,
               tail_bound=B, **overrides)
    flow = NeuralSplineFlow(features, generator=torch.Generator().manual_seed(features),
                            rng=np.random.default_rng(features), device=device, **cfg)
    return flow.eval()


def _close(a, b, atol):
    torch.testing.assert_close(a, b, atol=atol, rtol=0)


# B9's one pass in fp32: each quantile within ten times the plain version's
# (chip_smoke.ONE_PASS_LIMITS), which 3xTF32 meets and one TF32 product a
# product misses by orders of magnitude
ONE_PASS_LIMITS = (10.0, 10.0, 10.0, 10.0)


def _hold_relative(kernel, plain, plain64, atol=None, limits=(2.0, 2.0, 4.0, 10.0)):
    """Per-sample relative errors against float64, |a - f64| / (1 + |f64|)
    (the largest over a sample's features): by default the kernel's median
    and 90th percentile at most twice the plain version's, its 99th
    percentile four times, its maximum ten times (chip_smoke.hold_relative,
    where an ill-conditioned fixed point makes both fp32 evaluations far
    from float64 on a few samples); else within ``limits`` times. ``atol``
    is unused."""
    def quantiles(t):
        e = (t.double() - plain64).abs() / (1.0 + plain64.abs())
        e = e.reshape(e.shape[0], -1).max(dim=1).values
        q = torch.quantile(e, torch.tensor([0.5, 0.9, 0.99], dtype=e.dtype, device=e.device))
        return [*q.tolist(), float(e.max())]

    k, p = quantiles(kernel), quantiles(plain)
    assert all(a <= f * b for a, b, f in zip(k, p, limits)), (k, p)


def _hold(kernel, plain, plain64, atol):
    """A kernel result within ``atol`` of its plain version, or, where the
    chain amplifies rounding (the affine inverse divides by scales down to
    1e-3), no further from the float64 plain version than twice the fp32
    plain version is (chip_smoke.hold)."""
    gap = (kernel - plain).abs().max().item()
    err = (kernel.double() - plain64).abs().max().item()
    err_plain = (plain.double() - plain64).abs().max().item()
    assert gap <= atol or err <= 2.0 * err_plain, (gap, err, err_plain)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_b1_matches_plain(cuda, K, inverse):
    args = _spline_inputs(K, cuda, seed=K)
    before = rq_spline.launch_count
    out, lad = rq_spline.rq_spline_cuda(*args, inverse=inverse, tail_bound=B)
    assert rq_spline.launch_count == before + 1
    p_out, p_lad = rq.unconstrained_rational_quadratic_spline_plain(
        *args, inverse=inverse, tail_bound=B)
    _close(out, p_out, 1e-4)
    _close(lad, p_lad, 1e-3)
    outside = args[0].abs() > B
    assert torch.equal(out[outside], args[0][outside]) and not lad[outside].any()


def test_b1_gradients_match_plain(cuda):
    args = _spline_inputs(8, cuda, seed=1)
    args[0].clamp_(-B + 0.1, B - 0.1)  # away from the clamp's tie at +-B
    leaves = [t.clone().requires_grad_(True) for t in args]
    out, lad = rq_spline.rq_spline_cuda(*leaves, inverse=True, tail_bound=B)
    (out * 1.3 + lad * 0.7).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in args]
    p_out, p_lad = rq.unconstrained_rational_quadratic_spline_plain(
        *ref, inverse=True, tail_bound=B)
    (p_out * 1.3 + p_lad * 0.7).sum().backward()
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r.grad, atol=1e-4, rtol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args = _spline_inputs(8, cuda)
    with pytest.raises(TypeError):
        rq_spline.rq_spline_cuda(*[t.double() for t in args], tail_bound=B)
    with pytest.raises(ValueError):
        rq_spline.rq_spline_cuda(args[0].t(), *[t.transpose(0, 1) for t in args[1:]],
                                 tail_bound=B)
    fused = fuse_nsf(_flow(cuda))
    with pytest.raises(ValueError):
        nsf_flow_kernel.nsf_flow_kernel_cuda(
            torch.zeros(8, 6, dtype=torch.float64, device=cuda), fused._weights,
            fused._indices, inverse=False, packed=fused._packed, **fused._static)


@pytest.mark.parametrize("features", [6, 5])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [203, 16384])
def test_b2_matches_plain(cuda, features, inverse, n):
    """203 leaves a ragged last tile of 32-sample tiles; 16,384 fills the
    card with 64-sample tiles."""
    fused = fuse_nsf(_flow(cuda, features))
    x = torch.randn(n, features, generator=torch.Generator().manual_seed(n)).to(cuda)
    kw = dict(inverse=inverse, **fused._static)
    before = nsf_flow_kernel.launch_count
    y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(
        x, fused._weights, fused._indices, packed=fused._packed, **kw)
    assert nsf_flow_kernel.launch_count == before + 1
    p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, fused._weights, fused._indices, **kw)
    _close(y, p_y, 1e-3)
    _close(lad, p_lad, 1e-3)


def test_compiled_flow_runs_the_kernels(cuda):
    flow = _flow(cuda)
    x = torch.randn(256, 6, generator=torch.Generator().manual_seed(3)).to(cuda)
    fused = CompiledFlow(flow, batch_size=256, features=6)
    unfused = CompiledFlow(flow, batch_size=256, features=6, use_fused=False)
    assert fused.is_fused and not unfused.is_fused
    b1, b2 = rq_spline.launch_count, nsf_flow_kernel.launch_count
    lp = fused.log_prob(x)
    assert (rq_spline.launch_count, nsf_flow_kernel.launch_count) == (b1, b2 + 1)
    lp_unfused = unfused.log_prob(x)
    assert (rq_spline.launch_count, nsf_flow_kernel.launch_count) == (b1 + 3, b2 + 1)
    _close(lp, lp_unfused, 1e-3)
    s, slp = fused.sample_and_log_prob(torch.Generator(device=cuda).manual_seed(4))
    assert torch.isfinite(s).all() and torch.isfinite(slp).all()
    _close(slp, fused.log_prob(s), 5e-3)


# -- B2's two routes: tensor cores (wgmma) and fp32 FMAs (simt) ---------------

WGMMA_FAMILIES = ("rq", "lrs", "linear", "quadratic", "cubic", "affine", "general", "additive")


def _coupling_chain(device, family, hidden=128, context=None, features=6, layers=3, seed=0):
    """A chain of ``layers`` couplings of ``family`` (RealNVP's affine with
    the DEFAULT or GENERAL scale activation, or the additive one), each
    conditioner a 2-block ResidualNet of width ``hidden`` with the context
    where given; alternating masks, 4 bins, linear tails at 3, final
    weights x 0.1 (an untamed affine inverse amplifies rounding past any
    band)."""
    from nflows_tpu_torch import Flow
    from nflows_tpu_torch.distributions import StandardNormal
    from nflows_tpu_torch.nn import nets
    from nflows_tpu_torch.transforms import (
        AdditiveCouplingTransform,
        AffineCouplingTransform,
        CompositeTransform,
        PiecewiseCubicCouplingTransform,
        PiecewiseLinearCouplingTransform,
        PiecewiseLinearRationalCouplingTransform,
        PiecewiseQuadraticCouplingTransform,
        PiecewiseRationalQuadraticCouplingTransform,
    )
    from nflows_tpu_torch.utils.masks import create_alternating_binary_mask

    gen = torch.Generator().manual_seed(seed)

    def net(n_in, n_out):
        return nets.ResidualNet(n_in, n_out, hidden_features=hidden, num_blocks=2,
                                context_features=context, generator=gen, device=device)

    chain = []
    for i in range(layers):
        mask = create_alternating_binary_mask(features, even=bool(i % 2))
        if family in ("affine", "general"):
            act = (AffineCouplingTransform.GENERAL_SCALE_ACTIVATION if family == "general"
                   else AffineCouplingTransform.DEFAULT_SCALE_ACTIVATION)
            t = AffineCouplingTransform(mask=mask, transform_net_create_fn=net,
                                        scale_activation=act, device=device)
        elif family == "additive":
            t = AdditiveCouplingTransform(mask=mask, transform_net_create_fn=net, device=device)
        else:
            cls = {"rq": PiecewiseRationalQuadraticCouplingTransform,
                   "lrs": PiecewiseLinearRationalCouplingTransform,
                   "linear": PiecewiseLinearCouplingTransform,
                   "quadratic": PiecewiseQuadraticCouplingTransform,
                   "cubic": PiecewiseCubicCouplingTransform}[family]
            t = cls(mask=mask, transform_net_create_fn=net, num_bins=4, tails="linear",
                    tail_bound=B, device=device)
        chain.append(t)
    flow = Flow(CompositeTransform(chain), StandardNormal([features])).to(device)
    with torch.no_grad():
        for t in flow.transform.transforms:
            t.transform_net.final_layer.weight.mul_(0.1)
    return flow.eval()


def _hold_bf16(kernel, plain16, plain32, band):
    """A bf16 kernel against its bf16 plain version (chip_smoke.hold_bf16):
    max |delta| within ``band`` and mean |delta| at most a quarter of the
    mean |delta| to the fp32 plain version."""
    diff = (kernel.double() - plain16.double()).abs()
    mean32 = float((kernel.double() - plain32.double()).abs().mean())
    assert float(diff.max()) <= band, float(diff.max())
    assert float(diff.mean()) <= 0.25 * mean32, (float(diff.mean()), mean32)


@pytest.mark.parametrize("n", [203, 4096])
@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", WGMMA_FAMILIES)
def test_b2_both_routes_match_plain(cuda, family, dtype, context, n):
    """B2's wgmma kernel (the route this width takes) and its SIMT kernel
    (forced), forward and inverse, each against the plain version in its
    bands: fp32 as test_b2_matches_plain, bf16 as phase 31 of
    chip_smoke.py; each launch counted on its route. 203 leaves a ragged
    last tile."""
    flow = _coupling_chain(cuda, family, context=context)
    fused, fused32 = fuse_nsf(flow, dtype=dtype), fuse_nsf(flow)
    w, idx = fused._weights, fused._indices
    assert nsf_flow_kernel.weights_route(w, idx) == "wgmma"
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 6, generator=g).to(cuda)
    ctx = None if context is None else torch.randn(n, context, generator=g).to(cuda)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    for inverse in (False, True):
        kw = dict(inverse=inverse, context=ctx, **fused._static)
        p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, w, idx, **kw)
        if dtype == torch.float32:
            d_y, d_lad = nsf_flow_kernel.nsf_flow_kernel_plain(
                x.double(), {k: v.double() for k, v in w.items()}, idx,
                **{**kw, "context": None if ctx is None else ctx.double()})
        else:
            q_y, q_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, fused32._weights, idx, **kw)
        for route in ("wgmma", "simt"):
            before = dict(nsf_flow_kernel.route_launch_count)
            y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, w, idx, packed=fused._packed,
                                                          gemm=route, **kw)
            after = dict(nsf_flow_kernel.route_launch_count)
            assert after[route + suffix] == before[route + suffix] + 1
            assert sum(after.values()) == sum(before.values()) + 1
            assert torch.isfinite(y).all() and torch.isfinite(lad).all()
            if dtype == torch.float32:
                _hold(y, p_y, d_y, 1e-3)
                _hold(lad, p_lad, d_lad, 1e-3)
            else:
                _hold_bf16(y, p_y, q_y, 5e-3)
                _hold_bf16(lad, p_lad, q_lad, 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_wgmma_with_unfolded_weights_and_wh_scale(cuda, dtype):
    """The wgmma route scales the first min(2 K T, TM) rows of P by
    wh_scale, as the SIMT kernel and the plain version do, for weights
    extracted without the softmax 1/sqrt(H) folded in."""
    from nflows_tpu_torch.ops.cuda import nsf_fused

    flow = _coupling_chain(cuda, "quadratic", hidden=128, features=10)
    idx, w, static, _, _ = nsf_fused._extract(flow, dtype, fold_wh_scale=False)
    wh = nsf_train.family_wh_scale(static, 128)
    x = torch.randn(203, 10, generator=torch.Generator().manual_seed(9)).to(cuda)
    for inverse in (False, True):
        kw = dict(inverse=inverse, wh_scale=wh, **static)
        y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, w, idx, gemm="wgmma", **kw)
        p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, w, idx, **kw)
        tol = 1e-4 if dtype == torch.float32 else 5e-3
        _close(y, p_y, tol)
        _close(lad, p_lad, 10 * tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,K,O", [(203, 256, 256), (4096, 16, 256), (40, 128, 192), (7, 64, 64)])
def test_gemm_wgmma_matches_gemm(cuda, dtype, n, K, O):
    """One GEMM through the wgmma route's ring, split and fragment layout:
    within 1e-5 of the largest entry of the product (fp32 on 3xTF32 against
    float64; bf16 against the product of the rounded operands)."""
    g = torch.Generator().manual_seed(K + O)
    a = torch.randn(n, K, generator=g).to(cuda)
    w = (torch.randn(O, K, generator=g) / 16).to(cuda).to(dtype)
    got = nsf_flow_kernel.gemm_wgmma(a, w)
    exact = (nsf_flow_kernel.gemm(a.double(), w.double()) if dtype == torch.float32
             else nsf_flow_kernel.gemm(a, w).double())
    assert got.shape == (n, O)
    assert float((got.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


def test_b2_routes_by_shape_and_refuses_a_forced_wgmma(cuda):
    """A width of 16 keeps the SIMT kernel; forcing wgmma there raises."""
    flow = _coupling_chain(cuda, "quadratic", hidden=16)
    fused = fuse_nsf(flow)
    assert nsf_flow_kernel.weights_route(fused._weights, fused._indices) == "simt"
    x = torch.randn(64, 6, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = dict(nsf_flow_kernel.route_launch_count)
    nsf_flow_kernel.nsf_flow_kernel_cuda(x, fused._weights, fused._indices, inverse=False,
                                         packed=fused._packed, **fused._static)
    assert nsf_flow_kernel.route_launch_count["simt"] == before["simt"] + 1
    with pytest.raises(ValueError, match="wgmma"):
        nsf_flow_kernel.nsf_flow_kernel_cuda(x, fused._weights, fused._indices, inverse=False,
                                             gemm="wgmma", **fused._static)


# -- training kernels B3 and B4 -----------------------------------------------


def _trainer(device, features=6, batch=128, **overrides):
    return nsf_train.FusedNSFTrainer(_flow(device, features, **overrides), batch)


def _train_args(tr):
    return (tr.weights, tr._indices), dict(wh_scale=tr._wh_scale, **tr._static)


def _grads_close(got, ref, atol=2e-4, rtol=1e-3):
    for k in nsf_train.WEIGHT_KEYS:
        torch.testing.assert_close(got[k], ref[k], atol=atol, rtol=rtol, msg=lambda m: f"{k}: {m}")


def _grads_hold(got, ref, ref64, atol=2e-4, rtol=1e-3):
    """``_grads_close``, or, for a stack where fp32 rounding moves the plain
    version itself past that band, no further from the float64 plain version
    than twice the fp32 one is (``_hold``)."""
    for k in nsf_train.WEIGHT_KEYS:
        if not torch.allclose(got[k], ref[k], atol=atol, rtol=rtol):
            _hold(got[k], ref[k], ref64[k], atol)


@pytest.mark.parametrize("features", [6, 5])
@pytest.mark.parametrize("n", [203, 16384])
def test_b3_matches_plain(cuda, features, n):
    """203 leaves a ragged last tile; 16,384 takes 64-sample tiles and gives
    each block of the persistent grid several tiles."""
    tr = _trainer(cuda, features)
    (w, idx), kw = _train_args(tr)
    x = 1.5 * torch.randn(n, features, generator=torch.Generator().manual_seed(n)).to(cuda)
    before = nsf_train.loss_grad_launch_count
    loss, lp, grads = nsf_train.nsf_loss_grad_cuda(x, w, idx, **kw)
    assert nsf_train.loss_grad_launch_count == before + 1
    p_loss, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, w, idx, **kw)
    _close(lp, p_lp, 1e-3)
    _close(loss, p_loss, 1e-4)
    _grads_close(grads, p_grads)


@pytest.mark.parametrize("features", [6, 5])
@pytest.mark.parametrize("n", [203, 16384])
def test_b4_matches_plain(cuda, features, n):
    tr = _trainer(cuda, features)
    (w, idx), kw = _train_args(tr)
    g = torch.Generator().manual_seed(n + 1)
    x = 1.5 * torch.randn(n, features, generator=g).to(cuda)
    gy = torch.randn(n, features, generator=g).to(cuda) / n
    glad = torch.randn(n, generator=g).to(cuda) / n
    before = nsf_train.bwd_launch_count
    gx, grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, **kw)
    assert nsf_train.bwd_launch_count == before + 1
    p_gx, p_grads = nsf_train.nsf_train_bwd_plain(x, gy, glad, w, idx, **kw)
    torch.testing.assert_close(gx, p_gx, atol=2e-4 / n, rtol=1e-3)
    _grads_close(grads, p_grads)


def test_b3_gradients_do_not_depend_on_the_tile_or_an_earlier_launch(cuda):
    tr = _trainer(cuda)
    (w, idx), kw = _train_args(tr)
    x = 1.5 * torch.randn(1024, 6, generator=torch.Generator().manual_seed(5)).to(cuda)
    # one block a tile for both sizes: clusters sum each dot product in
    # another order (test_b3_b4_on_every_cluster_size_match_plain)
    _, lp32, g32 = nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=32, cluster=1, **kw)
    _, lp64, g64 = nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=64, cluster=1, **kw)
    _close(lp32, lp64, 1e-5)
    _grads_close(g64, g32, atol=1e-5, rtol=1e-4)
    # a second launch into the same buffers starts from zero again
    first = {k: v.clone() for k, v in g32.items()}
    _, _, again = nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=32, cluster=1, grads=g32, **kw)
    assert all(again[k] is g32[k] for k in again)
    _grads_close(again, first, atol=1e-5, rtol=1e-4)


def test_training_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    tr = _trainer(cuda)
    (w, idx), kw = _train_args(tr)
    x = torch.zeros(128, 6, device=cuda)
    with pytest.raises(ValueError):
        nsf_train.nsf_loss_grad_cuda(x.double(), w, idx, **kw)
    with pytest.raises(ValueError):
        nsf_train.nsf_loss_grad_cuda(x[:, :5].contiguous(), w, idx, **kw)
    with pytest.raises(ValueError):
        nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=48, **kw)
    with pytest.raises(ValueError):
        nsf_train.nsf_train_bwd_cuda(x, x, torch.zeros(64, device=cuda), w, idx, **kw)
    with pytest.raises(ValueError):
        nsf_train.nsf_loss_grad_cuda(x, {**w, "wf": w["wf"].transpose(1, 2)}, idx, **kw)


def _autograd_step(trainer, optimizer):
    """A train step on the composable route: ``loss_fn`` under autograd, so
    the backward is the backward kernel's (on the CPU, the plain chain's)."""
    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = trainer.loss_fn(trainer.weights, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def test_train_steps_launch_the_kernels_and_agree(cuda):
    """One B3 a fused step; one B2 and one B4 an autograd-route step; the
    eager route runs B1 in each coupling. Three Adam steps of the three
    routes from the same weights give the same losses."""
    import copy

    flow = _flow(cuda)
    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    fused = fused_trainer(copy.deepcopy(flow), 128)
    split = fused_trainer(copy.deepcopy(flow), 128)
    step_fused = fused.make_train_step(fused.init_opt(adam))
    step_split = _autograd_step(split, split.init_opt(adam))
    state = create_train_state(copy.deepcopy(flow).train(), adam)
    step_eager = make_train_step()
    g = torch.Generator().manual_seed(9)
    for _ in range(3):
        batch = (1.5 * torch.randn(128, 6, generator=g)).to(cuda)
        counts = lambda: (rq_spline.launch_count, nsf_flow_kernel.launch_count,  # noqa: E731
                          nsf_train.loss_grad_launch_count, nsf_train.bwd_launch_count)
        c0 = counts()
        loss_fused = step_fused(batch)
        c1 = counts()
        loss_split = step_split(batch)
        c2 = counts()
        state, metrics = step_eager(state, batch)
        c3 = counts()
        assert tuple(b - a for a, b in zip(c0, c1)) == (0, 0, 1, 0)
        assert tuple(b - a for a, b in zip(c1, c2)) == (0, 1, 0, 1)
        assert tuple(b - a for a, b in zip(c2, c3)) == (3, 0, 0, 0)
        _close(loss_fused, loss_split, 2e-4)
        _close(loss_fused, metrics["loss"], 2e-4)
    x = torch.randn(128, 6, generator=g).to(cuda)
    _close(fused.to_flow().log_prob(x), state.flow.log_prob(x), 5e-3)


# -- autoregressive kernels B9 and B10 ------------------------------------------
#
# Tolerances. B9 forward 1e-3 on outputs and logabsdet, as B2. B9 inverse: the
# D-step fixed point feeds each pass's rounding into the next through D
# features and every layer, so the kernel and its plain version (two fp32
# evaluations in different summation orders) are held 5e-3 apart, and the
# round trip forward(inverse(z)) to 5e-3 of z. B10 as B3 and B4.


def _ar_flow(device, kind, features=5, layers=3):
    from nflows_tpu_torch import (
        InverseAutoregressiveFlow,
        MaskedAutoregressiveFlow,
        NeuralSplineFlowAR,
    )

    kw = dict(generator=torch.Generator().manual_seed(features),
              rng=np.random.default_rng(features), device=device)
    if kind == "rq":
        flow = NeuralSplineFlowAR(features, 64, num_layers=layers, num_blocks_per_layer=2,
                                  num_bins=8, tail_bound=B, **kw)
    else:
        cls = InverseAutoregressiveFlow if kind == "iaf" else MaskedAutoregressiveFlow
        flow = cls(features, 64, layers, 2, use_random_permutations=True, **kw)
    return flow.eval()


def _maf_kw(fused):
    return dict(num_blocks=fused._num_blocks, transformer=fused._transformer,
                spline_kw=fused._spline_kw)


def _hold_degree_route(fused, x, kw, rows=None):
    """B9's fixed point at x by the route, which must take the degree
    kernel. Against the degree plain, whose schedule it shares, by _hold
    (5e-3, or no further from float64 than twice that plain). Against the
    fixed-point plain by _hold at a few hundred samples; at 16,384, where
    these flows as initialised send samples past 1e3 and the two schedules'
    fp32 roundings are amplified differently (the degree plain itself lies
    up to 6.7 times further from float64 there than the fixed-point plain:
    tools/degree_rounding.py), by chip_smoke.py's relative quantiles.
    Returns the kernel's (y, lad)."""
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel

    before = (maf_flow_kernel.launch_count, maf_flow_kernel.degree_launch_count)
    y, lad = maf_flow_kernel.maf_flow_kernel_cuda(x, fused._weights, fused._static,
                                                  packed=fused._packed, rows=rows, **kw)
    assert (maf_flow_kernel.launch_count, maf_flow_kernel.degree_launch_count) == (
        before[0] + 1, before[1] + 1)
    ctx = kw.get("context")
    w64 = {k: v.double() for k, v in fused._weights.items()}
    d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(
        x.double(), w64, fused._static,
        **{**kw, "context": None if ctx is None else ctx.double()})
    for schedule in ("degrees", "fixed_point"):
        p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(
            x, fused._weights, fused._static, schedule=schedule, masks=fused._masks, **kw)
        hold = _hold_relative if schedule == "fixed_point" and x.shape[0] >= 1000 else _hold
        hold(y, p_y, d_y, 5e-3)
        hold(lad, p_lad, d_lad, 5e-3)
    return y, lad


@pytest.mark.parametrize("kind", ["affine", "rq", "iaf"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [203, 16384])
def test_b9_matches_plain(cuda, kind, inverse, n):
    """203 leaves a ragged last tile of 32-sample tiles; 16,384 fills the
    card with 64-sample tiles. 5 features are padded to 8 input rows; the
    IAF chain is wrapped, so its forward runs the fixed point: on the
    fixed-point kernel (forced) against its plain version, and by the route,
    the degree kernel, as _hold_degree_route holds it."""
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    fused = fuse_maf(_ar_flow(cuda, kind))
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(n)).to(cuda)
    kw = dict(inverse=inverse, schedule="fixed_point", **_maf_kw(fused))
    before = maf_flow_kernel.launch_count
    y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
        x, fused._weights, fused._static, packed=fused._packed, **kw)
    assert maf_flow_kernel.launch_count == before + 1
    p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, fused._weights, fused._static, **kw)
    fixed_point = inverse != (kind == "iaf")
    _close(y, p_y, 5e-3 if fixed_point else 1e-3)
    _close(lad, p_lad, 5e-3 if fixed_point else 1e-3)
    back, lad_back = maf_flow_kernel.maf_flow_kernel_cuda(
        y, fused._weights, fused._static, packed=fused._packed,
        **{**kw, "inverse": not inverse})
    _close(back, x, 5e-3)
    _close(lad_back, -lad, 5e-3)
    if fixed_point:
        _hold_degree_route(fused, x, dict(inverse=inverse, **_maf_kw(fused)))


def test_b9_tile_sizes_agree_and_a_relaunch_is_independent(cuda):
    """The fixed-point kernel's tiles (the degree kernel's: below)."""
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    fused = fuse_maf(_ar_flow(cuda, "affine"))
    x = torch.randn(1000, 5, generator=torch.Generator().manual_seed(1)).to(cuda)
    run = lambda rows: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
        x, fused._weights, fused._static, packed=fused._packed, inverse=True, rows=rows,
        schedule="fixed_point", **_maf_kw(fused))
    y32, lad32 = run(32)
    y64, lad64 = run(64)
    again, lad_again = run(32)
    assert torch.equal(y32, again) and torch.equal(lad32, lad_again)
    _close(y32, y64, 1e-5)
    _close(lad32, lad64, 1e-5)
    with pytest.raises(ValueError):
        run(48)
    with pytest.raises(ValueError):
        maf_flow_kernel.maf_flow_kernel_cuda(
            x.double(), fused._weights, fused._static, inverse=False, **_maf_kw(fused))


def test_compiled_flow_serves_a_maf_with_one_launch_a_request(cuda):
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel

    flow = _ar_flow(cuda, "affine")
    x = torch.randn(256, 5, generator=torch.Generator().manual_seed(3)).to(cuda)
    fused = CompiledFlow(flow, batch_size=256, features=5)
    unfused = CompiledFlow(flow, batch_size=256, features=5, use_fused=False)
    assert fused.is_fused and not unfused.is_fused
    b9 = maf_flow_kernel.launch_count
    lp = fused.log_prob(x)
    s, slp = fused.sample_and_log_prob(torch.Generator(device=cuda).manual_seed(4))
    assert maf_flow_kernel.launch_count == b9 + 2
    _close(lp, unfused.log_prob(x), 1e-3)
    assert maf_flow_kernel.launch_count == b9 + 2
    assert torch.isfinite(s).all() and torch.isfinite(slp).all()
    _close(slp, fused.log_prob(s), 5e-3)


@pytest.mark.parametrize("n,rows", [(203, 16), (203, 32), (16384, None)])
@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("kind", ["affine", "rq", "iaf"])
def test_b9_degree_kernel_matches_both_plain_versions(cuda, kind, context, n, rows):
    """B9's fixed point on the degree kernel (the MAF's and NSF-AR's
    inverse, the IAF's forward) at 203 samples (a ragged last tile) on
    either tile size, and at 16,384 at the wrapper's choice, against both
    plain versions as _hold_degree_route holds it. Either tile size gives
    the same samples."""
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    flow = _ar_flow(cuda, kind) if context is None else _cond_ar_flow(cuda, kind)
    fused = fuse_maf(flow)
    assert fused._packed["degrees"] is not None
    g = torch.Generator().manual_seed(n + (rows or 0) + 7)
    x = torch.randn(n, 5, generator=g).to(cuda)
    ctx = None if context is None else torch.randn(n, context, generator=g).to(cuda)
    kw = dict(inverse=kind != "iaf", context=ctx, **_maf_kw(fused))
    y, lad = _hold_degree_route(fused, x, kw, rows=rows)
    ref_y, ref_lad = maf_flow_kernel.maf_flow_kernel_cuda(
        x, fused._weights, fused._static, packed=fused._packed, rows=16, **kw)
    _close(y, ref_y, 1e-5)
    _close(lad, ref_lad, 1e-5)


@pytest.mark.parametrize("kind", ["maf", "nsf_ar", "iaf"])
def test_b9_degree_kernel_in_bf16_matches_its_plain_versions(cuda, kind):
    """The bf16 degree kernel at full width on the MAF's and NSF-AR's
    inverse and the IAF's forward, against both bf16 plain versions."""
    from nflows_tpu_torch import (
        InverseAutoregressiveFlow,
        MaskedAutoregressiveFlow,
        NeuralSplineFlowAR,
    )
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    gen = torch.Generator().manual_seed(14)
    if kind == "nsf_ar":
        flow = NeuralSplineFlowAR(10, 256, num_layers=5, num_blocks_per_layer=2, num_bins=8,
                                  tail_bound=B, generator=gen, device=cuda).eval()
    else:
        cls = InverseAutoregressiveFlow if kind == "iaf" else MaskedAutoregressiveFlow
        flow = _tame(cls(10, 256, 5, 2, generator=gen, device=cuda), "autoregressive_net")
    f16, f32 = fuse_maf(flow, dtype=torch.bfloat16), fuse_maf(flow)
    x = torch.randn(4001, 10, generator=torch.Generator().manual_seed(15)).to(cuda)
    kw = dict(inverse=kind != "iaf", **_maf_kw(f16))
    before = (maf_flow_kernel.bf16_launch_count, maf_flow_kernel.degree_launch_count)
    y, lad = maf_flow_kernel.maf_flow_kernel_cuda(x, f16._weights, f16._static,
                                                  packed=f16._packed, **kw)
    assert (maf_flow_kernel.bf16_launch_count, maf_flow_kernel.degree_launch_count) == (
        before[0] + 1, before[1] + 1)
    p32 = maf_flow_kernel.maf_flow_kernel_plain(x, f32._weights, f32._static, **kw)
    for schedule in ("fixed_point", "degrees"):
        p16 = maf_flow_kernel.maf_flow_kernel_plain(x, f16._weights, f16._static,
                                                    schedule=schedule, masks=f16._masks, **kw)
        _bf16_hold(y, p16[0], p32[0], BF16_OUT)
        _bf16_hold(lad, p16[1], p32[1], BF16_LAD)


def test_b9_routes_by_shape_and_a_forced_schedule_is_kept(cuda):
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    fused = fuse_maf(_ar_flow(cuda, "rq"))
    x = torch.randn(300, 5, generator=torch.Generator().manual_seed(16)).to(cuda)
    call = lambda **kw: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
        x, fused._weights, fused._static, **{**_maf_kw(fused), **kw})
    counts = lambda: (maf_flow_kernel.launch_count,  # noqa: E731
                      maf_flow_kernel.degree_launch_count)
    c0 = counts()
    call(inverse=False, packed=fused._packed)                          # one pass: B9
    call(inverse=True, packed=fused._packed, schedule="fixed_point")   # forced
    call(inverse=True, packed=fused._packed, rows=64)                  # the fixed point's tile
    assert counts() == (c0[0] + 3, c0[1])
    y, lad = call(inverse=True)          # no packing given: the degree layout is built here
    assert counts() == (c0[0] + 4, c0[1] + 1)
    again, lad_again = call(inverse=True, packed=fused._packed)
    assert torch.equal(y, again) and torch.equal(lad, lad_again)
    with pytest.raises(ValueError, match="one pass"):
        call(inverse=False, schedule="degrees")
    with pytest.raises(ValueError, match="tile of 48 samples"):
        call(inverse=True, packed=fused._packed, schedule="degrees", rows=48)


def _maf_trainer(device, kind, batch=128):
    from nflows_tpu_torch.ops.cuda import maf_train

    return maf_train.FusedMAFTrainer(_ar_flow(device, kind), batch)


def _maf_grads_close(got, ref, atol=2e-4, rtol=1e-3):
    for k in ("wi", "bi", "wb", "bb", "wf", "bf"):
        torch.testing.assert_close(got[k], ref[k], atol=atol, rtol=rtol, msg=lambda m: f"{k}: {m}")


@pytest.mark.parametrize("kind", ["affine", "rq"])
@pytest.mark.parametrize("n", [203, 16384])
def test_b10_matches_plain(cuda, kind, n):
    """203 leaves a ragged last tile; 16,384 takes 64-sample tiles and gives
    each block of the persistent grid several tiles."""
    from nflows_tpu_torch.ops.cuda import maf_train

    tr = _maf_trainer(cuda, kind)
    folded = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    kw = dict(wh_scale=tr._wh_scale, **tr._static)
    g = torch.Generator().manual_seed(n + 1)
    x = 1.5 * torch.randn(n, 5, generator=g).to(cuda)
    gy = torch.randn(n, 5, generator=g).to(cuda) / n
    glad = torch.randn(n, generator=g).to(cuda) / n
    before = maf_train.bwd_launch_count
    gx, grads = maf_train.maf_train_bwd_cuda(x, gy, glad, folded, tr._layers, **kw)
    assert maf_train.bwd_launch_count == before + 1
    p_gx, p_grads = maf_train.maf_train_bwd_plain(x, gy, glad, folded, tr._layers, **kw)
    torch.testing.assert_close(gx, p_gx, atol=2e-4 / n, rtol=1e-3)
    _maf_grads_close(grads, p_grads)
    # a second launch into the same buffers starts from zero again
    first = {k: v.clone() for k, v in grads.items()}
    _, again = maf_train.maf_train_bwd_cuda(x, gy, glad, folded, tr._layers, grads=grads, **kw)
    assert all(again[k] is grads[k] for k in again)
    _maf_grads_close(again, first, atol=1e-5, rtol=1e-4)
    if n == 16384:
        _, g32 = maf_train.maf_train_bwd_cuda(x, gy, glad, folded, tr._layers, rows=32, **kw)
        _maf_grads_close(g32, first, atol=1e-5, rtol=1e-4)


def test_maf_train_steps_launch_the_kernels_and_keep_masked_entries(cuda):
    """One B9 and one B10 a fused step; three Adam steps of the fused and
    the eager route from the same weights give the same losses; a masked
    entry's gradient is exactly zero and the entry does not move."""
    import copy

    from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_train

    flow = _ar_flow(cuda, "affine")
    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    fused = fused_trainer(copy.deepcopy(flow), 128)
    assert isinstance(fused, maf_train.FusedMAFTrainer)
    start = {k: v.detach().clone() for k, v in fused.weights.items()}
    step_fused = fused.make_train_step(fused.init_opt(adam))
    state = create_train_state(copy.deepcopy(flow).train(), adam)
    step_eager = make_train_step()
    g = torch.Generator().manual_seed(9)
    for _ in range(3):
        batch = (1.5 * torch.randn(128, 5, generator=g)).to(cuda)
        c0 = (maf_flow_kernel.launch_count, maf_train.bwd_launch_count)
        loss_fused = step_fused(batch)
        c1 = (maf_flow_kernel.launch_count, maf_train.bwd_launch_count)
        assert tuple(b - a for a, b in zip(c0, c1)) == (1, 1)
        state, metrics = step_eager(state, batch)
        assert (maf_flow_kernel.launch_count, maf_train.bwd_launch_count) == c1
        _close(loss_fused, metrics["loss"], 2e-4)
    for k in maf_train.MASKED_KEYS:
        dead = fused._masks[k] == 0
        assert torch.equal(fused.weights[k].grad[dead], torch.zeros_like(start[k][dead]))
        assert torch.equal(fused.weights[k].detach()[dead], start[k][dead])
        assert not torch.equal(fused.weights[k].detach()[~dead], start[k][~dead])
    x = torch.randn(128, 5, generator=g).to(cuda)
    _close(fused.to_flow().log_prob(x), state.flow.log_prob(x), 5e-3)


# -- B9's one-pass direction on both routes: tensor cores (wgmma) and FMAs (simt) ----


B9_KINDS = {"maf": "affine", "nsf_ar": "rq", "iaf": "iaf"}   # _cond_ar_flow's kinds


@pytest.mark.parametrize("n", [203, 4096])
@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(B9_KINDS))
def test_b9_one_pass_both_routes_match_plain(cuda, kind, dtype, context, n):
    """B9's one-pass direction (a MAF's or NSF-AR's forward, an IAF's
    inverse) on the wgmma kernel (the route this width takes) and the SIMT
    kernel (forced), each against the plain version: fp32 within 1e-3 or
    twice the plain version's distance from float64, and by its relative
    errors within ONE_PASS_LIMITS, bf16 in phase 31's bands against the
    bf16 plain version; each launch counted on its route.
    203 leaves a ragged last tile. Hidden 64: one slab a GEMM, the
    NSF-AR's 115 parameter rows two."""
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    wrapped = kind == "iaf"
    flow = _cond_ar_flow(cuda, B9_KINDS[kind], context=context)
    fused, fused32 = fuse_maf(flow, dtype=dtype), fuse_maf(flow)
    w, st = fused._weights, fused._static
    assert maf_flow_kernel.weights_route(w, st, fused._num_blocks) == "wgmma"
    assert "wgmma" in fused._packed
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 5, generator=g).to(cuda)
    ctx = None if context is None else torch.randn(n, context, generator=g).to(cuda)
    kw = dict(inverse=wrapped, context=ctx, **_maf_kw(fused))
    p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, w, st, **kw)
    if dtype == torch.float32:
        d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(
            x.double(), {k: v.double() for k, v in w.items()}, st,
            **{**kw, "context": None if ctx is None else ctx.double()})
    else:
        q_y, q_lad = maf_flow_kernel.maf_flow_kernel_plain(x, fused32._weights, st, **kw)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    for route in ("wgmma", "simt"):
        before = dict(maf_flow_kernel.route_launch_count)
        y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
            x, w, st, packed=fused._packed, gemm=None if route == "wgmma" else route, **kw)
        after = dict(maf_flow_kernel.route_launch_count)
        assert after[route + suffix] == before[route + suffix] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        assert torch.isfinite(y).all() and torch.isfinite(lad).all()
        if dtype == torch.float32:
            _hold(y, p_y, d_y, 1e-3)
            _hold(lad, p_lad, d_lad, 1e-3)
            _hold_relative(y, p_y, d_y, limits=ONE_PASS_LIMITS)
            _hold_relative(lad, p_lad, d_lad, limits=ONE_PASS_LIMITS)
        else:
            _bf16_hold(y, p_y, q_y, BF16_OUT)
            _bf16_hold(lad, p_lad, q_lad, BF16_LAD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b9_wgmma_at_full_width_with_unfolded_weights_and_wh_scale(cuda, dtype):
    """The NSF-AR at full width (features 10, hidden 256, 5 layers, 230
    parameter rows padded to 256), forced onto the wgmma route with the
    trainer's weights, whose width and height rows the kernel scales by
    wh_scale, against the plain version; and a relaunch is bit-equal."""
    from nflows_tpu_torch import NeuralSplineFlowAR
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_train

    flow = NeuralSplineFlowAR(10, 256, num_layers=5, num_blocks_per_layer=2, num_bins=8,
                              tail_bound=B, generator=torch.Generator().manual_seed(17),
                              device=cuda).eval()
    tr = maf_train.FusedMAFTrainer(flow, 512)
    w = {k: v.detach().to(dtype) if k in maf_flow_kernel.MATRICES else v.detach()
         for k, v in tr._fold(tr.weights).items()}
    x = torch.randn(512, 10, generator=torch.Generator().manual_seed(18)).to(cuda)
    kw = dict(inverse=False, wh_scale=tr._wh_scale, **tr._static)
    y, lad = maf_flow_kernel.maf_flow_kernel_cuda(x, w, tr._layers, gemm="wgmma", **kw)
    again = maf_flow_kernel.maf_flow_kernel_cuda(x, w, tr._layers, gemm="wgmma", **kw)
    assert torch.equal(y, again[0]) and torch.equal(lad, again[1])
    p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, w, tr._layers, **kw)
    if dtype == torch.float32:
        w64 = {k: v.double() for k, v in w.items()}
        d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(x.double(), w64, tr._layers, **kw)
        _hold(y, p_y, d_y, 1e-3)
        _hold(lad, p_lad, d_lad, 1e-3)
        _hold_relative(y, p_y, d_y, limits=ONE_PASS_LIMITS)
        _hold_relative(lad, p_lad, d_lad, limits=ONE_PASS_LIMITS)
    else:
        w32 = {k: v.float() for k, v in w.items()}
        q_y, q_lad = maf_flow_kernel.maf_flow_kernel_plain(x, w32, tr._layers, **kw)
        _bf16_hold(y, p_y, q_y, BF16_OUT)
        _bf16_hold(lad, p_lad, q_lad, BF16_LAD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compiled_flow_b9_routes(cuda, dtype):
    """A MAF's log_prob request is one wgmma launch and its sample one
    degree-kernel launch; an IAF's sample is one wgmma launch; the fused
    trainers' steps launch the SIMT kernel."""
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel

    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    for kind in ("affine", "iaf"):
        flow = _cond_ar_flow(cuda, kind, context=None)
        server = CompiledFlow(flow, batch_size=256, features=5, dtype=dtype)
        assert server.is_fused
        x = torch.randn(256, 5, generator=torch.Generator().manual_seed(19)).to(cuda)
        before = (dict(maf_flow_kernel.route_launch_count), maf_flow_kernel.degree_launch_count)
        lp = server.log_prob(x.to(dtype) if dtype == torch.bfloat16 else x)
        s = server.sample(torch.Generator(device=cuda).manual_seed(20))
        after = (dict(maf_flow_kernel.route_launch_count), maf_flow_kernel.degree_launch_count)
        moved = {r: after[0][r] - before[0][r] for r in after[0]}
        assert torch.isfinite(lp).all() and torch.isfinite(s).all()
        expected = {r: 0 for r in moved}
        expected["wgmma" + suffix] = 1
        assert moved == expected and after[1] == before[1] + 1, (kind, moved)
    flow = _cond_ar_flow(cuda, "affine", context=None)
    tr = fused_trainer(flow, 128)
    step = tr.make_train_step(tr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-3)))
    before = dict(maf_flow_kernel.route_launch_count)
    step(torch.randn(128, 5, generator=torch.Generator().manual_seed(21)).to(cuda))
    moved = {r: maf_flow_kernel.route_launch_count[r] - before[r] for r in before}
    assert moved == {"simt": 1, "wgmma": 0, "simt_bf16": 0, "wgmma_bf16": 0}


# -- B9 and B10 with a context, and B10's inverse direction -------------------------
#
# Tolerances as above; B10's cotangent of the context as gx (2e-4 / N plus
# 1e-3 relative: its cotangents come at scale 1/N).


def _cond_ar_flow(device, kind, features=5, layers=3, context=3):
    """A conditional AR chain at hidden 64: layers x [random permutation,
    residual MADE (2 blocks) with a context]; affine (MAF), RQ (NSF-AR, 8
    bins) or wrapped affine (IAF); context=None gives the IAF without one.
    The blocks' second linears are redrawn at the first's scale: as
    initialised (U(-1e-3, 1e-3)) they leave the context projections' and
    first linears' gradients near 1e-5, under the 2e-4 band."""
    from nflows_tpu_torch import Flow, NeuralSplineFlowAR
    from nflows_tpu_torch.distributions import StandardNormal
    from nflows_tpu_torch.transforms import (
        CompositeTransform,
        InverseTransform,
        MaskedAffineAutoregressiveTransform,
        RandomPermutation,
    )

    gen = torch.Generator().manual_seed(features + 40)
    rng = np.random.default_rng(features + 40)
    if kind == "rq":
        flow = NeuralSplineFlowAR(features, 64, num_layers=layers, num_blocks_per_layer=2,
                                  num_bins=8, tail_bound=B, context_features=context,
                                  generator=gen, rng=rng, device=device)
    else:
        chain = []
        for _ in range(layers):
            layer = MaskedAffineAutoregressiveTransform(features, 64, context_features=context,
                                                        num_blocks=2, generator=gen,
                                                        device=device)
            chain += [RandomPermutation(features, rng=rng, device=device),
                      InverseTransform(layer) if kind == "iaf" else layer]
        flow = Flow(CompositeTransform(chain), StandardNormal([features])).to(device)
    with torch.no_grad():
        for t in flow.transform.transforms:
            net = getattr(getattr(t, "transform", t), "autoregressive_net", None)
            for blk in getattr(net, "blocks", ()):
                w = blk.linear_1.weight
                w.copy_((torch.rand(w.shape, generator=gen) * 2 - 1).to(device) / 64 ** 0.5)
    return flow.eval()


@pytest.mark.parametrize("kind", ["affine", "rq", "iaf"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [203, 16384])
def test_b9_with_context_matches_plain(cuda, kind, inverse, n):
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    fused = fuse_maf(_cond_ar_flow(cuda, kind))
    g = torch.Generator().manual_seed(n + 2)
    x = torch.randn(n, 5, generator=g).to(cuda)
    ctx = torch.randn(n, 3, generator=g).to(cuda)
    # the fixed point on the fixed-point kernel (forced), and at the end by
    # the route, the degree kernel
    kw = dict(inverse=inverse, context=ctx, schedule="fixed_point", **_maf_kw(fused))
    before = maf_flow_kernel.launch_count
    y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
        x, fused._weights, fused._static, packed=fused._packed, **kw)
    assert maf_flow_kernel.launch_count == before + 1
    p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, fused._weights, fused._static, **kw)
    fixed_point = inverse != (kind == "iaf")
    # as initialised the conditional fixed point sends a few samples past
    # 1e4, where fp32 rounding alone exceeds the band: there the kernel may
    # be no further from float64 than twice the plain fp32 version
    w64 = {k: v.double() for k, v in fused._weights.items()}
    d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(
        x.double(), w64, fused._static, **{**kw, "context": ctx.double()})
    _hold(y, p_y, d_y, 5e-3 if fixed_point else 1e-3)
    _hold(lad, p_lad, d_lad, 5e-3 if fixed_point else 1e-3)
    back, lad_back = maf_flow_kernel.maf_flow_kernel_cuda(
        y, fused._weights, fused._static, packed=fused._packed,
        **{**kw, "inverse": not inverse})
    _close(back, x, 5e-3)
    _close(lad_back, -lad, 5e-3)
    with pytest.raises(ValueError, match="pass the context"):
        maf_flow_kernel.maf_flow_kernel_cuda(x, fused._weights, fused._static,
                                             packed=fused._packed, **{**kw, "context": None})
    if fixed_point:
        _hold_degree_route(fused, x, dict(inverse=inverse, context=ctx, **_maf_kw(fused)))


def _b10_case(device, kind, context, n):
    from nflows_tpu_torch.ops.cuda import maf_train

    flow = _cond_ar_flow(device, kind, context=context)
    cls = maf_train.FusedIAFTrainer if kind == "iaf" else maf_train.FusedMAFTrainer
    tr = cls(flow, 128)
    folded = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    g = torch.Generator().manual_seed(n + 3)
    x = (1.5 * torch.randn(n, 5, generator=g)).to(device)
    gy = torch.randn(n, 5, generator=g).to(device) / n
    glad = torch.randn(n, generator=g).to(device) / n
    ctx = None if context is None else torch.randn(n, context, generator=g).to(device)
    kw = dict(wh_scale=tr._wh_scale, context=ctx, direction=tr._direction, **tr._static)
    return tr, folded, (x, gy, glad), kw


@pytest.mark.parametrize("kind,context", [("affine", 3), ("rq", 3), ("iaf", 3), ("iaf", None)])
@pytest.mark.parametrize("n", [203, 16384])
def test_b10_with_context_and_inverse_direction_matches_plain(cuda, kind, context, n):
    """The context adjoint (gctx and the four context stacks) on MAF and
    NSF-AR chains, and the inverse direction on IAF chains with and without
    a context."""
    from nflows_tpu_torch.ops.cuda import maf_train

    tr, folded, args, kw = _b10_case(cuda, kind, context, n)
    before = maf_train.bwd_launch_count
    gx, grads = maf_train.maf_train_bwd_cuda(*args, folded, tr._layers, **kw)
    assert maf_train.bwd_launch_count == before + 1
    p_gx, p_grads = maf_train.maf_train_bwd_plain(*args, folded, tr._layers, **kw)
    torch.testing.assert_close(gx, p_gx, atol=2e-4 / n, rtol=1e-3)
    _maf_grads_close(grads, p_grads)
    if context is not None:
        torch.testing.assert_close(grads["ctx"], p_grads["ctx"], atol=2e-4 / n, rtol=1e-3)
        for k in ("wci", "bci", "wcb", "bcb"):
            # the band is at most half the largest entry: a stack of zeros fails
            assert p_grads[k].abs().max() >= 2 * 2e-4, (k, float(p_grads[k].abs().max()))
            torch.testing.assert_close(grads[k], p_grads[k], atol=2e-4, rtol=1e-3,
                                       msg=lambda m: f"{k}: {m}")  # noqa: B023
    if n == 16384:
        _, g32 = maf_train.maf_train_bwd_cuda(*args, folded, tr._layers, rows=32, **kw)
        _maf_grads_close(g32, grads, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind,context", [
    ("affine", None), ("rq", None), ("affine", 3), ("rq", 3), ("iaf", None), ("iaf", 3)])
def test_b10_on_every_cluster_size_matches_plain(cuda, kind, context):
    """B10 at one block a tile (csrc/maf_train.cu) and on clusters of every
    size (csrc/maf_train_cluster.cu), 32-sample tiles, against its plain
    version at N = 1, 33, 509, 512 and 2,048 (fewer tiles than clusters, a
    ragged last tile, several tiles a cluster), on MAF and NSF-AR chains
    with and without a context and on IAF chains (the inverse direction),
    in the bands of test_b10_with_context_and_inverse_direction_matches_plain:
    gx and gctx 2e-4 / N plus 1e-3 relative, or no further from float64 than
    twice the plain fp32 version (_hold), the gradient stacks 2e-4 plus 1e-3
    relative, the context stacks' gradients clear of that band; a second
    launch into the same buffers starts from zero again; one block a tile
    and clusters of 8 agree within fp32 rounding (the depth of each dot
    product is split over warps on a cluster): gx x N 1e-4 plus 1e-4
    relative, the gradients 1e-5 plus 1e-4 relative."""
    from nflows_tpu_torch.ops.cuda import maf_train

    flow = _cond_ar_flow(cuda, kind, context=context)
    cls = maf_train.FusedIAFTrainer if kind == "iaf" else maf_train.FusedMAFTrainer
    tr = cls(flow, 128)
    folded = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    f64 = {k: v.double() for k, v in folded.items()}
    for n in (1, 33, 509, 512, 2048):
        g = torch.Generator().manual_seed(n + 13)
        x = (1.5 * torch.randn(n, 5, generator=g)).to(cuda)
        gy = torch.randn(n, 5, generator=g).to(cuda) / n
        glad = torch.randn(n, generator=g).to(cuda) / n
        ctx = None if context is None else torch.randn(n, context, generator=g).to(cuda)
        kw = dict(wh_scale=tr._wh_scale, context=ctx, direction=tr._direction, **tr._static)
        p_gx, p_grads = maf_train.maf_train_bwd_plain(x, gy, glad, folded, tr._layers, **kw)
        d_gx, d_grads = maf_train.maf_train_bwd_plain(
            x.double(), gy.double(), glad.double(), f64, tr._layers,
            **{**kw, "context": None if ctx is None else ctx.double()})
        seen = {}
        for cluster in (1, *maf_train.CLUSTER_SIZES):
            before = dict(maf_train.cluster_launch_count)
            gx, grads = maf_train.maf_train_bwd_cuda(x, gy, glad, folded, tr._layers, rows=32,
                                                     cluster=cluster, **kw)
            assert maf_train.cluster_launch_count[cluster] == before[cluster] + 1
            pairs = [(gx, p_gx, d_gx)] + ([(grads["ctx"], p_grads["ctx"], d_grads["ctx"])]
                                          if ctx is not None else [])
            for got, plain, exact in pairs:
                if not torch.allclose(got, plain, atol=2e-4 / n, rtol=1e-3):
                    _hold(got * n, plain * n, exact * n, 2e-4)
            _maf_grads_close(grads, p_grads)
            for k in ("wci", "bci", "wcb", "bcb") if ctx is not None else ():
                # the band is at most half the largest entry: a stack of zeros fails
                assert p_grads[k].abs().max() >= 2 * 2e-4, (k, float(p_grads[k].abs().max()))
                torch.testing.assert_close(grads[k], p_grads[k], atol=2e-4, rtol=1e-3,
                                           msg=lambda m: f"{k}: {m}")  # noqa: B023
            first = {k: v.clone() for k, v in grads.items() if k != "ctx"}
            _, again = maf_train.maf_train_bwd_cuda(
                x, gy, glad, folded, tr._layers, rows=32, cluster=cluster,
                grads={k: grads[k] for k in first}, **kw)
            for k in first:
                torch.testing.assert_close(again[k], first[k], atol=1e-5, rtol=1e-4)
            seen[cluster] = (gx, first)
        gx1, g1 = seen[1]
        gx8, g8 = seen[8]
        torch.testing.assert_close(gx8 * n, gx1 * n, atol=1e-4, rtol=1e-4)
        for k in g1:
            torch.testing.assert_close(g8[k], g1[k], atol=1e-5, rtol=1e-4)


def test_conditional_maf_serves_and_trains_through_the_kernels(cuda):
    """One B9 a conditional request; one B9 and one B10 a conditional fused
    step, whose first three losses agree with the eager route's."""
    import copy

    from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_train

    flow = _cond_ar_flow(cuda, "affine")
    g = torch.Generator().manual_seed(11)
    x, ctx = torch.randn(256, 5, generator=g).to(cuda), torch.randn(256, 3, generator=g).to(cuda)
    served = CompiledFlow(flow, batch_size=256, features=5, context_features=3)
    unfused = CompiledFlow(flow, batch_size=256, features=5, context_features=3,
                           use_fused=False)
    assert served.is_fused and not unfused.is_fused
    b9 = maf_flow_kernel.launch_count
    lp = served.log_prob(x, ctx)
    assert maf_flow_kernel.launch_count == b9 + 1
    _close(lp, unfused.log_prob(x, ctx), 1e-3)
    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    fused = fused_trainer(copy.deepcopy(flow), 128)
    step_fused = fused.make_train_step(fused.init_opt(adam))
    state = create_train_state(copy.deepcopy(flow).train(), adam)
    step_eager = make_train_step()
    for _ in range(3):
        batch = (1.5 * torch.randn(128, 5, generator=g)).to(cuda)
        c = torch.randn(128, 3, generator=g).to(cuda)
        c0 = (maf_flow_kernel.launch_count, maf_train.bwd_launch_count)
        loss_fused = step_fused(batch, c)
        c1 = (maf_flow_kernel.launch_count, maf_train.bwd_launch_count)
        assert tuple(b - a for a, b in zip(c0, c1)) == (1, 1)
        state, metrics = step_eager(state, batch, c)
        _close(loss_fused, metrics["loss"], 2e-4)


@pytest.mark.parametrize("context", [None, 3])
def test_iaf_vi_step_runs_b9_and_b10_and_agrees_with_autograd(cuda, context):
    """One B9 and one B10 a reverse-KL step; its loss and gradients agree
    with autograd through the unfused chain on the same noise."""
    import copy

    from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_train
    from nflows_tpu_torch.ops.cuda.maf_fused import _extract

    flow = _cond_ar_flow(cuda, "iaf", context=context)
    tr = fused_trainer(flow, 128)
    assert isinstance(tr, maf_train.FusedIAFTrainer)
    target = lambda v: -0.5 * ((v - 1.0) ** 2).sum(dim=1)  # noqa: E731
    g = torch.Generator().manual_seed(5)
    z = torch.randn(128, 5, generator=g).to(cuda)
    ctx = None if context is None else torch.randn(128, context, generator=g).to(cuda)
    x, lq = tr.sample_and_log_prob_fn(tr.weights, z, ctx)
    loss = (lq - target(x)).mean()
    grads = dict(zip(tr.weights, torch.autograd.grad(loss, list(tr.weights.values()))))
    xe, lad = flow.transform.inverse(z, ctx)
    loss_e = ((-0.5 * (z * z).sum(dim=1) - 2.5 * np.log(2 * np.pi) - lad) - target(xe)).mean()
    _close(loss, loss_e, 1e-4)
    g_flow = copy.deepcopy(flow)
    with torch.no_grad():
        for p, ge in zip(g_flow.parameters(), torch.autograd.grad(loss_e, list(flow.parameters()))):
            p.copy_(ge)
    want = _extract(g_flow, torch.float32, fold_masks=False, fold_wh_scale=False,
                    return_masks=True)[1]
    for k, got in grads.items():
        torch.testing.assert_close(got, want[k], atol=2e-4, rtol=1e-3,
                                   msg=lambda m: f"{k}: {m}")  # noqa: B023
    step = tr.make_vi_train_step(tr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-3)), target)
    c0 = (maf_flow_kernel.launch_count, maf_train.bwd_launch_count)
    first = step(torch.Generator(device=cuda).manual_seed(6), ctx)
    c1 = (maf_flow_kernel.launch_count, maf_train.bwd_launch_count)
    assert tuple(b - a for a, b in zip(c0, c1)) == (1, 1) and torch.isfinite(first)


# -- the mixture-density family: B11 and B12 ----------------------------------------
# B11 as B2 (1e-3 on lp: fp32 GEMMs summed in another order than cuBLAS, a
# sum over features of logsumexps). B12 as B4 and B10: gradients 2e-4 of the
# plain version's plus 1e-3 of its size, gx and gctx 2e-4 / N plus 1e-3
# relative (their cotangents come at scale 1/N).

MOG_CASES = {
    "narrow": dict(features=5, hidden_features=64, num_mixture_components=4,
                   context_features=None),
    "narrow_context": dict(features=5, hidden_features=64, num_mixture_components=4,
                           context_features=3),
    "full_context": dict(features=10, hidden_features=256, num_mixture_components=10,
                         context_features=10),
}


def _mog(device, case):
    from nflows_tpu_torch import MixtureOfGaussiansMADE

    cfg = MOG_CASES[case]
    return MixtureOfGaussiansMADE(num_blocks=2, generator=torch.Generator().manual_seed(7),
                                  rng=np.random.default_rng(7), device=device, **cfg).eval()


def _mog_inputs(device, case, n, seed):
    cfg = MOG_CASES[case]
    g = torch.Generator().manual_seed(seed)
    x = (1.5 * torch.randn(n, cfg["features"], generator=g)).to(device)
    cf = cfg["context_features"]
    c = None if cf is None else torch.randn(n, cf, generator=g).to(device)
    return x, c


@pytest.mark.parametrize("case", sorted(MOG_CASES))
@pytest.mark.parametrize("n", [203, 16384])
def test_b11_matches_plain(cuda, case, n):
    """203 leaves a ragged last tile of 32 samples."""
    from nflows_tpu_torch.ops.cuda import mademog_fused

    fused = mademog_fused.fuse_mademog(_mog(cuda, case))
    x, c = _mog_inputs(cuda, case, n, seed=n)
    before = mademog_fused.launch_count
    lp = mademog_fused.mademog_log_prob_cuda(x, fused._weights, fused._static, c,
                                             packed=fused._packed)
    assert mademog_fused.launch_count == before + 1
    _close(lp, mademog_fused.mademog_log_prob_plain(x, fused._weights, fused._static, c), 1e-3)
    again = mademog_fused.mademog_log_prob_cuda(x, fused._weights, fused._static, c)
    assert torch.equal(lp, again)              # no atomics: the same bits every launch
    with pytest.raises(ValueError):
        mademog_fused.mademog_log_prob_cuda(x.double(), fused._weights, fused._static, c)
    if c is not None:
        with pytest.raises(ValueError, match="context"):
            mademog_fused.mademog_log_prob_cuda(x, fused._weights, fused._static)


# B11's two routes: tensor cores (wgmma) and fp32 FMAs (simt). "two_pass":
# 300 parameter rows at hidden 64, the final layer in two passes of the
# wgmma route (256 rows, then 64); the narrow cases' 60 rows take one.
B11_ROUTE_CASES = {**MOG_CASES,
                   "two_pass": dict(features=10, hidden_features=64, num_mixture_components=10,
                                    context_features=None)}


@pytest.mark.parametrize("n", [203, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(B11_ROUTE_CASES))
def test_b11_both_routes_match_plain(cuda, case, dtype, n):
    """B11 on the wgmma kernel (the route these widths take) and on the SIMT
    kernel (forced), each against the plain version: fp32 within 1e-3 or
    twice the plain version's distance from float64, and by its relative
    errors within ONE_PASS_LIMITS; bf16 in the bf16 bands against the bf16
    plain version; each launch counted on its route, and a relaunch of
    the wgmma kernel bit-equal. 203 leaves a ragged last tile."""
    from nflows_tpu_torch import MixtureOfGaussiansMADE
    from nflows_tpu_torch.ops.cuda import mademog_fused

    cfg = B11_ROUTE_CASES[case]
    model = MixtureOfGaussiansMADE(num_blocks=2, generator=torch.Generator().manual_seed(7),
                                   rng=np.random.default_rng(7), device=cuda, **cfg).eval()
    fused = mademog_fused.fuse_mademog(model, dtype=dtype)
    w, st = fused._weights, fused._static
    assert mademog_fused.weights_route(w, st) == "wgmma" and "wgmma" in fused._packed
    g = torch.Generator().manual_seed(n)
    x = (1.5 * torch.randn(n, cfg["features"], generator=g)).to(cuda)
    cf = cfg["context_features"]
    c = None if cf is None else torch.randn(n, cf, generator=g).to(cuda)
    plain = mademog_fused.mademog_log_prob_plain(x, w, st, c)
    if dtype == torch.float32:
        exact = mademog_fused.mademog_log_prob_plain(
            x.double(), {k: v.double() for k, v in w.items()}, st,
            None if c is None else c.double())
    else:
        w32 = mademog_fused.fuse_mademog(model)._weights
        plain32 = mademog_fused.mademog_log_prob_plain(x, w32, st, c)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    for route in ("wgmma", "simt"):
        before = dict(mademog_fused.route_launch_count)
        lp = mademog_fused.mademog_log_prob_cuda(x, w, st, c, packed=fused._packed,
                                                 gemm=None if route == "wgmma" else route)
        after = dict(mademog_fused.route_launch_count)
        assert after[route + suffix] == before[route + suffix] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        assert lp.shape == (n,) and torch.isfinite(lp).all()
        if dtype == torch.float32:
            _hold(lp, plain, exact, 1e-3)
            _hold_relative(lp, plain, exact, limits=ONE_PASS_LIMITS)
        else:
            _bf16_hold(lp, plain, plain32, BF16_LAD)
        if route == "wgmma":
            again = mademog_fused.mademog_log_prob_cuda(x, w, st, c, gemm="wgmma")
            assert torch.equal(lp, again)       # no atomics: the same bits every launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compiled_flow_b11_routes(cuda, dtype):
    """A MoG-MADE's log_prob request is one wgmma launch of its weight type;
    the fused trainer's step launches the SIMT kernel; a width the tensor
    cores do not take stays on SIMT, and forcing wgmma there raises."""
    from nflows_tpu_torch import MixtureOfGaussiansMADE
    from nflows_tpu_torch.ops.cuda import mademog_fused

    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    model = _mog(cuda, "narrow_context")
    server = CompiledFlow(model, batch_size=256, features=5, context_features=3, dtype=dtype)
    assert server.is_fused
    g = torch.Generator().manual_seed(22)
    x, c = torch.randn(256, 5, generator=g).to(cuda), torch.randn(256, 3, generator=g).to(cuda)
    before = dict(mademog_fused.route_launch_count)
    lp = server.log_prob(x.to(dtype) if dtype == torch.bfloat16 else x, c)
    moved = {r: mademog_fused.route_launch_count[r] - before[r] for r in before}
    assert torch.isfinite(lp).all()
    assert moved == {r: int(r == "wgmma" + suffix) for r in before}, moved
    tr = fused_trainer(model, 128)
    step = tr.make_train_step(tr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-3)))
    before = dict(mademog_fused.route_launch_count)
    step(x[:128].contiguous(), c[:128].contiguous())
    moved = {r: mademog_fused.route_launch_count[r] - before[r] for r in before}
    assert moved == {"simt": 1, "wgmma": 0, "simt_bf16": 0, "wgmma_bf16": 0}
    narrow = mademog_fused.fuse_mademog(MixtureOfGaussiansMADE(
        features=5, hidden_features=32, num_blocks=2, num_mixture_components=4,
        generator=torch.Generator().manual_seed(23), rng=np.random.default_rng(23),
        device=cuda).eval(), dtype=dtype)
    assert mademog_fused.weights_route(narrow._weights, narrow._static) == "simt"
    assert "wgmma" not in narrow._packed
    before = dict(mademog_fused.route_launch_count)
    lp = mademog_fused.mademog_log_prob_cuda(x, narrow._weights, narrow._static,
                                             packed=narrow._packed)
    assert mademog_fused.route_launch_count["simt" + suffix] == before["simt" + suffix] + 1
    _close(lp, mademog_fused.mademog_log_prob_plain(x, narrow._weights, narrow._static),
           1e-3 if dtype == torch.float32 else BF16_LAD)
    with pytest.raises(ValueError, match="wgmma"):
        mademog_fused.mademog_log_prob_cuda(x, narrow._weights, narrow._static, gemm="wgmma")


@pytest.mark.parametrize("case", sorted(MOG_CASES))
@pytest.mark.parametrize("n", [203, 16384])
def test_b12_matches_plain(cuda, case, n):
    """203 leaves a ragged last tile; 16,384 gives each block of the
    persistent grid several tiles."""
    from nflows_tpu_torch.ops.cuda import mademog_train

    tr = mademog_train.FusedMADEMoGTrainer(_mog(cuda, case), 128)
    folded = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    x, c = _mog_inputs(cuda, case, n, seed=n + 1)
    glp = torch.randn(n, generator=torch.Generator().manual_seed(n + 2)).to(cuda) / n
    before = mademog_train.bwd_launch_count
    gx, gctx, grads = mademog_train.mademog_train_bwd_cuda(x, glp, folded, tr._static, c)
    assert mademog_train.bwd_launch_count == before + 1
    p_gx, p_gctx, p_grads = mademog_train.mademog_train_bwd_plain(x, glp, folded, tr._static, c)
    torch.testing.assert_close(gx, p_gx, atol=2e-4 / n, rtol=1e-3)
    if c is None:
        assert gctx is None
    else:
        torch.testing.assert_close(gctx, p_gctx, atol=2e-4 / n, rtol=1e-3)
    assert sorted(grads) == sorted(p_grads)
    for k in grads:
        torch.testing.assert_close(grads[k], p_grads[k], atol=2e-4, rtol=1e-3,
                                   msg=lambda m: f"{k}: {m}")  # noqa: B023
    # a second launch into the same buffers starts from zero again
    first = {k: v.clone() for k, v in grads.items()}
    _, _, again = mademog_train.mademog_train_bwd_cuda(x, glp, folded, tr._static, c,
                                                       grads=grads)
    assert all(again[k] is grads[k] for k in again)
    for k in grads:
        torch.testing.assert_close(again[k], first[k], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("case", sorted(MOG_CASES))
def test_b12_on_every_cluster_size_matches_plain(cuda, case):
    """B12 at one block a tile (csrc/mademog_train.cu) and on clusters of
    every size (csrc/mademog_train_cluster.cu) against its plain version at
    N = 1, 33, 509, 512 and 2,048 (fewer tiles than clusters, a ragged last
    tile, several tiles a cluster), with and without a context, in the
    bands of test_b12_matches_plain: gx and gctx 2e-4 / N plus 1e-3
    relative, the gradients 2e-4 plus 1e-3 relative; a second launch into
    the same buffers starts from zero again; one block a tile and clusters
    of 8 agree within fp32 rounding (the depth of each dot product is split
    over warps on a cluster): gx and gctx x N 1e-4 plus 1e-4 relative, the
    gradients 1e-5 plus 1e-4 relative."""
    from nflows_tpu_torch.ops.cuda import mademog_train

    tr = mademog_train.FusedMADEMoGTrainer(_mog(cuda, case), 128)
    folded = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    for n in (1, 33, 509, 512, 2048):
        x, c = _mog_inputs(cuda, case, n, seed=n + 17)
        glp = torch.randn(n, generator=torch.Generator().manual_seed(n + 18)).to(cuda) / n
        p_gx, p_gctx, p_grads = mademog_train.mademog_train_bwd_plain(x, glp, folded,
                                                                      tr._static, c)
        seen = {}
        for cluster in (1, *mademog_train.CLUSTER_SIZES):
            before = dict(mademog_train.cluster_launch_count)
            gx, gctx, grads = mademog_train.mademog_train_bwd_cuda(x, glp, folded, tr._static, c,
                                                                   cluster=cluster)
            assert mademog_train.cluster_launch_count[cluster] == before[cluster] + 1
            torch.testing.assert_close(gx, p_gx, atol=2e-4 / n, rtol=1e-3)
            if c is None:
                assert gctx is None
            else:
                torch.testing.assert_close(gctx, p_gctx, atol=2e-4 / n, rtol=1e-3)
            assert sorted(grads) == sorted(p_grads)
            for k in grads:
                torch.testing.assert_close(grads[k], p_grads[k], atol=2e-4, rtol=1e-3,
                                           msg=lambda m: f"{k}: {m}")  # noqa: B023
            first = {k: v.clone() for k, v in grads.items()}
            _, again_ctx, again = mademog_train.mademog_train_bwd_cuda(
                x, glp, folded, tr._static, c, grads=grads, cluster=cluster)
            for k in grads:
                torch.testing.assert_close(again[k], first[k], atol=1e-5, rtol=1e-4)
            if c is not None:
                torch.testing.assert_close(again_ctx * n, gctx * n, atol=1e-5, rtol=1e-4)
            seen[cluster] = (gx, gctx, first)
        (gx1, gctx1, g1), (gx8, gctx8, g8) = seen[1], seen[8]
        torch.testing.assert_close(gx8 * n, gx1 * n, atol=1e-4, rtol=1e-4)
        if c is not None:
            torch.testing.assert_close(gctx8 * n, gctx1 * n, atol=1e-4, rtol=1e-4)
        for k in g1:
            torch.testing.assert_close(g8[k], g1[k], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("case", ["narrow", "narrow_context"])
def test_compiled_flow_serves_a_mademog_with_one_launch_a_log_prob(cuda, case):
    from nflows_tpu_torch import MADEMoG
    from nflows_tpu_torch.ops.cuda import mademog_fused

    cfg = MOG_CASES[case]
    dist = MADEMoG(num_blocks=2, custom_initialization=True, device=cuda,
                   generator=torch.Generator().manual_seed(3), **cfg).eval()
    x, c = _mog_inputs(cuda, case, 256, seed=3)
    kw = dict(batch_size=256, features=cfg["features"], num_samples=None if c is None else 1,
              context_features=cfg["context_features"])
    fused = CompiledFlow(dist, **kw)
    unfused = CompiledFlow(dist, use_fused=False, **kw)
    assert fused.is_fused and not unfused.is_fused
    b11 = mademog_fused.launch_count
    lp = fused.log_prob(x, c)
    assert mademog_fused.launch_count == b11 + 1
    s, slp = fused.sample_and_log_prob(torch.Generator(device=cuda).manual_seed(4), c)
    assert mademog_fused.launch_count == b11 + 2     # the samples' log_prob
    _close(lp, unfused.log_prob(x, c), 1e-3)
    assert mademog_fused.launch_count == b11 + 2
    assert torch.isfinite(s).all() and torch.isfinite(slp).all()
    # a conditional request draws one sample a context row
    _close(slp.reshape(256), fused.log_prob(s.reshape(256, cfg["features"]), c), 5e-3)


@pytest.mark.parametrize("case", ["narrow", "narrow_context"])
def test_mademog_train_steps_launch_the_kernels_and_keep_masked_entries(cuda, case):
    """One B11 and one B12 a fused step; three Adam steps of the fused and
    the eager route from the same weights give the same losses; a masked
    entry's gradient is exactly zero and the entry does not move."""
    import copy

    from nflows_tpu_torch.ops.cuda import mademog_fused, mademog_train

    model = _mog(cuda, case)
    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    fused = fused_trainer(copy.deepcopy(model), 128)
    assert isinstance(fused, mademog_train.FusedMADEMoGTrainer)
    start = {k: v.detach().clone() for k, v in fused.weights.items()}
    step_fused = fused.make_train_step(fused.init_opt(adam))
    state = create_train_state(copy.deepcopy(model).train(), adam)
    step_eager = make_train_step()
    for i in range(3):
        x, c = _mog_inputs(cuda, case, 128, seed=20 + i)
        c0 = (mademog_fused.launch_count, mademog_train.bwd_launch_count)
        loss_fused = step_fused(x, c)
        c1 = (mademog_fused.launch_count, mademog_train.bwd_launch_count)
        assert tuple(b - a for a, b in zip(c0, c1)) == (1, 1)
        state, metrics = step_eager(state, x, c)
        assert (mademog_fused.launch_count, mademog_train.bwd_launch_count) == c1
        _close(loss_fused, metrics["loss"], 2e-4)
    for k in mademog_fused.MASKED_KEYS:
        dead = fused._masks[k] == 0
        assert torch.equal(fused.weights[k].grad[dead], torch.zeros_like(start[k][dead]))
        assert torch.equal(fused.weights[k].detach()[dead], start[k][dead])
        assert not torch.equal(fused.weights[k].detach()[~dead], start[k][~dead])
    x, c = _mog_inputs(cuda, case, 128, seed=30)
    _close(fused.to_dist().log_prob(x, c), state.flow.log_prob(x, c), 5e-3)


# -- B5-B8: the elementwise spline kernels of the other coupling families ------------

from nflows_tpu_torch.flows.base import Flow  # noqa: E402
from nflows_tpu_torch.distributions import StandardNormal  # noqa: E402
from nflows_tpu_torch.nn import nets  # noqa: E402
from nflows_tpu_torch.ops import splines  # noqa: E402
from nflows_tpu_torch.ops.cuda import (  # noqa: E402
    cubic_spline,
    linear_spline,
    lrs_spline,
    quadratic_spline,
)
from nflows_tpu_torch.utils.masks import create_alternating_binary_mask  # noqa: E402
from nflows_tpu_torch.transforms import (  # noqa: E402
    CompositeTransform,
    PiecewiseCubicCouplingTransform,
    PiecewiseLinearCouplingTransform,
    PiecewiseQuadraticCouplingTransform,
    RandomPermutation,
)

# family -> (parameter widths for K, wrapper module, wrapper, plain version)
SPLINE_FAMILIES = {
    "lrs": (lambda K: (K, K, K - 1, K), lrs_spline, lrs_spline.lrs_spline_cuda,
            splines.linear_rational.unconstrained_linear_rational_spline_plain),
    "linear": (lambda K: (K,), linear_spline, linear_spline.linear_spline_cuda,
               splines.linear.unconstrained_linear_spline_plain),
    "quadratic": (lambda K: (K, K - 1), quadratic_spline,
                  quadratic_spline.quadratic_spline_cuda,
                  splines.quadratic.unconstrained_quadratic_spline_plain),
    "cubic": (lambda K: (K, K, 1, 1), cubic_spline, cubic_spline.cubic_spline_cuda,
              splines.cubic.unconstrained_cubic_spline_plain),
}


def _family_inputs(family, K, device, seed=0, shape=(512, 3)):
    rng = np.random.default_rng(seed)
    x = (2.5 * rng.standard_normal(shape)).astype(np.float32)
    x.reshape(-1)[:4] = [B, -B, B + 0.5, -B - 0.5]
    arrays = [x] + [(0.5 * rng.standard_normal(shape + (p,))).astype(np.float32)
                    for p in SPLINE_FAMILIES[family][0](K)]
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("family", sorted(SPLINE_FAMILIES))
@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_b5_to_b8_match_plain(cuda, family, K, inverse):
    _, module, wrapper, plain = SPLINE_FAMILIES[family]
    args = _family_inputs(family, K, cuda, seed=K)
    before = module.launch_count
    out, lad = wrapper(*args, inverse=inverse, tail_bound=B)
    assert module.launch_count == before + 1
    p_out, p_lad = plain(*args, inverse=inverse, tail_bound=B)
    _close(out, p_out, 1e-4)
    _close(lad, p_lad, 1e-3)
    outside = args[0].abs() > B
    assert torch.equal(out[outside], args[0][outside]) and not lad[outside].any()


@pytest.mark.parametrize("family", sorted(SPLINE_FAMILIES))
@pytest.mark.parametrize("inverse", [False, True])
def test_b5_to_b8_gradients_match_plain(cuda, family, inverse):
    _, module, wrapper, plain = SPLINE_FAMILIES[family]
    args = _family_inputs(family, 8, cuda, seed=1)
    args[0].clamp_(-B + 0.1, B - 0.1)  # away from the clamp's tie at +-B
    leaves = [t.clone().requires_grad_(True) for t in args]
    before = module.launch_count
    out, lad = wrapper(*leaves, inverse=inverse, tail_bound=B)
    (out * 1.3 + lad * 0.7).sum().backward()
    assert module.launch_count == before + 1
    ref = [t.clone().requires_grad_(True) for t in args]
    p_out, p_lad = plain(*ref, inverse=inverse, tail_bound=B)
    (p_out * 1.3 + p_lad * 0.7).sum().backward()
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("family", sorted(SPLINE_FAMILIES))
def test_b5_to_b8_wrappers_refuse_what_the_kernels_do_not_take(cuda, family):
    wrapper = SPLINE_FAMILIES[family][2]
    args = _family_inputs(family, 8, cuda)
    with pytest.raises(TypeError):
        wrapper(*[t.double() for t in args], tail_bound=B)
    with pytest.raises(ValueError):
        wrapper(args[0].t(), *[t.transpose(0, 1) for t in args[1:]], tail_bound=B)
    with pytest.raises(ValueError):
        wrapper(args[0][:-1].contiguous(), *args[1:], tail_bound=B)


# B1, B5, B6, B7 and B8 run a group of lanes an element (csrc/spline_lanes.cuh): K sets
# the group, G = lanes_for(ceil(K / 4)) lanes of 4 bins each, and past 128
# bins the warp's chunks; n sets the elements a warp takes (in rounds) and
# need not fill the last block. GROUP_BINS reaches each instantiation, with
# rows that take 16-byte loads (K % 4 == 0) and rows that do not: G = 2 at
# K = 1 to 8, G = 4 at 9 to 16, G = 8 at 17 to 32, G = 16 at 33 to 64, the
# whole warp at 65 to 128, and in chunks past 128
GROUP_BINS = (1, 2, 5, 8, 12, 13, 16, 24, 27, 32, 33, 40, 100, 127, 128, 129, 200)
GROUP_SPLINES = {
    "rq": (lambda K: (K, K, K - 1), rq_spline, rq_spline.rq_spline_cuda,
           rq.unconstrained_rational_quadratic_spline_plain),
    "lrs": SPLINE_FAMILIES["lrs"],
    "linear": SPLINE_FAMILIES["linear"],
    "quadratic": SPLINE_FAMILIES["quadratic"],
    "cubic": SPLINE_FAMILIES["cubic"],
}


@pytest.mark.parametrize("family,K", [(f, K) for f in sorted(GROUP_SPLINES)
                                      for K in GROUP_BINS
                                      if not (f == "quadratic" and K == 1)])
@pytest.mark.parametrize("n", [1, 1001, 140001])
@pytest.mark.parametrize("inverse", [False, True])
def test_b1_b5_b6_b7_b8_every_group_size_matches_plain(cuda, family, K, n, inverse):
    widths, module, wrapper, plain = GROUP_SPLINES[family]
    rng = np.random.default_rng(1000 * K + n)
    x = (2.5 * rng.standard_normal(n)).astype(np.float32)
    x[:4] = np.array([B, -B, B + 0.5, -B - 0.5], np.float32)[:n]
    args = [torch.from_numpy(a).to(cuda) for a in
            [x] + [(0.5 * rng.standard_normal((n, p))).astype(np.float32) for p in widths(K)]]
    before = module.launch_count
    out, lad = wrapper(*args, inverse=inverse, tail_bound=B)
    torch.cuda.synchronize()
    assert module.launch_count == before + 1
    p_out, p_lad = plain(*args, inverse=inverse, tail_bound=B)
    d_out, d_lad = plain(*[t.double() for t in args], inverse=inverse, tail_bound=B)
    _hold(out, p_out, d_out, 1e-4)
    _hold(lad, p_lad, d_lad, 1e-3)
    outside = args[0].abs() > B
    assert torch.equal(out[outside], args[0][outside]) and not lad[outside].any()


def test_b7_refuses_a_single_bin(cuda):
    x = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):
        quadratic_spline.quadratic_spline_cuda(x, torch.zeros(4, 1, device=cuda),
                                               torch.zeros(4, 0, device=cuda), tail_bound=B)


def _family_flow(device, family, features=6, hidden=32, layers=10, bins=8):
    """The flagship's chain with the family's coupling: ``layers`` x [random
    permutation, coupling with a 2-block ResidualNet], linear tails."""
    if family == "lrs":
        return NeuralSplineFlow(
            features, hidden, num_layers=layers, num_bins=bins, tail_bound=B, spline="lrs",
            generator=torch.Generator().manual_seed(features),
            rng=np.random.default_rng(features), device=device).eval()
    cls = {"linear": PiecewiseLinearCouplingTransform,
           "quadratic": PiecewiseQuadraticCouplingTransform,
           "cubic": PiecewiseCubicCouplingTransform}[family]
    gen = torch.Generator().manual_seed(features)
    rng = np.random.default_rng(features)
    chain = []
    for i in range(layers):
        chain.append(RandomPermutation(features, rng=rng, device=device))
        chain.append(cls(
            mask=create_alternating_binary_mask(features, even=bool(i % 2)),
            transform_net_create_fn=lambda n_in, n_out: nets.ResidualNet(
                n_in, n_out, hidden_features=hidden, num_blocks=2, generator=gen,
                device=device),
            num_bins=bins, tails="linear", tail_bound=B, device=device))
    return Flow(CompositeTransform(chain), StandardNormal([features])).to(device).eval()


@pytest.mark.parametrize("family", sorted(SPLINE_FAMILIES))
def test_compiled_flow_launches_ten_family_kernels_a_request(cuda, family):
    """Unfused (``use_fused=False``): one launch of the family's kernel in
    each of the 10 couplings a request. Fused (the default): one B2."""
    module = SPLINE_FAMILIES[family][1]
    flow = _family_flow(cuda, family)
    served = CompiledFlow(flow, batch_size=256, features=6, use_fused=False)
    fused = CompiledFlow(flow, batch_size=256, features=6)
    assert fused.is_fused and not served.is_fused
    x = torch.randn(256, 6, generator=torch.Generator().manual_seed(3)).to(cuda)
    before, b1, b2 = module.launch_count, rq_spline.launch_count, nsf_flow_kernel.launch_count
    lp = served.log_prob(x)
    assert module.launch_count == before + 10
    s, lp2 = served.sample_and_log_prob(torch.Generator(device=cuda).manual_seed(4))
    assert module.launch_count == before + 20 and rq_spline.launch_count == b1
    assert nsf_flow_kernel.launch_count == b2
    assert torch.isfinite(lp).all() and torch.isfinite(lp2).all()
    _close(lp2, served.log_prob(s), 5e-3)
    lp_fused = fused.log_prob(x)
    assert nsf_flow_kernel.launch_count == b2 + 1 and module.launch_count == before + 30
    _close(lp_fused, lp, 1e-3)


# -- B2's other families, and B3 and B4 for the affine and additive couplings ---------
#
# Tolerances as for the rq family: B2 1e-3 on outputs and logabsdet, plus
# 1e-5 relative (the affine inverse divides by scales down to 1e-3); B3 and
# B4 as above.

from nflows_tpu_torch import SimpleRealNVP  # noqa: E402
from nflows_tpu_torch.transforms import AffineCouplingTransform  # noqa: E402


def _affine_flow(device, kind, features=6, hidden=64, layers=4):
    """SimpleRealNVP ("affine", "additive"), or its chain with the GENERAL
    scale activation ("general")."""
    gen = torch.Generator().manual_seed(features)
    flow = SimpleRealNVP(features, hidden, layers, 2, use_volume_preserving=kind == "additive",
                         generator=gen, device=device)
    if kind == "general":
        for t in flow.transform.transforms:
            t.scale_activation = AffineCouplingTransform.GENERAL_SCALE_ACTIVATION
    return flow.eval()


def _any_family_flow(device, family):
    if family in ("affine", "general", "additive"):
        return _affine_flow(device, family)
    return _family_flow(device, family)


@pytest.mark.parametrize("family", ["lrs", "linear", "quadratic", "cubic", "affine", "general",
                                    "additive"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [203, 16384])
def test_b2_families_match_plain(cuda, family, inverse, n):
    fused = fuse_nsf(_any_family_flow(cuda, family))
    x = (1.5 * torch.randn(n, 6, generator=torch.Generator().manual_seed(n))).to(cuda)
    kw = dict(inverse=inverse, **fused._static)
    before = nsf_flow_kernel.launch_count
    y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(
        x, fused._weights, fused._indices, packed=fused._packed, **kw)
    assert nsf_flow_kernel.launch_count == before + 1
    p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, fused._weights, fused._indices, **kw)
    w64 = {k: v.double() for k, v in fused._weights.items()}
    d_y, d_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x.double(), w64, fused._indices, **kw)
    for got, plain, exact in ((y, p_y, d_y), (lad, p_lad, d_lad)):
        _hold(got, plain, exact, 1e-3)


def test_b2_scales_only_the_rows_a_quadratic_chain_has(cuda):
    """Unfolded weights with ``wh_scale`` on a narrow quadratic chain: T = 5
    and K = 2 give 2KT = 20 rows, more than its TM = 15 and than the hidden
    width 16; the kernel scales the 15 it has."""
    gen = torch.Generator().manual_seed(0)
    chain = [PiecewiseQuadraticCouplingTransform(
        mask=create_alternating_binary_mask(10, even=bool(i % 2)),
        transform_net_create_fn=lambda n_in, n_out: nets.ResidualNet(
            n_in, n_out, hidden_features=16, num_blocks=2, generator=gen, device=cuda),
        num_bins=2, tails="linear", tail_bound=B, device=cuda) for i in range(3)]
    flow = Flow(CompositeTransform(chain), StandardNormal([10])).to(cuda)
    from nflows_tpu_torch.ops.cuda.nsf_fused import _extract

    idx, w, static, _, _ = _extract(flow, torch.float32, fold_wh_scale=False)
    _, folded, _, _, _ = _extract(flow, torch.float32)
    x = torch.randn(203, 10, generator=torch.Generator().manual_seed(1)).to(cuda)
    for inverse in (False, True):
        y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, w, idx, inverse=inverse,
                                                      wh_scale=0.25, **static)
        p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, w, idx, inverse=inverse,
                                                           wh_scale=0.25, **static)
        f_y, f_lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, folded, idx, inverse=inverse,
                                                          **static)
        _close(y, p_y, 1e-4)
        _close(lad, p_lad, 1e-4)
        assert torch.isfinite(f_y).all() and torch.isfinite(f_lad).all()


@pytest.mark.parametrize("kind", ["affine", "general", "additive"])
@pytest.mark.parametrize("n", [203, 16384])
def test_b3_b4_affine_match_plain(cuda, kind, n):
    tr = nsf_train.FusedNSFTrainer(_affine_flow(cuda, kind), 128)
    (w, idx), kw = _train_args(tr)
    assert kw["wh_scale"] is None
    g = torch.Generator().manual_seed(n + 2)
    x = 1.5 * torch.randn(n, 6, generator=g).to(cuda)
    before = nsf_train.loss_grad_launch_count
    loss, lp, grads = nsf_train.nsf_loss_grad_cuda(x, w, idx, **kw)
    assert nsf_train.loss_grad_launch_count == before + 1
    p_loss, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, w, idx, **kw)
    _close(lp, p_lp, 1e-3)
    _close(loss, p_loss, 1e-4)
    _grads_close(grads, p_grads)
    gy = torch.randn(n, 6, generator=g).to(cuda) / n
    glad = torch.randn(n, generator=g).to(cuda) / n
    before = nsf_train.bwd_launch_count
    gx, grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, **kw)
    assert nsf_train.bwd_launch_count == before + 1
    p_gx, p_grads = nsf_train.nsf_train_bwd_plain(x, gy, glad, w, idx, **kw)
    torch.testing.assert_close(gx, p_gx, atol=2e-4 / n, rtol=1e-3)
    _grads_close(grads, p_grads)


@pytest.mark.parametrize("family", sorted(SPLINE_FAMILIES))
@pytest.mark.parametrize("n", [203, 16384])
def test_b3_b4_spline_families_match_plain(cuda, family, n):
    """The lrs, linear, quadratic and cubic stages' adjoints in B3 and B4, on
    the flagship's chain of the family (hidden 32, 8 bins).

    Ties are left out, as in the CPU tests: a sample whose path passes
    within fp32 rounding of a point where the chain's gradient jumps (a bin
    edge; the LRS join theta = lambda, where the logabsdet's derivative is
    discontinuous) takes either side in an fp32 evaluation. At 16,384
    samples the LRS chain has one, 1.6e-6 from its join in layer 8: its
    input cotangent moves by a factor of 3 and the weight gradients' sums
    by 1.1e-3. Ties are the samples whose B4 input cotangent x N departs
    from the float64 plain version's by more than 5e-3 (chip_smoke.py's band
    for it); at most 0.1% of the batch may be ties, and every check runs on
    the rest. Where fp32 rounding moves the plain version's sums past the
    band, a stack is held to float64 instead (``_grads_hold``)."""
    tr = nsf_train.FusedNSFTrainer(_family_flow(cuda, family), 128)
    (w, idx), kw = _train_args(tr)
    w64 = {k: v.detach().double() for k, v in w.items()}
    assert (kw["wh_scale"] is None) == (family == "linear")
    g = torch.Generator().manual_seed(n + 3)
    x = 1.5 * torch.randn(n, 6, generator=g).to(cuda)
    gy = torch.randn(n, 6, generator=g).to(cuda) / n
    glad = torch.randn(n, generator=g).to(cuda) / n
    gx, _ = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, **kw)
    d_gx, _ = nsf_train.nsf_train_bwd_plain(x.double(), gy.double(), glad.double(), w64, idx,
                                            **kw)
    keep = (gx.double() - d_gx).abs().amax(dim=1) * n <= 5e-3
    assert int((~keep).sum()) <= n // 1000
    x, gy, glad = x[keep].contiguous(), gy[keep].contiguous(), glad[keep].contiguous()

    before = nsf_train.loss_grad_launch_count
    loss, lp, grads = nsf_train.nsf_loss_grad_cuda(x, w, idx, **kw)
    assert nsf_train.loss_grad_launch_count == before + 1
    p_loss, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, w, idx, **kw)
    _, _, d_grads = nsf_train.nsf_loss_grad_plain(x.double(), w64, idx, **kw)
    _close(lp, p_lp, 1e-3)
    _close(loss, p_loss, 1e-4)
    _grads_hold(grads, p_grads, d_grads)
    before = nsf_train.bwd_launch_count
    gx, grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, **kw)
    assert nsf_train.bwd_launch_count == before + 1
    p_gx, p_grads = nsf_train.nsf_train_bwd_plain(x, gy, glad, w, idx, **kw)
    d_gx, d_grads = nsf_train.nsf_train_bwd_plain(x.double(), gy.double(), glad.double(), w64,
                                                  idx, **kw)
    if not torch.allclose(gx, p_gx, atol=2e-4 / n, rtol=1e-3):
        _hold(gx * n, p_gx * n, d_gx * n, 2e-4)
    _grads_hold(grads, p_grads, d_grads)


def test_training_kernels_refuse_the_other_spline_families(cuda):
    """The four spline families train through the kernels: one B3 a fused
    step, one B2 and one B4 an autograd-route step, the routes' losses
    equal to the eager one's; so does a conditional flow, given its context.
    A conditional flow with an embedding net is still refused."""
    import copy

    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    g = torch.Generator().manual_seed(11)
    for family in sorted(SPLINE_FAMILIES):
        flow = _family_flow(cuda, family, layers=4)
        fused = fused_trainer(copy.deepcopy(flow), 128)
        assert isinstance(fused, nsf_train.FusedNSFTrainer)
        split = fused_trainer(copy.deepcopy(flow), 128)
        step_fused = fused.make_train_step(fused.init_opt(adam))
        step_split = _autograd_step(split, split.init_opt(adam))
        state = create_train_state(copy.deepcopy(flow).train(), adam)
        step_eager = make_train_step()
        batch = (1.5 * torch.randn(128, 6, generator=g)).to(cuda)
        counts = lambda: (nsf_flow_kernel.launch_count, nsf_train.loss_grad_launch_count,  # noqa: E731
                          nsf_train.bwd_launch_count)
        c0 = counts()
        loss_fused = step_fused(batch)
        c1 = counts()
        loss_split = step_split(batch)
        c2 = counts()
        state, metrics = step_eager(state, batch)
        assert tuple(b - a for a, b in zip(c0, c1)) == (0, 1, 0)
        assert tuple(b - a for a, b in zip(c1, c2)) == (1, 0, 1)
        _close(loss_fused, loss_split, 2e-4)
        _close(loss_fused, metrics["loss"], 2e-4)
    gen = torch.Generator().manual_seed(0)
    conditional = Flow(CompositeTransform([PiecewiseQuadraticCouplingTransform(
        mask=create_alternating_binary_mask(6), transform_net_create_fn=lambda i, o:
        nets.ResidualNet(i, o, hidden_features=32, context_features=2, num_blocks=2,
                         generator=gen, device=cuda),
        num_bins=8, tails="linear", tail_bound=B, device=cuda)]), StandardNormal([6]))
    fused = fused_trainer(copy.deepcopy(conditional), 128)
    assert isinstance(fused, nsf_train.FusedNSFTrainer)
    split = fused_trainer(copy.deepcopy(conditional), 128)
    step_fused = fused.make_train_step(fused.init_opt(adam))
    split_opt = split.init_opt(adam)
    state = create_train_state(copy.deepcopy(conditional).train(), adam)
    step_eager = make_train_step()
    batch = (1.5 * torch.randn(128, 6, generator=g)).to(cuda)
    context = torch.randn(128, 2, generator=g).to(cuda)
    c0 = counts()
    loss_fused = step_fused(batch, context)
    c1 = counts()
    split_opt.zero_grad(set_to_none=True)
    loss_split = split.loss_fn(split.weights, batch, context)
    loss_split.backward()
    split_opt.step()
    c2 = counts()
    state, metrics = step_eager(state, batch, context)
    assert tuple(b - a for a, b in zip(c0, c1)) == (0, 1, 0)
    assert tuple(b - a for a, b in zip(c1, c2)) == (1, 0, 1)
    _close(loss_fused, loss_split, 2e-4)
    _close(loss_fused, metrics["loss"], 2e-4)
    embedded = Flow(conditional.transform, conditional.distribution,
                    embedding_net=torch.nn.Linear(4, 2).to(cuda))
    with pytest.raises(ValueError, match="make_train_step"):
        fused_trainer(embedded, 128)


def test_realnvp_serves_and_trains_through_the_kernels(cuda):
    """One B2 a fused request; one B3 a fused step, one B2 and one B4 an
    autograd-route step; the three routes' first losses agree."""
    import copy

    flow = _affine_flow(cuda, "affine")
    x = torch.randn(256, 6, generator=torch.Generator().manual_seed(3)).to(cuda)
    served = CompiledFlow(flow, batch_size=256, features=6)
    assert served.is_fused
    b2 = nsf_flow_kernel.launch_count
    lp = served.log_prob(x)
    assert nsf_flow_kernel.launch_count == b2 + 1
    _close(lp, flow.log_prob(x), 1e-3)
    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    fused = fused_trainer(copy.deepcopy(flow), 128)
    split = fused_trainer(copy.deepcopy(flow), 128)
    step_fused = fused.make_train_step(fused.init_opt(adam))
    step_split = _autograd_step(split, split.init_opt(adam))
    state = create_train_state(copy.deepcopy(flow).train(), adam)
    step_eager = make_train_step()
    g = torch.Generator().manual_seed(9)
    for _ in range(3):
        batch = (1.5 * torch.randn(128, 6, generator=g)).to(cuda)
        counts = lambda: (nsf_flow_kernel.launch_count, nsf_train.loss_grad_launch_count,  # noqa: E731
                          nsf_train.bwd_launch_count)
        c0 = counts()
        loss_fused = step_fused(batch)
        c1 = counts()
        loss_split = step_split(batch)
        c2 = counts()
        state, metrics = step_eager(state, batch)
        c3 = counts()
        assert tuple(b - a for a, b in zip(c0, c1)) == (0, 1, 0)
        assert tuple(b - a for a, b in zip(c1, c2)) == (1, 0, 1)
        assert c3 == c2
        _close(loss_fused, loss_split, 2e-4)
        _close(loss_fused, metrics["loss"], 2e-4)
    _close(fused.to_flow().log_prob(x), state.flow.log_prob(x), 5e-3)


# -- B2, B3 and B4 with a context ------------------------------------------------------

CONTEXT_FAMILIES = ["rq", "lrs", "linear", "quadratic", "cubic", "affine", "additive"]


def _context_flow(device, family, features=6, hidden=32, layers=4, context=3, seed=0):
    """``layers`` x [random permutation, conditional coupling of ``family``
    with a 2-block ResidualNet]. The blocks' second linear layers are redrawn
    at the first's scale: as initialised they start near zero, which leaves
    the context gate with gradients near 1e-5, under the 2e-4 band; the
    affine couplings' final weights are scaled by 0.1
    (chip_smoke.tame_couplings)."""
    from nflows_tpu_torch.transforms import (
        AdditiveCouplingTransform,
        PiecewiseLinearRationalCouplingTransform,
        PiecewiseRationalQuadraticCouplingTransform,
    )

    cls = {"rq": PiecewiseRationalQuadraticCouplingTransform,
           "lrs": PiecewiseLinearRationalCouplingTransform,
           "linear": PiecewiseLinearCouplingTransform,
           "quadratic": PiecewiseQuadraticCouplingTransform,
           "cubic": PiecewiseCubicCouplingTransform, "affine": AffineCouplingTransform,
           "additive": AdditiveCouplingTransform}[family]
    kw = ({} if family in ("affine", "additive")
          else dict(num_bins=8, tails="linear", tail_bound=B))
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    chain = []
    for i in range(layers):
        chain.append(RandomPermutation(features, rng=rng, device=device))
        chain.append(cls(mask=create_alternating_binary_mask(features, even=bool(i % 2)),
                         transform_net_create_fn=lambda n_in, n_out: nets.ResidualNet(
                             n_in, n_out, hidden_features=hidden, num_blocks=2,
                             context_features=context, generator=gen, device=device),
                         device=device, **kw))
    flow = Flow(CompositeTransform(chain), StandardNormal([features])).to(device)
    with torch.no_grad():
        for t in flow.transform.transforms[1::2]:
            net = t.transform_net
            for blk in net.blocks:
                bound = 1.0 / hidden ** 0.5
                blk.linear_1.weight.copy_((torch.rand(blk.linear_1.weight.shape, generator=gen)
                                           * 2 - 1).to(device) * bound)
            if family in ("affine", "additive"):
                net.final_layer.weight.mul_(0.1)
    return flow.eval()


def _hold_all(got, ref, ref64, atol=2e-4, rtol=1e-3):
    """``_grads_hold`` over every key of ``ref`` (the context stacks too)."""
    for k in ref:
        if not torch.allclose(got[k], ref[k], atol=atol, rtol=rtol):
            _hold(got[k], ref[k], ref64[k], atol)


def _past_band(got, plain, exact, atol=2e-4, rtol=1e-3):
    """Per sample (rows of [m, k] cotangents x N): further from the fp32
    plain version than ``atol`` + ``rtol`` |plain| somewhere, and from the
    float64 one than twice the fp32 plain version is (``_hold``, per
    sample)."""
    gap = ((got - plain).abs() > atol + rtol * plain.abs()).any(1)
    err = (got.double() - exact).abs().amax(1)
    return gap & (err > 2.0 * (plain.double() - exact).abs().amax(1))


def _kink_jumps(x, gy, glad, w64, idx, ctx, kw, n, step=1e-6):
    """For float64 samples x [m, D], the largest second difference
    |G(x + step e) + G(x - step e) - 2 G(x)| over the features e of the
    float64 plain B4's cotangents x n (gx, and gctx where there is a
    context): near 0 where they are smooth, the size of the jump where a
    kink (a relu's zero, a knot, a tail bound) lies within ``step``."""
    m, D = x.shape
    offsets = torch.zeros(2 * D + 1, D, dtype=x.dtype, device=x.device)
    for e in range(D):
        offsets[2 * e + 1, e], offsets[2 * e + 2, e] = step, -step
    rep = lambda t: t.repeat_interleave(2 * D + 1, 0)  # noqa: E731
    gx, grads = nsf_train.nsf_train_bwd_plain(
        rep(x) + offsets.repeat(m, 1), rep(gy), rep(glad), w64, idx,
        context=None if ctx is None else rep(ctx), **kw)
    G = (gx if ctx is None else torch.cat([gx, grads["ctx"]], 1)).reshape(m, 2 * D + 1, -1) * n
    return (G[:, 1::2] + G[:, 2::2] - 2 * G[:, :1]).abs().amax((1, 2))


def _hold_context_kernels(flow, n, context_features, seed):
    """B2 (both ways), B3 and B4 with a context against their plain
    versions, at chip_smoke.py's bands for B2 and the weight gradients, and
    at 2e-4 + 1e-3 relative (the band of B4's gx in
    test_b3_b4_spline_families_match_plain) for gx x N and gctx x N, per
    sample.

    Ties are left out, at most 0.1% of the batch: a sample whose path
    passes within fp32 rounding of a kink takes either side of it in fp32.
    A sample past the band counts as a tie only where the float64 plain
    version's own cotangents jump by at least half its error under a move of
    1e-6 (``_kink_jumps``). On the cubic flow at 4,096 (flow seed 0) one
    sample is one: a relu of layer 2's second block sits 2.4e-8 from its
    zero, and gx x N and gctx x N jump by 4.1e-4 there
    (tools/tie_probe.py)."""
    dev = next(flow.parameters()).device
    g = torch.Generator().manual_seed(seed)
    x = (1.5 * torch.randn(n, 6, generator=g)).to(dev)
    ctx = torch.randn(n, context_features, generator=g).to(dev)
    fused = fuse_nsf(flow)
    assert fused.context_features == context_features
    w64 = {k: v.double() for k, v in fused._weights.items()}
    for inverse in (False, True):
        kw = dict(inverse=inverse, **fused._static)
        before = nsf_flow_kernel.launch_count
        y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, fused._weights, fused._indices,
                                                      packed=fused._packed, context=ctx, **kw)
        assert nsf_flow_kernel.launch_count == before + 1
        p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, fused._weights, fused._indices,
                                                           context=ctx, **kw)
        d_y, d_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x.double(), w64, fused._indices,
                                                           context=ctx.double(), **kw)
        for got, plain, exact in ((y, p_y, d_y), (lad, p_lad, d_lad)):
            _hold(got, plain, exact, 1e-3)

    tr = nsf_train.FusedNSFTrainer(flow, 128)
    (w, idx), kw = _train_args(tr)
    w64 = {k: v.detach().double() for k, v in w.items()}
    gy = torch.randn(n, 6, generator=g).to(dev) / n
    glad = torch.randn(n, generator=g).to(dev) / n

    def cotangents(gx, grads):  # [n, D + C] x n
        return torch.cat([gx, grads["ctx"]], 1) * gx.shape[0]

    args = (x, gy, glad)
    got = cotangents(*nsf_train.nsf_train_bwd_cuda(*args, w, idx, context=ctx, **kw))
    plain = cotangents(*nsf_train.nsf_train_bwd_plain(*args, w, idx, context=ctx, **kw))
    exact = cotangents(*nsf_train.nsf_train_bwd_plain(*(a.double() for a in args), w64, idx,
                                                      context=ctx.double(), **kw))
    past = _past_band(got, plain, exact)
    ties = past.nonzero()[:, 0]
    assert len(ties) <= n // 1000, len(ties)
    if len(ties):
        err = (got[ties].double() - exact[ties]).abs().amax(1)
        jumps = _kink_jumps(*(a[ties].double() for a in (x, gy, glad)), w64, idx,
                            ctx[ties].double(), kw, n)
        assert (jumps >= 0.5 * err).all(), (err, jumps)
    keep = ~past
    x, ctx = x[keep].contiguous(), ctx[keep].contiguous()
    gy, glad = gy[keep].contiguous(), glad[keep].contiguous()
    before = nsf_train.loss_grad_launch_count
    loss, lp, grads = nsf_train.nsf_loss_grad_cuda(x, w, idx, context=ctx, **kw)
    assert nsf_train.loss_grad_launch_count == before + 1
    assert sorted(grads) == sorted(nsf_train.WEIGHT_KEYS + nsf_train.CONTEXT_KEYS)
    p_loss, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, w, idx, context=ctx, **kw)
    _, _, d_grads = nsf_train.nsf_loss_grad_plain(x.double(), w64, idx, context=ctx.double(),
                                                  **kw)
    _close(lp, p_lp, 1e-3)
    _close(loss, p_loss, 1e-4)
    _hold_all(grads, p_grads, d_grads)
    before = nsf_train.bwd_launch_count
    gx, grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, context=ctx, **kw)
    assert nsf_train.bwd_launch_count == before + 1
    p_gx, p_grads = nsf_train.nsf_train_bwd_plain(x, gy, glad, w, idx, context=ctx, **kw)
    d_gx, d_grads = nsf_train.nsf_train_bwd_plain(x.double(), gy.double(), glad.double(), w64,
                                                  idx, context=ctx.double(), **kw)
    assert not _past_band(cotangents(gx, grads), cotangents(p_gx, p_grads),
                          cotangents(d_gx, d_grads)).any()
    for g in (grads, p_grads, d_grads):
        g.pop("ctx")
    _hold_all(grads, p_grads, d_grads)


@pytest.mark.parametrize("family", CONTEXT_FAMILIES)
@pytest.mark.parametrize("n", [203, 4096])
def test_b2_b3_b4_with_context_match_plain(cuda, family, n):
    _hold_context_kernels(_context_flow(cuda, family), n, 3, seed=n + 5)


@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("family", CONTEXT_FAMILIES)
def test_b3_b4_on_every_cluster_size_match_plain(cuda, family, context):
    """B3 and B4 at one block a tile and on clusters of every size
    (csrc/nsf_train_cluster.cu), 32-sample tiles, against their plain
    versions at N = 1, 33, 509, 512 and 2,048: fewer tiles than clusters, a
    ragged last tile, several tiles a cluster; a second launch into the same
    buffers starts from zero again; one block a tile and clusters of 8 agree
    within fp32 rounding (the depth of each dot product is split over warps
    on a cluster, and the chain carries the rounding through four layers of
    spline adjoints): log_prob within 1e-5 + 1e-5 relative, gx x N within
    1e-4 + 1e-4 relative (half the band against the plain version), the
    weight gradients within 1e-5 + 1e-4 relative. Bands against the plain
    versions as in test_b3_b4_spline_families_match_plain; ties (B4's
    cotangents x N past 5e-3 of float64 at one block a tile) are left out,
    at most one sample or 0.1% of the batch, each checked to be a kink of
    the float64 chain (``_kink_jumps``)."""
    tr = nsf_train.FusedNSFTrainer(_context_flow(cuda, family, context=context), 128)
    (w, idx), kw = _train_args(tr)
    w64 = {k: v.detach().double() for k, v in w.items()}
    for n in (1, 33, 509, 512, 2048):
        g = torch.Generator().manual_seed(n + 11)
        x = 1.5 * torch.randn(n, 6, generator=g).to(cuda)
        ctx = None if context is None else torch.randn(n, context, generator=g).to(cuda)
        gy = torch.randn(n, 6, generator=g).to(cuda) / n
        glad = torch.randn(n, generator=g).to(cuda) / n
        gx, _ = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, rows=32, cluster=1,
                                             context=ctx, **kw)
        d_gx, _ = nsf_train.nsf_train_bwd_plain(
            x.double(), gy.double(), glad.double(), w64, idx,
            context=None if ctx is None else ctx.double(), **kw)
        err = (gx.double() - d_gx).abs().amax(dim=1) * n
        keep = err <= 5e-3
        ties = (~keep).nonzero()[:, 0]
        assert len(ties) <= max(1, n // 1000)
        if len(ties):  # each one a kink of the float64 chain within 1e-6
            jumps = _kink_jumps(*(a[ties].double() for a in (x, gy, glad)), w64, idx,
                                None if ctx is None else ctx[ties].double(), kw, n)
            assert (jumps >= 0.5 * err[ties]).all(), (err[ties], jumps)
        x, gy, glad = x[keep].contiguous(), gy[keep].contiguous(), glad[keep].contiguous()
        ctx = None if ctx is None else ctx[keep].contiguous()
        m = x.shape[0]
        ckw = dict(context=ctx, **kw)
        dkw = dict(kw, context=None if ctx is None else ctx.double())
        p_loss, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, w, idx, **ckw)
        _, _, d_grads = nsf_train.nsf_loss_grad_plain(x.double(), w64, idx, **dkw)
        p_gx, p_g4 = nsf_train.nsf_train_bwd_plain(x, gy, glad, w, idx, **ckw)
        d_gx, d_g4 = nsf_train.nsf_train_bwd_plain(x.double(), gy.double(), glad.double(),
                                                   w64, idx, **dkw)
        seen = {}
        for cluster in (1, *nsf_train.CLUSTER_SIZES):
            before = nsf_train.loss_grad_launch_count
            loss, lp, grads = nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=32, cluster=cluster,
                                                           **ckw)
            assert nsf_train.loss_grad_launch_count == before + 1
            _close(lp, p_lp, 1e-3)
            _close(loss, p_loss, 1e-4)
            _hold_all(grads, p_grads, d_grads)
            first = {k: v.clone() for k, v in grads.items()}
            _, _, again = nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=32, cluster=cluster,
                                                       grads=grads, **ckw)
            for k in first:
                torch.testing.assert_close(again[k], first[k], atol=1e-5, rtol=1e-4)
            before = nsf_train.bwd_launch_count
            gx, g4 = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, rows=32,
                                                  cluster=cluster, **ckw)
            assert nsf_train.bwd_launch_count == before + 1
            pairs = [(gx, p_gx, d_gx)] + ([(g4["ctx"], p_g4["ctx"], d_g4["ctx"])] if ctx is not
                                          None else [])
            for got, plain, exact in pairs:
                if not torch.allclose(got, plain, atol=2e-4 / m, rtol=1e-3):
                    _hold(got * m, plain * m, exact * m, 2e-4)
            _hold_all({k: v for k, v in g4.items() if k != "ctx"},
                      {k: v for k, v in p_g4.items() if k != "ctx"},
                      {k: v for k, v in d_g4.items() if k != "ctx"})
            seen[cluster] = (lp, first, gx)
        lp1, g1, gx1 = seen[1]
        lp8, g8, gx8 = seen[8]
        torch.testing.assert_close(lp8, lp1, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(gx8 * m, gx1 * m, atol=1e-4, rtol=1e-4)
        for k in g1:
            torch.testing.assert_close(g8[k], g1[k], atol=1e-5, rtol=1e-4)


def test_b2_b3_b4_on_the_conditional_flagship(cuda):
    """The flagship's conditional twin at full width: features 6, hidden 256,
    10 layers x 2 blocks, 8 bins, context 10."""
    flow = NeuralSplineFlow(6, 256, num_layers=10, num_bins=8, tail_bound=B,
                            context_features=10, generator=torch.Generator().manual_seed(7),
                            rng=np.random.default_rng(7), device=cuda).eval()
    _hold_context_kernels(flow, 512, 10, seed=8)


def test_conditional_serving_and_training_run_the_kernels(cuda):
    """One B2 a conditional request, equal to the unfused chain's; one B3 a
    fused step and one B2 and one B4 an autograd step, whose losses equal
    the eager step's; an embedding net outside nsf_train_apply gets the eager
    route's gradients."""
    import copy

    flow = _context_flow(cuda, "rq")
    x = torch.randn(256, 6, generator=torch.Generator().manual_seed(3)).to(cuda)
    c = torch.randn(256, 3, generator=torch.Generator().manual_seed(4)).to(cuda)
    served = CompiledFlow(flow, batch_size=256, features=6, context_features=3)
    assert served.is_fused
    b2 = nsf_flow_kernel.launch_count
    lp = served.log_prob(x, c)
    assert nsf_flow_kernel.launch_count == b2 + 1
    _close(lp, CompiledFlow(flow, batch_size=256, features=6, context_features=3,
                            use_fused=False).log_prob(x, c), 1e-3)
    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    fused = fused_trainer(copy.deepcopy(flow), 128)
    split = fused_trainer(copy.deepcopy(flow), 128)
    step_fused = fused.make_train_step(fused.init_opt(adam))
    split_opt = split.init_opt(adam)
    state = create_train_state(copy.deepcopy(flow).train(), adam)
    step_eager = make_train_step()
    counts = lambda: (nsf_flow_kernel.launch_count, nsf_train.loss_grad_launch_count,  # noqa: E731
                      nsf_train.bwd_launch_count)
    for i in range(3):
        batch, ctx = x[:128] + 0.1 * i, c[:128]
        c0 = counts()
        loss_fused = step_fused(batch, ctx)
        c1 = counts()
        split_opt.zero_grad(set_to_none=True)
        loss_split = split.loss_fn(split.weights, batch, ctx)
        loss_split.backward()
        split_opt.step()
        c2 = counts()
        state, metrics = step_eager(state, batch, ctx)
        assert tuple(b - a for a, b in zip(c0, c1)) == (0, 1, 0)
        assert tuple(b - a for a, b in zip(c1, c2)) == (1, 0, 1)
        _close(loss_fused, loss_split.detach(), 2e-4)
        _close(loss_fused, metrics["loss"], 2e-4)
    emb = torch.nn.Linear(2, 3).to(cuda)
    raw = torch.randn(128, 2, generator=torch.Generator().manual_seed(5)).to(cuda)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in split.weights.items()}
    y, lad = nsf_train.nsf_train_apply(w, x[:128], split._indices, split._static,
                                       split._wh_scale, context=emb(raw))
    loss = -(-0.5 * (y * y).sum(1) + lad).mean()
    g_kernel = torch.autograd.grad(loss, list(emb.parameters()))
    y, lad = nsf_flow_kernel.nsf_flow_kernel_plain(x[:128], w, split._indices, inverse=False,
                                                   wh_scale=split._wh_scale,
                                                   context=emb(raw), **split._static)
    g_plain = torch.autograd.grad(-(-0.5 * (y * y).sum(1) + lad).mean(),
                                  list(emb.parameters()))
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3)


# -- bf16 weights: B2, B9 and B11 at full width ------------------------------------

BF16_OUT, BF16_LAD = 5e-3, 2e-2  # benchmarks/hw_numerics.py:68-123


def _bf16_hold(kernel, plain16, plain32, band):
    """A bf16 kernel within ``band`` of its bf16 plain version, and at most a
    quarter as far from it as from the fp32 plain version in mean |delta|:
    it rounds where the plain version (and the JAX kernel) rounds."""
    assert torch.isfinite(kernel).all()
    err = (kernel - plain16).abs()
    assert err.max().item() <= band, err.max().item()
    assert err.mean().item() <= 0.25 * (kernel - plain32).abs().mean().item()


def _tame(flow, attr):
    """Scale each layer's final conditioner weights by 0.1 (chip_smoke.py's
    tame): as initialised a full-width RealNVP's or MAF's inverse sends
    samples to 1e17."""
    with torch.no_grad():
        for t in flow.transform.transforms:
            net = getattr(getattr(t, "transform", t), attr, None)
            if net is not None:
                net.final_layer.weight.mul_(0.1)
    return flow.eval()


def _bf16_coupling_flow(device, kind):
    from nflows_tpu_torch import SimpleRealNVP

    if kind == "affine":
        flow = SimpleRealNVP(6, 256, 10, 2, generator=torch.Generator().manual_seed(11),
                             device=device)
        return _tame(flow, "transform_net")
    # the flagship's widths (features 6, hidden 256, 10 layers, 8 bins)
    flow = NeuralSplineFlow(6, 256, num_layers=10, num_blocks_per_layer=2, num_bins=8,
                            tail_bound=B, context_features=10 if kind == "rq_context" else None,
                            generator=torch.Generator().manual_seed(6),
                            rng=np.random.default_rng(6), device=device)
    return flow.eval()


@pytest.mark.parametrize("kind", ["rq", "affine", "rq_context"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [203, 4096])
def test_b2_bf16_matches_its_plain_version(cuda, kind, inverse, n):
    flow = _bf16_coupling_flow(cuda, kind)
    f16, f32 = fuse_nsf(flow, dtype=torch.bfloat16), fuse_nsf(flow)
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 6, generator=g).to(cuda)
    ctx = torch.randn(n, 10, generator=g).to(cuda) if kind == "rq_context" else None
    kw = dict(inverse=inverse, context=ctx, **f16._static)
    before = (nsf_flow_kernel.launch_count, nsf_flow_kernel.bf16_launch_count)
    y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, f16._weights, f16._indices,
                                                  packed=f16._packed, **kw)
    assert (nsf_flow_kernel.launch_count, nsf_flow_kernel.bf16_launch_count) == (
        before[0], before[1] + 1)
    p16 = nsf_flow_kernel.nsf_flow_kernel_plain(x, f16._weights, f16._indices, **kw)
    p32 = nsf_flow_kernel.nsf_flow_kernel_plain(x, f32._weights, f32._indices, **kw)
    _bf16_hold(y, p16[0], p32[0], BF16_OUT)
    _bf16_hold(lad, p16[1], p32[1], BF16_LAD)


@pytest.mark.parametrize("kind", ["maf", "nsf_ar", "maf_context"])
@pytest.mark.parametrize("inverse", [False, True])
def test_b9_bf16_matches_its_plain_version(cuda, kind, inverse):
    from nflows_tpu_torch import MaskedAutoregressiveFlow, NeuralSplineFlowAR
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    gen = torch.Generator().manual_seed(12)
    if kind == "nsf_ar":
        flow = NeuralSplineFlowAR(10, 256, num_layers=5, num_blocks_per_layer=2, num_bins=8,
                                  tail_bound=B, generator=gen, device=cuda).eval()
    elif kind == "maf":
        flow = _tame(MaskedAutoregressiveFlow(10, 256, 5, 2, generator=gen, device=cuda),
                     "autoregressive_net")
    else:
        flow = _tame(NeuralSplineFlowAR(10, 256, num_layers=5, num_blocks_per_layer=2,
                                        num_bins=8, tail_bound=B, context_features=10,
                                        generator=gen, device=cuda), "autoregressive_net")
    f16, f32 = fuse_maf(flow, dtype=torch.bfloat16), fuse_maf(flow)
    g = torch.Generator().manual_seed(13)
    x = torch.randn(4096, 10, generator=g).to(cuda)
    ctx = torch.randn(4096, 10, generator=g).to(cuda) if kind == "maf_context" else None
    kw = dict(inverse=inverse, context=ctx, **_maf_kw(f16))
    before = maf_flow_kernel.bf16_launch_count
    y, lad = maf_flow_kernel.maf_flow_kernel_cuda(x, f16._weights, f16._static,
                                                  packed=f16._packed, **kw)
    assert maf_flow_kernel.bf16_launch_count == before + 1
    p16 = maf_flow_kernel.maf_flow_kernel_plain(x, f16._weights, f16._static, **kw)
    p32 = maf_flow_kernel.maf_flow_kernel_plain(x, f32._weights, f32._static, **kw)
    _bf16_hold(y, p16[0], p32[0], BF16_OUT)
    _bf16_hold(lad, p16[1], p32[1], BF16_LAD)


@pytest.mark.parametrize("case", ["narrow", "full_context"])
def test_b11_bf16_matches_its_plain_version(cuda, case):
    from nflows_tpu_torch.ops.cuda import mademog_fused

    model = _mog(cuda, case)
    f16 = mademog_fused.fuse_mademog(model, dtype=torch.bfloat16)
    f32 = mademog_fused.fuse_mademog(model)
    x, c = _mog_inputs(cuda, case, 4096, seed=14)
    before = mademog_fused.bf16_launch_count
    lp = mademog_fused.mademog_log_prob_cuda(x, f16._weights, f16._static, c,
                                             packed=f16._packed)
    assert mademog_fused.bf16_launch_count == before + 1
    _bf16_hold(lp, mademog_fused.mademog_log_prob_plain(x, f16._weights, f16._static, c),
               mademog_fused.mademog_log_prob_plain(x, f32._weights, f32._static, c), BF16_LAD)


def test_compiled_flow_in_bf16_launches_the_bf16_kernels(cuda):
    from nflows_tpu_torch import MaskedAutoregressiveFlow
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel, mademog_fused

    flow, mog = _flow(cuda), _mog(cuda, "narrow")
    maf = MaskedAutoregressiveFlow(5, 64, 3, 2, device=cuda).eval()
    for model, features, module in ((flow, 6, nsf_flow_kernel), (maf, 5, maf_flow_kernel),
                                    (mog, 5, mademog_fused)):
        served = CompiledFlow(model, batch_size=256, features=features, dtype=torch.bfloat16)
        assert served.is_fused
        x = torch.randn(256, features, generator=torch.Generator().manual_seed(15)).to(cuda)
        before = (module.launch_count, module.bf16_launch_count)
        lp = served.log_prob(x.to(torch.bfloat16))
        assert (module.launch_count, module.bf16_launch_count) == (before[0], before[1] + 1)
        assert lp.dtype == torch.float32
        _close(lp, CompiledFlow(model, batch_size=256, features=features).log_prob(x), 0.1)


def test_a_window_is_the_per_step_loop_and_recaptures_in_place(cuda):
    """A window of eager steps (``make_scan_train_step``, B1 ten a step):
    its warm-up steps are its first real steps, so it equals the per-step
    loop bit for bit for an optimizer whose initial state is not zero
    (NAdam's mu_product starts at 1), dropout drawing from the same
    generator; a new generator for each window replaces the graph rather
    than adding one."""
    import copy

    from nflows_tpu_torch import make_scan_train_step
    from nflows_tpu_torch.core import _window

    flow = NeuralSplineFlow(6, 32, num_layers=3, num_blocks_per_layer=2, num_bins=4,
                            tail_bound=3.0, dropout_probability=0.1, device=cuda,
                            generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0)).train()
    nadam = lambda p: torch.optim.NAdam(p, lr=1e-2, capturable=True)  # noqa: E731
    count = _window.WARMUP_STEPS + _window.GRAPH_STEPS
    rng = np.random.default_rng(30)
    batches = torch.from_numpy((1.5 * rng.standard_normal((2 * count, 128, 6)))
                               .astype(np.float32)).to(cuda)
    state = create_train_state(copy.deepcopy(flow), nadam)
    ref = create_train_state(copy.deepcopy(flow), nadam)
    steps, step = make_scan_train_step(), make_train_step()
    for seed, window in ((7, batches[:count]), (8, batches[count:count + _window.GRAPH_STEPS])):
        state, losses = steps(state, window,
                              generator=torch.Generator(device=cuda).manual_seed(seed))
        g = torch.Generator(device=cuda).manual_seed(seed)
        loop = torch.stack([step(ref, x, generator=g)[1]["loss"] for x in window])
        assert torch.isfinite(losses).all() and torch.equal(losses, loop), seed
        assert steps.window.captured == 1
    for a, b in zip(state.flow.parameters(), ref.flow.parameters()):
        assert torch.equal(a, b)


# -- B1 and B5-B8 on the paths of queue A5: the learned CDFs and the AR splines --------

from nflows_tpu_torch.transforms import ReversePermutation, nonlinearities  # noqa: E402
from nflows_tpu_torch.transforms import autoregressive as ar_transforms  # noqa: E402

# family -> (kernel module, the CDF class, the spline coupling class)
CDF_FAMILIES = {
    "rq": (rq_spline, nonlinearities.PiecewiseRationalQuadraticCDF,
           "PiecewiseRationalQuadraticCouplingTransform"),
    "lrs": (lrs_spline, nonlinearities.PiecewiseLinearRationalCDF,
            "PiecewiseLinearRationalCouplingTransform"),
    "linear": (linear_spline, nonlinearities.PiecewiseLinearCDF,
               "PiecewiseLinearCouplingTransform"),
    "quadratic": (quadratic_spline, nonlinearities.PiecewiseQuadraticCDF,
                  "PiecewiseQuadraticCouplingTransform"),
    "cubic": (cubic_spline, nonlinearities.PiecewiseCubicCDF,
              "PiecewiseCubicCouplingTransform"),
}
AR_FAMILIES = {"quadratic": (quadratic_spline,
                             ar_transforms.MaskedPiecewiseQuadraticAutoregressiveTransform),
               "lrs": (lrs_spline,
                       ar_transforms.MaskedPiecewiseLinearRationalAutoregressiveTransform)}


def _plain_flow(flow):
    """A float64 copy of ``flow`` on the CPU, where every spline runs its
    plain version."""
    import copy

    return copy.deepcopy(flow).cpu().double()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("family", sorted(CDF_FAMILIES))
def test_the_cdf_runs_its_family_kernel_and_matches_plain(cuda, family, inverse):
    """A learned CDF on a CUDA tensor: one launch of its family's kernel on
    the rows expanded over the batch, within 1e-4 / 1e-3 of the same CDF
    on the CPU (the plain version) and with the plain version's gradients
    on its parameter rows."""
    module, cls, _ = CDF_FAMILIES[family]
    cdf = cls([3], num_bins=8, tails="linear", tail_bound=B,
              generator=torch.Generator().manual_seed(0), device=cuda)
    x = torch.from_numpy(_spline_inputs(8, "cpu", seed=3)[0].numpy()).to(cuda)
    before = module.launch_count
    out, lad = (cdf.inverse if inverse else cdf.forward)(x)
    assert module.launch_count == before + 1
    (out.sum() * 1.3 + lad.sum() * 0.7).backward()
    ref = _plain_flow(cdf).float()
    p_out, p_lad = (ref.inverse if inverse else ref.forward)(x.cpu())
    (p_out.sum() * 1.3 + p_lad.sum() * 0.7).backward()
    _close(out.cpu(), p_out.detach(), 1e-4)
    _close(lad.cpu(), p_lad.detach(), 1e-3)
    for (name, a), b in zip(cdf.named_parameters(), ref.parameters()):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-3, rtol=1e-4, msg=name)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("family", sorted(AR_FAMILIES))
def test_the_ar_splines_run_b5_and_b7_and_match_plain(cuda, family, inverse):
    """The quadratic and linear-rational AR transforms with linear tails: one
    launch of B7 / B5 a forward, D a (sequential) inverse, within the bands
    of the same transform on the CPU."""
    module, cls = AR_FAMILIES[family]
    t = cls(features=5, hidden_features=32, num_bins=8, tails="linear", tail_bound=B,
            generator=torch.Generator().manual_seed(1), device=cuda).eval()
    x = (1.5 * torch.randn(300, 5, generator=torch.Generator().manual_seed(2))).to(cuda)
    before = module.launch_count
    with torch.no_grad():
        out, lad = (t.inverse if inverse else t.forward)(x)
    assert module.launch_count == before + (5 if inverse else 1)
    ref = _plain_flow(t).float()
    with torch.no_grad():
        p_out, p_lad = (ref.inverse if inverse else ref.forward)(x.cpu())
    _close(out.cpu(), p_out, 2e-4 if inverse else 1e-4)
    _close(lad.cpu(), p_lad, 1e-3)


@pytest.mark.parametrize("family", sorted(CDF_FAMILIES))
def test_a_cdf_coupling_flow_serves_unfused_with_twenty_launches(cuda, family):
    """(a) at a small width: 10 couplings with the CDF on their identity
    half; CompiledFlow serves it unfused, 20 launches of the family's kernel
    a log_prob and a sample request, and log_prob within 1e-3 of the plain
    versions' on the CPU."""
    from nflows_tpu_torch import transforms

    module, _, cls_name = CDF_FAMILIES[family]
    gen = torch.Generator().manual_seed(4)
    rng = np.random.default_rng(4)
    chain = []
    for i in range(10):
        chain += [RandomPermutation(6, rng=rng, device=cuda), getattr(transforms, cls_name)(
            create_alternating_binary_mask(6, even=bool(i % 2)),
            lambda n_in, n_out: nets.ResidualNet(n_in, n_out, 32, generator=gen, device=cuda),
            num_bins=8, tails="linear", tail_bound=B, apply_unconditional_transform=True,
            generator=gen, device=cuda)]
    flow = Flow(CompositeTransform(chain), StandardNormal([6])).to(cuda).eval()
    with pytest.raises(ValueError, match="unconditional"):
        CompiledFlow(flow, batch_size=256, features=6, use_fused=True)
    served = CompiledFlow(flow, batch_size=256, features=6)
    assert not served.is_fused
    x = torch.randn(256, 6, generator=gen).to(cuda)
    before = module.launch_count
    lp = served.log_prob(x)
    assert module.launch_count == before + 20
    served.sample(torch.Generator(device=cuda).manual_seed(5))
    assert module.launch_count == before + 40
    with torch.no_grad():
        _close(lp.cpu().double(), _plain_flow(flow).log_prob(x.cpu().double()), 1e-3)


@pytest.mark.parametrize("family", sorted(AR_FAMILIES))
def test_an_ar_spline_flow_serves_unfused_with_its_kernel(cuda, family):
    """(b) at a small width: 5 x [ReversePermutation, the AR transform];
    5 launches of B7 / B5 a log_prob request, 50 a sample request."""
    module, cls = AR_FAMILIES[family]
    gen = torch.Generator().manual_seed(6)
    chain = []
    for _ in range(5):
        chain += [ReversePermutation(10, device=cuda),
                  cls(features=10, hidden_features=32, num_bins=8, tails="linear",
                      tail_bound=B, generator=gen, device=cuda)]
    flow = Flow(CompositeTransform(chain), StandardNormal([10])).to(cuda).eval()
    served = CompiledFlow(flow, batch_size=256, features=10)
    assert not served.is_fused
    x = torch.randn(256, 10, generator=gen).to(cuda)
    before = module.launch_count
    lp = served.log_prob(x)
    assert module.launch_count == before + 5
    served.sample(torch.Generator(device=cuda).manual_seed(7))
    assert module.launch_count == before + 55
    with torch.no_grad():
        _close(lp.cpu().double(), _plain_flow(flow).log_prob(x.cpu().double()), 1e-3)



# -- queue A6: the linear and normalization transforms ------------------------------------

from nflows_tpu_torch import NeuralSplineFlowAR  # noqa: E402
from nflows_tpu_torch.transforms import LULinear, precompute_linear_caches  # noqa: E402


def _nsf_ar_lu(device, features=10, hidden=32, layers=5):
    """An NSF-AR with an LULinear after each permutation, its LU parameters
    moved off the identity by seeded draws (the LU layers start as the
    identity)."""
    flow = NeuralSplineFlowAR(features, hidden, num_layers=layers, num_bins=8, tail_bound=B,
                              use_linear_layers=True, generator=torch.Generator().manual_seed(8),
                              rng=np.random.default_rng(8), device=device)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for m in flow.modules():
            if isinstance(m, LULinear):
                for p in (m.lower_entries, m.upper_entries):
                    p.copy_(0.3 / features ** 0.5 * torch.randn(p.shape, generator=gen))
                m.unconstrained_upper_diag.add_(0.3 * torch.randn(features, generator=gen).to(device))
                m.bias.copy_(0.1 * torch.randn(features, generator=gen))
    return flow.eval()


@pytest.mark.parametrize("inverse", [False, True])
def test_b1_as_the_nsf_ar_lu_flow_calls_it(cuda, inverse):
    """B1 on the values the first AR transform of an NSF-AR with LU layers
    hands it (after the permutation and the LULinear): one launch, within
    1e-4 / 1e-3 of the plain version."""
    flow = _nsf_ar_lu(cuda)
    perm, lu, ar = flow.transform.transforms[:3]
    x = (1.5 * torch.randn(512, 10, generator=torch.Generator().manual_seed(10))).to(cuda)
    with torch.no_grad():
        z, _ = lu(perm(x)[0])
        p = ar.autoregressive_net(z).reshape(512, 10, -1)
        s = ar._hidden_scale()
        args = [t.contiguous() for t in (z, p[..., :8] * s, p[..., 8:16] * s, p[..., 16:])]
        before = rq_spline.launch_count
        out, lad = rq_spline.rq_spline_cuda(*args, inverse=inverse, tail_bound=B)
        assert rq_spline.launch_count == before + 1
        p_out, p_lad = rq.unconstrained_rational_quadratic_spline_plain(
            *args, inverse=inverse, tail_bound=B)
    _close(out, p_out, 1e-4)
    _close(lad, p_lad, 1e-3)


def test_lu_on_the_card_is_fp32_against_float64(cuda):
    """LULinear's forward (two products) and inverse (two triangular solves)
    on the card against float64 on the CPU, and its cached products: within
    1e-5 of 1 + |f64|, which a TF32 product (10 bits of significand, 1e-3)
    would miss. PyTorch's default keeps fp32 products on the card: nothing
    here turns TF32 off."""
    assert not torch.backends.cuda.matmul.allow_tf32
    lu = _nsf_ar_lu(cuda).transform.transforms[1]
    x = (2.0 * torch.randn(4096, 10, generator=torch.Generator().manual_seed(11))).to(cuda)
    ref = _plain_flow(lu)
    with torch.no_grad():
        d_out, d_lad = ref(x.cpu().double())
        d_inv, d_ilad = ref.inverse(x.cpu().double())
        for cached in (False, True):
            if cached:
                lu.precompute()
            out, lad = lu(x)
            inv, ilad = lu.inverse(x)
            for got, want in ((out, d_out), (lad, d_lad), (inv, d_inv), (ilad, d_ilad)):
                err = ((got.cpu().double() - want).abs() / (1 + want.abs())).max()
                assert err <= 1e-5, (cached, float(err))
    assert float(d_inv.abs().max()) > 1.0 and float((d_inv - x.cpu().double()).abs().max()) > 0.1


def test_an_nsf_ar_lu_request_launches_b1(cuda):
    """CompiledFlow serves the NSF-AR with LU layers unfused (no fused kernel
    takes an LULinear): 5 B1 a log_prob request, 50 a sample request, the
    same after precompute_linear_caches; log_prob within 1e-3 of float64 on
    the CPU, and the samples' log_prob consistent."""
    flow = _nsf_ar_lu(cuda)
    with pytest.raises(ValueError, match=r"expected \[permutation, affine-AR\] pairs"):
        CompiledFlow(flow, batch_size=256, features=10, use_fused=True)
    x = torch.randn(256, 10, generator=torch.Generator().manual_seed(12)).to(cuda)
    ref = _plain_flow(flow)
    for cached in (False, True):
        if cached:
            precompute_linear_caches(flow)
        served = CompiledFlow(flow, batch_size=256, features=10)
        assert not served.is_fused
        before = rq_spline.launch_count
        lp = served.log_prob(x)
        assert rq_spline.launch_count == before + 5
        s, s_lp = served.sample_and_log_prob(torch.Generator(device=cuda).manual_seed(13))
        assert rq_spline.launch_count == before + 55
        with torch.no_grad():
            _close(lp.cpu().double(), ref.log_prob(x.cpu().double()), 1e-3)
            _close(s_lp, flow.log_prob(s), 5e-3)
