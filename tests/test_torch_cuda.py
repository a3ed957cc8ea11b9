"""Kernels B1 and B2 on the card, each against its plain PyTorch version on
the same CUDA tensors, and the serving path through them.

The CUDA kernels have no CPU mode, so without a CUDA device every test
here skips. On a machine with a Hopper card and nvcc (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, as in chip_smoke.py: B1 1e-4 on outputs and 1e-3 on the
per-element logabsdet (a log of ratios of small bin quantities, which
loses more digits); B1 gradients 1e-4 absolute and relative; B2 1e-3 on
outputs and logabsdet (fp32 GEMMs summed in another order than cuBLAS).
"""

import numpy as np
import pytest
import torch

from nflows_tpu_torch import CompiledFlow, NeuralSplineFlow
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel, rq_spline
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
