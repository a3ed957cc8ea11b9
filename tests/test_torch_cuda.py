"""Kernels B1 to B4 and B9 to B12 on the card, each against its plain PyTorch version
on the same CUDA tensors, and the serving and training paths through them.

The CUDA kernels have no CPU mode, so without a CUDA device every test
here skips. On a machine with a Hopper card and nvcc (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, as in chip_smoke.py: B1 1e-4 on outputs and 1e-3 on the
per-element logabsdet (a log of ratios of small bin quantities, which
loses more digits); B1 gradients 1e-4 absolute and relative; B2 1e-3 on
outputs and logabsdet (fp32 GEMMs summed in another order than cuBLAS).
B3 and B4: log_prob 1e-3 as B2; gradients 2e-4 of the plain version's plus
1e-3 of its size (the bar the JAX package holds its training kernels to,
with a relative part because a weight gradient is a sum over the batch taken
by atomics in another order than autograd's); two launches on the same
inputs agree within 1e-5 plus 1e-4 relative (only the order of the atomic
adds differs).
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


# -- training kernels B3 and B4 -----------------------------------------------


def _trainer(device, features=6, batch=128, **overrides):
    return nsf_train.FusedNSFTrainer(_flow(device, features, **overrides), batch)


def _train_args(tr):
    return (tr.weights, tr._indices), dict(wh_scale=tr._wh_scale, **tr._static)


def _grads_close(got, ref, atol=2e-4, rtol=1e-3):
    for k in nsf_train.WEIGHT_KEYS:
        torch.testing.assert_close(got[k], ref[k], atol=atol, rtol=rtol, msg=lambda m: f"{k}: {m}")


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
    _, lp32, g32 = nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=32, **kw)
    _, lp64, g64 = nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=64, **kw)
    _close(lp32, lp64, 1e-5)
    _grads_close(g64, g32, atol=1e-5, rtol=1e-4)
    # a second launch into the same buffers starts from zero again
    first = {k: v.clone() for k, v in g32.items()}
    _, _, again = nsf_train.nsf_loss_grad_cuda(x, w, idx, rows=32, grads=g32, **kw)
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


@pytest.mark.parametrize("kind", ["affine", "rq", "iaf"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [203, 16384])
def test_b9_matches_plain(cuda, kind, inverse, n):
    """203 leaves a ragged last tile of 32-sample tiles; 16,384 fills the
    card with 64-sample tiles. 5 features are padded to 8 input rows; the
    IAF chain is wrapped, so its forward runs the fixed point."""
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    fused = fuse_maf(_ar_flow(cuda, kind))
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(n)).to(cuda)
    kw = dict(inverse=inverse, **_maf_kw(fused))
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


def test_b9_tile_sizes_agree_and_a_relaunch_is_independent(cuda):
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    fused = fuse_maf(_ar_flow(cuda, "affine"))
    x = torch.randn(1000, 5, generator=torch.Generator().manual_seed(1)).to(cuda)
    run = lambda rows: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
        x, fused._weights, fused._static, packed=fused._packed, inverse=True, rows=rows,
        **_maf_kw(fused))
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
