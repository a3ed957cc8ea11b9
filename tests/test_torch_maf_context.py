"""Conditional autoregressive flows on the fused path, on the CPU: the
context stacks of ``maf_fused._extract``, the plain versions of kernel B9
(with a context) and B10 (with a context, and its inverse direction), the
conditional fused view and ``CompiledFlow``, and the conditional
``FusedMAFTrainer``, each against the JAX package on carried weights and the
same numpy inputs.

Tolerances, those of test_torch_maf_fused.py and test_torch_maf_train.py.
Extracted stacks are copies, transposes and permutations: exact. The plain
chain against the JAX kernel in interpret mode: forward 1e-5, the fixed
point (the inverse of a MAF or NSF-AR, the forward of an IAF) 1e-4 plus
1e-5 of the value. The hand-derived adjoint against autograd over the plain
chain in float64: 1e-10. Against ``jax.vjp`` of the JAX kernels' custom_vjp
in fp32: each gradient stack, gx and gctx 2e-4, each against a reference
whose largest entry is at least ten times that: the flows' MADE blocks have
their second linears redrawn at the first's scale (``lively``), since as
initialised the context projections' gradients sit near 1e-4. Three Adam steps: losses
2e-4; weights 5e-4 on 99% of each stack and three steps of lr (3e-2) on
all: Adam moves an entry by up to lr whatever the size of its gradient, so
an entry whose gradient is within rounding of zero may be stepped either
way. ``to_flow()``
1e-5. The fused view against the unfused
flow: 1e-4 (2e-4 on a sample's log_prob, which goes through the fixed point
and back).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.distributions import StandardNormal as JaxStandardNormal
from nflows_tpu.flows.base import Flow as JaxFlow
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.ops.pallas import maf_fused as jax_fused
from nflows_tpu.ops.pallas.maf_flow_kernel import maf_flow_kernel_call
from nflows_tpu.ops.pallas.maf_train import FusedMAFTrainer as JaxTrainer
from nflows_tpu.ops.pallas.maf_train import maf_train_vjp_call
from nflows_tpu.transforms import CompositeTransform as JaxComposite
from nflows_tpu.transforms import InverseTransform as JaxInverse
from nflows_tpu.transforms import MaskedAffineAutoregressiveTransform as JaxAffineAR
from nflows_tpu.transforms import RandomPermutation as JaxRandomPermutation
from nflows_tpu_torch import (
    CompiledFlow,
    Flow,
    NeuralSplineFlowAR,
    fused_trainer,
    load_jax_params,
    load_jax_trainer_weights,
)
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_fused, maf_train
from nflows_tpu_torch.transforms import (
    CompositeTransform,
    InverseTransform,
    MaskedAffineAutoregressiveTransform,
    RandomPermutation,
)

torch.set_num_threads(1)

D, C = 5, 3
KEYS = maf_train.WEIGHT_KEYS + maf_flow_kernel.CONTEXT_KEYS
KINDS = ("maf", "nsf_ar", "iaf")


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def lively(jflow, hidden):
    """Scale each MADE block's second linear from its U(-1e-3, 1e-3) start to
    the first linear's U(-1/sqrt(H), 1/sqrt(H)). As initialised, the
    gradients of the block's context projection (wcb, bcb) and first linear
    are near 1e-4, under the 2e-4 band, where a wrong or zero stack would
    pass; a trained model's are not."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * (1e3 / hidden ** 0.5)
        if "linear_1.weight" in jax.tree_util.keystr(path) else v, jflow)


def _pair(kind, seed=0, hidden=32, context=C):
    """(JAX flow, port flow) of one conditional model on the same weights:
    2 x [permutation, residual MADE (2 blocks) with a context of 3]; affine
    (maf), RQ with 4 bins (nsf_ar), or affine layers wrapped in
    InverseTransform (iaf); the blocks' second linears redrawn (``lively``)."""
    if kind == "nsf_ar":
        kw = dict(features=D, hidden_features=hidden, num_layers=2, num_blocks_per_layer=2,
                  num_bins=4, tail_bound=3.0, context_features=context)
        jflow = JaxNSFAR(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
        tflow = NeuralSplineFlowAR(device="cpu", rng=np.random.default_rng(seed + 100), **kw)
    else:
        rng, keys = np.random.default_rng(seed), jax.random.split(jax.random.key(seed), 2)
        trng = np.random.default_rng(seed + 100)
        jchain, tchain = [], []
        for i in range(2):
            jlayer = JaxAffineAR(features=D, hidden_features=hidden, context_features=context,
                                 num_blocks=2, key=keys[i])
            tlayer = MaskedAffineAutoregressiveTransform(
                D, hidden, context_features=context, num_blocks=2, device="cpu")
            if kind == "iaf":
                jlayer, tlayer = JaxInverse(jlayer), InverseTransform(tlayer)
            jchain += [JaxRandomPermutation(D, rng=rng), jlayer]
            tchain += [RandomPermutation(D, rng=trng, device="cpu"), tlayer]
        jflow = JaxFlow(transform=JaxComposite(jchain), distribution=JaxStandardNormal([D]))
        tflow = Flow(CompositeTransform(tchain), StandardNormal([D]))
    jflow = lively(jflow, hidden)
    load_jax_params(tflow, _jax_params(jflow))
    return jflow, tflow.eval()


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(a, b, atol, rtol=0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def held(got, want, atol, name):
    """``got`` within ``atol`` of ``want``, a reference whose largest entry
    is at least ten times the band: a band near the values it holds would
    pass a stack of zeros."""
    want = np.asarray(want)
    assert np.abs(want).max() >= 10 * atol, (name, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_extract_with_context_matches_jax_key_by_key(kind, fold):
    jflow, tflow = _pair(kind)
    kw = dict(fold_masks=fold, fold_wh_scale=fold, return_masks=not fold)
    j = jax_fused._extract(jflow, jnp.float32, **kw)
    t = maf_fused._extract(tflow, torch.float32, **kw)
    assert tuple(t[0]) == tuple(j[0])                    # permutations, wrapped
    assert t[2:7] == tuple(j[2:7]) and t[6] == C         # ..., context_features
    assert sorted(t[1]) == sorted(j[1]) == sorted(KEYS)
    for k in KEYS:
        assert t[1][k].shape == j[1][k].shape, k
        np.testing.assert_array_equal(t[1][k].numpy(), np.asarray(j[1][k]), err_msg=k)
    if not fold:
        for k in maf_train.MASKED_KEYS:
            np.testing.assert_array_equal(t[7][k].numpy(), np.asarray(j[7][k]), err_msg=k)


def test_pack_weights_lays_the_context_stacks_out_in_major():
    _, tflow = _pair("maf")
    static, w, nb, *_ = maf_fused._extract(tflow, torch.float32)
    H = 32
    packed = maf_flow_kernel.pack_weights(w, static, nb)
    assert packed["wci"].shape == (2, 4, H) and packed["wcb"].shape == (2, nb, 4, H)
    assert torch.equal(packed["wci"][1, :C], w["wci"][H:2 * H].T)
    assert not packed["wci"][:, C:].any() and not packed["wcb"][:, :, C:].any()
    assert torch.equal(packed["wcb"][1, 1, :C], w["wcb"][3 * H:4 * H].T)
    assert torch.equal(packed["bci"][1], w["bci"][H:2 * H, 0])
    assert torch.equal(packed["bcb"][1, 0], w["bcb"][2 * H:3 * H, 0])
    wci = packed["wci"]
    again = maf_flow_kernel.pack_weights({k: 2 * v for k, v in w.items()}, static, nb, out=packed)
    assert again["wci"] is wci and torch.equal(wci[0, :C], 2 * w["wci"][:H].T)   # in place
    assert maf_flow_kernel.shared_memory_bytes(32, 10, 256, 230, C=10) == (
        maf_flow_kernel.shared_memory_bytes(32, 10, 256, 230) + 4 * 32 * 12)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_chain_with_context_matches_jax_kernel(kind, inverse):
    jflow, tflow = _pair(kind, seed=1)
    static, w, nb, _, tr, skw, _ = jax_fused._extract(jflow, jnp.float32)
    tstatic, tw, *_ = maf_fused._extract(tflow, torch.float32)
    x, c = _normal(2, (128, D), 1.5), _normal(3, (128, C))
    jy, jlad = maf_flow_kernel_call(
        jnp.asarray(x.T), w["wi"], w["bi"], w["wb"], w["bb"], w["wf"], w["bf"], static,
        inverse=inverse, num_blocks=nb, transformer=tr, spline_kw=skw, lanes=128,
        interpret=True, ctx_t=jnp.asarray(c.T), wci=w["wci"], bci=w["bci"], wcb=w["wcb"],
        bcb=w["bcb"])
    before = maf_flow_kernel.launch_count
    with torch.no_grad():
        y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
            torch.from_numpy(x), tw, tstatic, inverse=inverse, num_blocks=nb, transformer=tr,
            spline_kw=skw, context=torch.from_numpy(c))
    assert maf_flow_kernel.launch_count == before       # the plain version launches nothing
    fixed_point = inverse != (kind == "iaf")
    tol = dict(atol=1e-4, rtol=1e-5) if fixed_point else dict(atol=1e-5)
    _close(y, np.asarray(jy).T, **tol)
    _close(lad, np.asarray(jlad)[0], **tol)


@pytest.mark.parametrize("kind", KINDS)
def test_conditional_fused_view_matches_the_unfused_flow(kind):
    _, tflow = _pair(kind, seed=4)
    fused = maf_fused.fuse_maf(tflow)
    assert fused.context_features == C
    x, z = torch.from_numpy(_normal(5, (60, D))), torch.from_numpy(_normal(6, (60, D)))
    c = torch.from_numpy(_normal(7, (60, C)))
    with torch.no_grad():
        _close(fused.log_prob(x, c), tflow.log_prob(x, c), 1e-4)
        xs, lad = tflow.transform.inverse(z, c)
        fs, flad = fused.inverse(z, c)
        _close(fs, xs, 1e-4)
        _close(flad, lad, 1e-4)
        few = c[:4]
        s, lp = fused.sample_and_log_prob(torch.Generator().manual_seed(0), 16, context=few)
        assert s.shape == (4, 16, D) and lp.shape == (4, 16)
        _close(lp.reshape(-1), tflow.log_prob(s.reshape(-1, D), few.repeat_interleave(16, 0)),
               2e-4)
        # the same generator gives the unfused flow the same noise
        us, ulp = tflow.sample_and_log_prob(torch.Generator().manual_seed(0), 16, context=few)
        _close(s, us, 1e-4)
        _close(lp, ulp, 2e-4)
    with pytest.raises(ValueError, match="context"):
        fused.log_prob(x)
    with pytest.raises(ValueError, match="rows"):
        fused.log_prob(x, c[:10])


def test_fused_view_runs_the_embedding_net_outside_the_kernel():
    _, tflow = _pair("maf", seed=12)
    embedded = Flow(tflow.transform, tflow.distribution,
                    embedding_net=torch.nn.Linear(4, C)).eval()
    fused = maf_fused.fuse_maf(embedded)
    x, raw = torch.from_numpy(_normal(13, (40, D))), torch.from_numpy(_normal(14, (40, 4)))
    with torch.no_grad():
        _close(fused.log_prob(x, raw), embedded.log_prob(x, raw), 1e-4)
    with pytest.raises(ValueError, match="embedding_net"):
        maf_train.FusedMAFTrainer(embedded, batch_size=128)


def test_compiled_flow_serves_conditional_maf_and_nsf_ar_fused():
    for kind in ("maf", "nsf_ar"):
        _, tflow = _pair(kind, seed=8)
        x, c = torch.from_numpy(_normal(9, (32, D))), torch.from_numpy(_normal(10, (32, C)))
        kw = dict(batch_size=32, features=D, context_features=C, device="cpu")
        served = CompiledFlow(tflow, **kw)
        unfused = CompiledFlow(tflow, use_fused=False, **kw)
        assert served.is_fused and isinstance(served._fused, maf_fused.FusedMAF)
        assert not unfused.is_fused
        _close(served.log_prob(x, c), unfused.log_prob(x, c), 1e-4)
        sampler = CompiledFlow(tflow, batch_size=4, features=D, context_features=C,
                               num_samples=8, device="cpu")
        assert sampler.is_fused
        s, lp = sampler.sample_and_log_prob(torch.Generator().manual_seed(1), c[:4])
        assert s.shape == (4, 8, D) and lp.shape == (4, 8)
        with torch.no_grad():
            _close(lp.reshape(-1),
                   tflow.log_prob(s.reshape(-1, D), c[:4].repeat_interleave(8, 0)), 2e-4)
        with pytest.raises(ValueError, match="context"):
            served.log_prob(x)


def test_mixed_context_blocks_and_a_missing_context_are_refused():
    _, tflow = _pair("maf")
    tflow.transform.transforms[3].autoregressive_net.blocks[1].context_layer = None
    with pytest.raises(ValueError, match="mixed context/context-free MADE blocks"):
        maf_fused.fuse_maf(tflow)
    _, tflow = _pair("maf")
    static, w, nb, *_ = maf_fused._extract(tflow, torch.float32)
    x = torch.zeros(8, D)
    with pytest.raises(ValueError, match="pass the context"):
        maf_flow_kernel.maf_flow_kernel_plain(x, w, static, inverse=False, num_blocks=nb)
    plain = {k: w[k] for k in maf_train.WEIGHT_KEYS}
    with pytest.raises(ValueError, match="without context projections"):
        maf_flow_kernel.maf_flow_kernel_plain(x, plain, static, inverse=False, num_blocks=nb,
                                              context=torch.zeros(8, C))


# -- B10 with a context ---------------------------------------------------------


def _trainer(kind, seed, hidden=32):
    _, tflow = _pair(kind, seed=seed, hidden=hidden)
    cls = maf_train.FusedIAFTrainer if kind == "iaf" else maf_train.FusedMAFTrainer
    return cls(tflow, batch_size=128)


def _direction(kind):
    return "inverse" if kind == "iaf" else "forward"


@pytest.mark.parametrize("kind", KINDS)
def test_bwd_plain_with_context_matches_autograd_in_float64(kind):
    tr = _trainer(kind, seed=11)
    w = {k: v.detach().double() for k, v in tr._fold(tr.weights).items()}
    rng = np.random.default_rng(12)
    n = 77
    x, c = (torch.from_numpy(rng.normal(size=(n, k)) * s) for k, s in ((D, 1.5), (C, 1.0)))
    gy, glad = torch.from_numpy(rng.normal(size=(n, D))), torch.from_numpy(rng.normal(size=n))
    kw = dict(wh_scale=tr._wh_scale, **tr._static)
    direction = _direction(kind)
    gx, grads = maf_train.maf_train_bwd_plain(x, gy, glad, w, tr._layers, context=c,
                                              direction=direction, **kw)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    xl, cl = x.clone().requires_grad_(True), c.clone().requires_grad_(True)
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(
        xl, leaves, tr._layers, inverse=direction == "inverse", context=cl, **kw)
    want = torch.autograd.grad((y, lad), [xl, cl] + [leaves[k] for k in KEYS], (gy, glad))
    _close(gx, want[0], 1e-10)
    _close(grads["ctx"], want[1], 1e-10)
    for k, g in zip(KEYS, want[2:]):
        assert grads[k].shape == w[k].shape and grads[k].dtype == torch.float64
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-10, rtol=0, err_msg=k)
    assert grads["wcb"].abs().max() > 0 and grads["ctx"].abs().max() > 0


@pytest.mark.parametrize("kind", KINDS)
def test_bwd_plain_with_context_matches_jax_vjp(kind):
    """The JAX kernels' custom_vjp (its backward is the Pallas kernel B10
    in interpret mode, differentiating each layer with jax.vjp) against the
    port's hand-derived adjoint, on the same folded weights and cotangents."""
    jflow, _ = _pair(kind, seed=13)
    tr = _trainer(kind, seed=13)
    direction = _direction(kind)
    jtr_static = jax_fused._extract(jflow, jnp.float32, allow_wrapped=kind == "iaf")
    apply = maf_train_vjp_call(jtr_static[0], jtr_static[4], jtr_static[2], jtr_static[5],
                               32, 128, True, has_context=True, direction=direction)
    folded = {k: v.detach() for k, v in tr._fold(tr.weights).items()}
    jw = {k: jnp.asarray(v.numpy()) for k, v in folded.items()}
    x, c = _normal(14, (128, D), 1.5), _normal(15, (128, C))
    gy, glad = _normal(16, (128, D)) / 128, _normal(17, (128,)) / 128
    (jy, jlad), vjp = jax.vjp(apply, jw, jnp.asarray(x.T), jnp.asarray(c.T))
    j_gw, j_gx, j_gctx = vjp((jnp.asarray(gy.T), jnp.asarray(glad[None])))
    kw = dict(wh_scale=tr._wh_scale, **tr._static)
    with torch.no_grad():
        y, lad = maf_flow_kernel.maf_flow_kernel_plain(
            torch.from_numpy(x), folded, tr._layers, inverse=direction == "inverse",
            context=torch.from_numpy(c), **kw)
    _close(y, np.asarray(jy).T, 1e-5)
    _close(lad, np.asarray(jlad)[0], 1e-5)
    gx, grads = maf_train.maf_train_bwd_cuda(
        torch.from_numpy(x), torch.from_numpy(gy), torch.from_numpy(glad), folded, tr._layers,
        context=torch.from_numpy(c), direction=direction, **kw)
    held(gx, np.asarray(j_gx).T, 2e-4, "gx")
    held(grads["ctx"], np.asarray(j_gctx).T, 2e-4, "ctx")
    for k in KEYS:
        held(grads[k].numpy(), j_gw[k], 2e-4, k)


# -- the conditional trainer -----------------------------------------------------


@pytest.mark.parametrize("kind", ["maf", "nsf_ar"])
def test_conditional_trainer_loss_and_gradients_match_jax(kind):
    jflow, tflow = _pair(kind, seed=20)
    jtr = JaxTrainer(jflow, batch_size=128, interpret=True)
    ttr = fused_trainer(tflow, 128)
    assert isinstance(ttr, maf_train.FusedMAFTrainer) and ttr.context_features == C
    assert sorted(ttr.weights) == sorted(jtr.weights) == sorted(KEYS)
    x, c = _normal(21, (128, D), 1.5), _normal(22, (128, C))
    j_loss, (j_gw, j_gctx) = jax.value_and_grad(jtr.loss_fn, argnums=(0, 2))(
        jtr.weights, jnp.asarray(x.T), jnp.asarray(c.T))
    xt, ct = torch.from_numpy(x), torch.from_numpy(c).requires_grad_(True)
    loss = ttr.loss_fn(ttr.weights, xt, ct)
    grads = torch.autograd.grad(loss, [ttr.weights[k] for k in KEYS] + [ct])
    _close(loss.detach(), j_loss, 1e-4)
    with torch.no_grad():
        _close(loss.detach(), -tflow.log_prob(xt, ct).mean(), 1e-5)
    for k, g in zip(KEYS, grads):
        held(g.numpy(), j_gw[k], 2e-4, k)
    held(grads[-1], np.asarray(j_gctx).T, 2e-4, "ctx")


@pytest.mark.parametrize("kind", ["maf", "nsf_ar"])
def test_three_conditional_adam_steps_match_the_jax_trainer(kind):
    jflow, tflow = _pair(kind, seed=23)
    jtr = JaxTrainer(jflow, batch_size=128, interpret=True)
    opt = optax.adam(1e-2)
    jstep = jtr.make_train_step(opt, donate=False)
    weights, opt_state = jtr.weights, jtr.init_opt(opt)
    ttr = fused_trainer(tflow, 128)
    load_jax_trainer_weights(ttr, {k: np.asarray(v) for k, v in jtr.weights.items()})
    start = {k: v.detach().clone() for k, v in ttr.weights.items()}
    tstep = ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)))
    j_losses, t_losses = [], []
    for i in range(3):
        x, c = _normal(30 + i, (128, D), 1.5), _normal(40 + i, (128, C))
        weights, opt_state, loss = jstep(weights, opt_state, jnp.asarray(x), jnp.asarray(c))
        j_losses.append(float(loss))
        t_losses.append(float(tstep(torch.from_numpy(x), torch.from_numpy(c))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    for k in KEYS:
        # Adam moves an entry by up to lr whatever its gradient's size: where
        # a gradient is within rounding of zero the two runs may step it
        # apart. 99% of a stack within 5e-4, all within three steps of lr.
        gap = np.abs(ttr.weights[k].detach().numpy() - np.asarray(weights[k]))
        assert np.quantile(gap, 0.99) <= 5e-4 and gap.max() <= 3e-2, (k, gap.max())
        assert not torch.equal(ttr.weights[k].detach(), start[k]), k
    for k in maf_train.MASKED_KEYS:
        dead = ttr._masks[k] == 0
        assert torch.equal(ttr.weights[k].detach()[dead], start[k][dead])   # bit-equal
    # to_flow writes the context projections back
    x, c = torch.from_numpy(_normal(50, (64, D))), torch.from_numpy(_normal(51, (64, C)))
    with torch.no_grad():
        trained = ttr.to_flow()
        # the JAX trainer's to_flow of the same weights: the same model
        same = {k: jnp.asarray(v.detach().numpy()) for k, v in ttr.weights.items()}
        _close(trained.log_prob(x, c),
               jtr.to_flow(same).log_prob(jnp.asarray(x.numpy()), jnp.asarray(c.numpy())),
               1e-4)
        y, lad = ttr._apply(ttr.weights, x, c)
        lp = -0.5 * (y * y).sum(dim=1) - 0.5 * D * np.log(2 * np.pi) + lad
        _close(trained.log_prob(x, c), lp, 1e-5)
        assert (trained.log_prob(x, c) - tflow.log_prob(x, c)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="conditional"):
        tstep(x[:0].new_zeros(128, D))
    with pytest.raises(ValueError, match="context of shape"):
        tstep(torch.zeros(128, D), torch.zeros(128, C + 1))


def test_conditional_to_flow_round_trip_is_a_pure_relaying():
    _, tflow = _pair("nsf_ar", seed=24)
    ttr = maf_train.FusedMAFTrainer(tflow, 128)
    rebuilt = ttr.to_flow()
    for (name, a), b in zip(rebuilt.state_dict().items(), tflow.state_dict().values()):
        assert torch.equal(a, b), name


def test_maf_train_apply_passes_the_context_gradient_to_an_embedding_net():
    """The fused trainer refuses an embedding net, but maf_train_apply
    composes with one: gctx flows back into it (JAX maf_train.py:27-29)."""
    _, tflow = _pair("maf", seed=25)
    ttr = maf_train.FusedMAFTrainer(tflow, 128)
    embed = torch.nn.Linear(4, C)
    raw = torch.from_numpy(_normal(26, (128, 4)))
    x = torch.from_numpy(_normal(27, (128, D)))
    folded = ttr._fold(ttr.weights)

    def loss_of(apply):
        y, lad = apply(embed(raw))
        return (0.5 * (y * y).sum(dim=1) - lad).mean()

    fused = loss_of(lambda ctx: maf_train.maf_train_apply(
        folded, x, ttr._layers, ttr._static, ttr._wh_scale, context=ctx))
    g_fused = torch.autograd.grad(fused, list(embed.parameters()))
    plain = loss_of(lambda ctx: maf_flow_kernel.maf_flow_kernel_plain(
        x, folded, ttr._layers, inverse=False, context=ctx, **ttr._static))
    g_plain = torch.autograd.grad(plain, list(embed.parameters()))
    for a, b in zip(g_fused, g_plain):
        assert b.abs().max() > 0
        _close(a, b, 1e-5)
