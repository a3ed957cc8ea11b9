"""Conditional coupling flows on the fused paths, on the CPU, against the JAX
package: ``ConditionalDiagonalNormal`` and ``DiagonalNormal``; ``_extract``
with the context stacks; B2's plain version with a context against the JAX
whole-chain kernel in interpret mode and the JAX XLA chain, both directions,
for all seven coupling families; the plain B3 and B4 with a context against
``jax.grad`` of the JAX chain (the context stacks' gradients and, for B4, the
context's cotangent); three conditional Adam steps of ``FusedNSFTrainer``
against the JAX fused trainer in interpret mode; the conditional fused view
(log_prob against the unfused flow, sampling layout against the JAX view's
``_sample_conditional`` fed the same noise, the embedding net run once
outside the kernel, the context refusals); ``CompiledFlow``,
``fused_trainer`` and the gradient into an embedding net through
``nsf_train_apply``; and the shared-memory counts of the launchers against
the CUDA sources' ``smem_bytes``. On a CPU tensor every wrapper runs its
plain version; the kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances. Extracted arrays are copies and transposes: exact. Outputs,
logabsdet and log_prob: 1e-4 absolute (the fp32 interop bar, MIGRATION.md),
the cubic family's logabsdet 5e-4 (the JAX package's bar for its cubic
kernel, tests/ops/test_pallas_cubic.py), 2e-6 relative on the inverse as
tests/test_torch_realnvp.py has it. Loss 1e-4, each gradient stack and the
context's cotangent 2e-4; three Adam steps 2e-4 on the losses and 5e-4 on
the weights (tests/ops/test_nsf_train.py). ``to_flow()`` round trip 1e-5.
The same computation in two orders on the CPU (the fused view against the
unfused flow, an embedding net's gradients by two routes): 1e-5. The bases:
1e-5, plus 1e-6 relative where log-densities reach 1e3.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.distributions import ConditionalDiagonalNormal as JaxCDN
from nflows_tpu.distributions import DiagonalNormal as JaxDiagonalNormal
from nflows_tpu.distributions import StandardNormal as JaxStandardNormal
from nflows_tpu.flows.base import Flow as JaxFlow
from nflows_tpu.nn import nets as jax_nets
from nflows_tpu.nn.primitives import Dense as JaxDense
from nflows_tpu.ops.pallas import nsf_fused as jax_fused
from nflows_tpu.ops.pallas.nsf_flow_kernel import nsf_flow_kernel_call
from nflows_tpu.ops.pallas.nsf_train import FusedNSFTrainer as JaxTrainer
from nflows_tpu.ops.pallas.nsf_train import _family_spline_config, _make_layer_fn
from nflows_tpu.transforms import coupling as jax_coupling
from nflows_tpu.transforms.base import CompositeTransform as JaxComposite
from nflows_tpu.transforms.permutations import Permutation as JaxPermutation
from nflows_tpu_torch import (
    CompiledFlow,
    ConditionalDiagonalNormal,
    DiagonalNormal,
    Flow,
    NeuralSplineFlow,
    fused_trainer,
    load_jax_params,
    load_jax_trainer_weights,
)
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.nn.primitives import Dense
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel, nsf_fused, nsf_train
from nflows_tpu_torch.transforms import (
    AdditiveCouplingTransform,
    AffineCouplingTransform,
    CompositeTransform,
    Permutation,
    PiecewiseCubicCouplingTransform,
    PiecewiseLinearCouplingTransform,
    PiecewiseLinearRationalCouplingTransform,
    PiecewiseQuadraticCouplingTransform,
    PiecewiseRationalQuadraticCouplingTransform,
)

torch.set_num_threads(1)

D, C, HIDDEN, N = 6, 3, 16, 64
ATOL = 1e-4
KEYS = nsf_train.WEIGHT_KEYS + nsf_train.CONTEXT_KEYS
COUPLINGS = {
    "rq": (jax_coupling.PiecewiseRationalQuadraticCouplingTransform,
           PiecewiseRationalQuadraticCouplingTransform),
    "lrs": (jax_coupling.PiecewiseLinearRationalCouplingTransform,
            PiecewiseLinearRationalCouplingTransform),
    "linear": (jax_coupling.PiecewiseLinearCouplingTransform, PiecewiseLinearCouplingTransform),
    "quadratic": (jax_coupling.PiecewiseQuadraticCouplingTransform,
                  PiecewiseQuadraticCouplingTransform),
    "cubic": (jax_coupling.PiecewiseCubicCouplingTransform, PiecewiseCubicCouplingTransform),
    "affine": (jax_coupling.AffineCouplingTransform, AffineCouplingTransform),
    "additive": (jax_coupling.AdditiveCouplingTransform, AdditiveCouplingTransform),
}
FAMILIES = sorted(COUPLINGS)


def _load(jax_module, module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax_module)
    load_jax_params(module, {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    return module


def _mask():
    mask = np.ones(D, dtype=np.float32)
    mask[::2] = -1
    return mask


def _pair(family, layers=2, seed=0, hidden=HIDDEN, embedding=False):
    """``layers`` x [permutation, conditional coupling of ``family``] in both
    packages with the same weights; with ``embedding``, a Dense(2, C) embedding
    net in front of the context."""
    jcls, tcls = COUPLINGS[family]
    kw = {} if family in ("affine", "additive") else dict(num_bins=4, tails="linear",
                                                         tail_bound=3.0)
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed), layers + 1)
    mask = _mask()
    jchain, tchain = [], []
    for i in range(layers):
        perm = rng.permutation(D)
        jchain.append(JaxPermutation(perm))
        tchain.append(Permutation(perm, device="cpu"))
        jchain.append(jcls(mask=mask, transform_net_create_fn=lambda i_, o_, k=keys[i]:
                           jax_nets.ResidualNet(i_, o_, hidden_features=hidden, num_blocks=2,
                                                context_features=C, key=k), **kw))
        tchain.append(tcls(mask=mask, transform_net_create_fn=lambda i_, o_: nets.ResidualNet(
            i_, o_, hidden_features=hidden, num_blocks=2, context_features=C, device="cpu"),
            device="cpu", **kw))
        mask = -mask
    jemb = JaxDense(2, C, key=keys[-1]) if embedding else None
    temb = Dense(2, C, device="cpu") if embedding else None
    jflow = JaxFlow(transform=JaxComposite(jchain), distribution=JaxStandardNormal([D]),
                    embedding_net=jemb)
    # each block's second linear starts at U(-1e-3, 1e-3), which leaves the
    # context gate's gradients near 1e-5, under the 2e-4 band: scale it to
    # the first linear's U(-1/sqrt(H), 1/sqrt(H))
    jflow = jax.tree_util.tree_map_with_path(
        lambda path, v: v * (1e3 / hidden ** 0.5)
        if "linear_1" in jax.tree_util.keystr(path) and "weight" in jax.tree_util.keystr(path)
        else v, jflow)
    tflow = Flow(CompositeTransform(tchain), StandardNormal([D]), embedding_net=temb)
    return jflow, _load(jflow, tflow).eval()


def _x(n=N, seed=1, scale=1.5, width=D):
    return (scale * np.random.default_rng(seed).standard_normal((n, width))).astype(np.float32)


def _close(a, b, atol=ATOL, rtol=0.0):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def chains():
    return {family: _pair(family) for family in FAMILIES}


# -- the two Normal bases ---------------------------------------------------------


def test_conditional_diagonal_normal_matches_jax():
    jdist = JaxCDN([D], context_encoder=JaxDense(4, 2 * D, key=jax.random.key(0)))
    tdist = _load(jdist, ConditionalDiagonalNormal([D], context_encoder=Dense(4, 2 * D)))
    x, c = _x(seed=2), _x(seed=3, width=4)
    with torch.no_grad():
        # log-densities reach -1.8e3 here: 1e-5 plus fp32 rounding, 1e-6 relative
        _close(tdist.log_prob(torch.from_numpy(x), torch.from_numpy(c)), jdist.log_prob(x, c),
               1e-5, 1e-6)
        # sampling through the same noise: the port's draw, put through the JAX
        # distribution's means and stds in the reference's layout
        g = torch.Generator().manual_seed(4)
        s = tdist.sample(g, 5, torch.from_numpy(c[:7]))
        noise = torch.randn((35, D), generator=torch.Generator().manual_seed(4)).numpy()
    means, log_stds = jdist._compute_params(jnp.asarray(c[:7]))
    expected = (np.repeat(np.asarray(means), 5, axis=0)
                + np.repeat(np.exp(np.asarray(log_stds)), 5, axis=0) * noise)
    assert s.shape == (7, 5, D)
    _close(s, expected.reshape(7, 5, D), 1e-5)
    # by moments: 20,000 samples of one context row
    with torch.no_grad():
        big = tdist.sample(torch.Generator().manual_seed(5), 20000, torch.from_numpy(c[:1]))[0]
    _close(big.mean(0), np.asarray(means)[0], 0.05 * float(np.exp(np.asarray(log_stds)).max()))
    _close(big.std(0), np.exp(np.asarray(log_stds))[0], 0.03 * float(np.exp(log_stds).max()))
    samples, lp = tdist.sample_and_log_prob(torch.Generator().manual_seed(6), 4,
                                            torch.from_numpy(c[:3]))
    assert samples.shape == (3, 4, D) and lp.shape == (3, 4)
    with pytest.raises(ValueError, match="Context can't be None"):
        tdist.log_prob(torch.from_numpy(x))


def test_diagonal_normal_matches_jax():
    jdist = JaxDiagonalNormal([D])
    rng = np.random.default_rng(7)
    jdist = jdist.replace(mean_=jnp.asarray(rng.normal(size=(1, D)), jnp.float32),
                          log_std_=jnp.asarray(0.3 * rng.normal(size=(1, D)), jnp.float32))
    tdist = _load(jdist, DiagonalNormal([D]))
    assert sorted(name for name, _ in tdist.named_parameters()) == ["log_std_", "mean_"]
    x = _x(seed=8)
    with torch.no_grad():
        _close(tdist.log_prob(torch.from_numpy(x)), jdist.log_prob(x), 1e-5)
    with pytest.raises(NotImplementedError):
        tdist.sample(None, 3)
    with pytest.raises(NotImplementedError):
        jdist.sample(jax.random.key(0), 3)


def test_diagonal_bases_serve_and_train_unfused():
    """A flow over either base is not fused (B2 needs a StandardNormal
    base) and serves and trains on the unfused chain."""
    from nflows_tpu_torch import create_train_state, make_train_step

    _, tflow = _pair("rq", seed=9)
    base = ConditionalDiagonalNormal([D], context_encoder=Dense(C, 2 * D))
    flow = Flow(tflow.transform, base)
    with pytest.raises(ValueError, match="StandardNormal"):
        nsf_fused.fuse_nsf(flow)
    served = CompiledFlow(flow, batch_size=N, features=D, context_features=C, device="cpu")
    assert not served.is_fused
    x, c = torch.from_numpy(_x(seed=10)), torch.from_numpy(_x(seed=11, width=C))
    with torch.no_grad():
        _close(served.log_prob(x, c), flow.log_prob(x, c), 0.0)
    assert fused_trainer(flow, 128, required=False) is None
    state = create_train_state(Flow(tflow.transform, DiagonalNormal([D])),
                               lambda p: torch.optim.Adam(p, lr=1e-2))
    batch = torch.from_numpy(_x(n=128, seed=12))
    state, metrics = make_train_step()(state, batch, torch.from_numpy(_x(128, 13, width=C)))
    assert np.isfinite(float(metrics["loss"]))
    assert state.flow.distribution.mean_.abs().sum() > 0


# -- extraction and B2 with a context -----------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_extract_with_context_matches_jax(chains, family):
    jflow, tflow = chains[family]
    for fold in (True, False):
        j_idx, j_w, j_static, j_feat, j_ctx = jax_fused._extract(jflow, jnp.float32,
                                                                 fold_wh_scale=fold)
        t_idx, t_w, t_static, t_feat, t_ctx = nsf_fused._extract(tflow, torch.float32,
                                                                 fold_wh_scale=fold)
        assert (t_ctx, t_feat, t_static) == (j_ctx, j_feat, j_static) and t_ctx == C
        assert [tuple(i) for i in t_idx] == [tuple(i) for i in j_idx]
        assert sorted(t_w) == sorted(j_w) == sorted(KEYS)
        for name in j_w:
            np.testing.assert_array_equal(t_w[name].numpy(), np.asarray(j_w[name]),
                                          err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_b2_with_context_matches_jax(chains, family):
    """B2's plain version against the JAX kernel in interpret mode (forward)
    and the XLA chain (both directions)."""
    jflow, tflow = chains[family]
    j_idx, j_w, j_static, _, _ = jax_fused._extract(jflow, jnp.float32)
    t_idx, t_w, t_static, _, _ = nsf_fused._extract(tflow, torch.float32)
    x, c = _x(seed=14, scale=2.0), _x(seed=15, width=C)
    lad_atol = 5e-4 if family == "cubic" else ATOL
    y_t, lad = nsf_flow_kernel_call(
        jnp.asarray(x.T), j_w["w0"], j_w["b0"], j_w["wb"], j_w["bb"], j_w["wf"], j_w["bf"],
        j_idx, inverse=False, lanes=64, interpret=True, ctx_t=jnp.asarray(c.T),
        wc0=j_w["wc0"], wcb=j_w["wcb"], bcb=j_w["bcb"], **j_static)
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    y, lad_t = nsf_flow_kernel.nsf_flow_kernel_plain(tx, t_w, t_idx, inverse=False,
                                                     context=tc, **t_static)
    _close(y, np.asarray(y_t).T)
    _close(lad_t, np.asarray(lad)[0], lad_atol)
    for inverse in (False, True):
        y, lad_t = nsf_flow_kernel.nsf_flow_kernel_plain(tx, t_w, t_idx, inverse=inverse,
                                                         context=tc, **t_static)
        j_y, j_lad = (jflow.transform.inverse if inverse else jflow.transform.forward)(x, c)
        _close(y, j_y, ATOL, 2e-6)
        _close(lad_t, j_lad, lad_atol, 2e-6)
    with pytest.raises(ValueError, match="context"):
        nsf_flow_kernel.nsf_flow_kernel_plain(tx, t_w, t_idx, inverse=False, **t_static)
    with pytest.raises(ValueError, match="context must be"):
        nsf_flow_kernel.nsf_flow_kernel_plain(tx, t_w, t_idx, inverse=False, context=tc[:, :2],
                                              **t_static)


# -- B3 and B4 with a context ------------------------------------------------------


def _jax_chain_loss(static, layer_indices, wh_scale):
    """The JAX package's training loss on kernel-layout weights with a
    context, in XLA: its traced layer functions (nsf_train.py
    ``_make_layer_fn``, the math its training kernels differentiate)."""
    spline_kw, _, name, _ = _family_spline_config(static)
    nb = static["num_blocks"]
    fns = [_make_layer_fn(li, name, static.get("num_bins", 0), nb, wh_scale, spline_kw,
                          has_ctx=True) for li in layer_indices]

    def loss(w, x_t, ctx_t):
        lad = 0.0
        for l, fn in enumerate(fns):
            ws = ([w["w0"][l], w["b0"][l]] + [w["wb"][l, j] for j in range(2 * nb)]
                  + [w["bb"][l, j] for j in range(2 * nb)] + [w["wf"][l], w["bf"][l]]
                  + [w["wc0"][l]] + [w["wcb"][l, j] for j in range(nb)]
                  + [w["bcb"][l, j] for j in range(nb)])
            x_t, layer_lad = fn(x_t, ctx_t, *ws)
            lad = lad + layer_lad[0]
        lp = -0.5 * jnp.sum(x_t * x_t, axis=0) - 0.5 * D * np.log(2 * np.pi) + lad
        return -jnp.mean(lp)
    return loss


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_b3_b4_with_context_match_jax_grad(chains, family):
    jflow, tflow = chains[family]
    j_idx, j_w, j_static, _, _ = jax_fused._extract(jflow, jnp.float32, fold_wh_scale=False)
    ttr = nsf_train.FusedNSFTrainer(tflow, batch_size=128)
    assert sorted(ttr.weights) == sorted(KEYS)
    x, c = _x(n=128, seed=16), _x(n=128, seed=17, width=C)
    j_loss, (j_gw, j_gx_t, j_gc_t) = jax.jit(jax.value_and_grad(
        _jax_chain_loss(j_static, j_idx, ttr._wh_scale), argnums=(0, 1, 2)))(
            j_w, jnp.asarray(x.T), jnp.asarray(c.T))
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    kw = dict(wh_scale=ttr._wh_scale, **ttr._static)
    loss, lp, grads = nsf_train.nsf_loss_grad_cuda(xt, ttr.weights, ttr._indices, context=ct,
                                                   **kw)
    _close(loss, j_loss, 1e-4)
    _close(lp, jflow.log_prob(x, c), 5e-4 if family == "cubic" else ATOL)
    assert sorted(grads) == sorted(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_gw[k]), atol=2e-4, rtol=0,
                                   err_msg=k)
    n = x.shape[0]
    with torch.no_grad():
        y, _ = nsf_train.nsf_train_apply(ttr.weights, xt, ttr._indices, ttr._static,
                                         ttr._wh_scale, context=ct)
    gx, grads = nsf_train.nsf_train_bwd_cuda(xt, y / n, torch.full((n,), -1.0 / n),
                                             ttr.weights, ttr._indices, context=ct, **kw)
    assert sorted(grads) == sorted(KEYS + ("ctx",))
    _close(gx, np.asarray(j_gx_t).T, 2e-4)
    _close(grads["ctx"], np.asarray(j_gc_t).T, 2e-4)
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_gw[k]), atol=2e-4, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["rq", "affine"])
def test_three_conditional_adam_steps_match_the_jax_trainer(family):
    jflow, tflow = _pair(family, seed=18)
    jtr = JaxTrainer(jflow, batch_size=128, interpret=True)
    opt = optax.adam(1e-2)
    jstep = jtr.make_train_step(opt, donate=False)
    weights, opt_state = jtr.weights, jtr.init_opt(opt)
    ttr = fused_trainer(tflow, 128)
    assert isinstance(ttr, nsf_train.FusedNSFTrainer) and ttr.context_features == C
    load_jax_trainer_weights(ttr, {k: np.asarray(v) for k, v in jtr.weights.items()})
    tstep = ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)))
    j_losses, t_losses = [], []
    for i in range(3):
        batch, ctx = _x(n=128, seed=20 + i), _x(n=128, seed=30 + i, width=C)
        weights, opt_state, loss = jstep(weights, opt_state, jnp.asarray(batch),
                                         jnp.asarray(ctx))
        j_losses.append(float(loss))
        t_losses.append(float(tstep(torch.from_numpy(batch), torch.from_numpy(ctx))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    for k in KEYS:
        np.testing.assert_allclose(ttr.weights[k].detach().numpy(), np.asarray(weights[k]),
                                   atol=5e-4, rtol=0, err_msg=k)
    # to_flow writes the context stacks back
    x, c = torch.from_numpy(_x(n=128, seed=40)), torch.from_numpy(_x(128, 41, width=C))
    with torch.no_grad():
        trained = ttr.to_flow().log_prob(x, c)
        assert (trained - tflow.log_prob(x, c)).abs().max() > 1e-3
        _close(-trained.mean(), ttr.loss_fn(ttr.weights, x, c), 1e-5)
        rebuilt = nsf_fused._extract(ttr.to_flow(), torch.float32, fold_wh_scale=False)[1]
    for k in KEYS:
        _close(rebuilt[k], ttr.weights[k].detach(), 1e-5)


def test_trainer_context_errors(chains):
    _, tflow = chains["rq"]
    ttr = nsf_train.FusedNSFTrainer(tflow, batch_size=128)
    step = ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)))
    batch = torch.from_numpy(_x(n=128, seed=42))
    with pytest.raises(ValueError, match="pass the context"):
        step(batch)
    with pytest.raises(ValueError, match="context of shape"):
        step(batch, torch.zeros(128, C + 1))
    with pytest.raises(ValueError, match="context of shape"):
        step(batch, torch.zeros(64, C))
    uncond = nsf_train.FusedNSFTrainer(
        NeuralSplineFlow(D, HIDDEN, num_layers=2, num_bins=4, device="cpu"), batch_size=128)
    assert uncond.context_features is None and sorted(uncond.weights) == sorted(
        nsf_train.WEIGHT_KEYS)
    with pytest.raises(ValueError, match="unexpected context"):
        uncond.loss_fn(uncond.weights, batch, torch.zeros(128, C))


# -- the conditional fused view ------------------------------------------------------


@pytest.mark.parametrize("family", ["rq", "affine"])
def test_fused_view_log_prob_matches_the_unfused_flow(chains, family):
    _, tflow = chains[family]
    fused = nsf_fused.fuse_nsf(tflow)
    assert fused.context_features == C
    x, c = torch.from_numpy(_x(seed=44)), torch.from_numpy(_x(seed=45, width=C))
    with torch.no_grad():
        _close(fused.log_prob(x, c), tflow.log_prob(x, c), 1e-5)
        for direction in ("forward", "inverse"):
            y, lad = getattr(fused, direction)(x, c)
            t_y, t_lad = getattr(tflow.transform, direction)(x, context=c)
            _close(y, t_y, 1e-5)
            _close(lad, t_lad, 1e-5)
        # the same generator gives the unfused flow's samples
        s, lp = fused.sample_and_log_prob(torch.Generator().manual_seed(3), 4, c[:5])
        r, r_lp = tflow.sample_and_log_prob(torch.Generator().manual_seed(3), 4, c[:5])
        assert s.shape == (5, 4, D) and lp.shape == (5, 4)
        _close(s, r, 1e-5)
        _close(lp, r_lp, 1e-5)
        _close(fused.sample(torch.Generator().manual_seed(3), 4, c[:5]), r, 1e-5)


def test_sampling_layout_matches_the_jax_view(chains):
    """``sample`` and ``sample_and_log_prob`` against JAX's
    ``_sample_conditional``, both fed the same numpy noise: [M, n, D]
    samples and [M, n] log-probs, context row m repeated n times."""
    jflow, tflow = chains["quadratic"]
    jview = jax_fused.fuse_nsf(jflow, dtype=jnp.float32, lanes=64, interpret=True)
    tview = nsf_fused.fuse_nsf(tflow)
    m, n = 5, 4
    noise = _x(n=m * n, seed=46, scale=1.0)
    c = _x(n=m, seed=47, width=C)
    jview._conditional_noise = lambda key, num, emb: (
        jnp.asarray(noise), jnp.repeat(emb, num, axis=0))
    tview._noise = lambda generator, num: torch.from_numpy(noise[:num])
    j_s, j_lp = jview.sample_and_log_prob(jax.random.key(0), n, context=jnp.asarray(c))
    with torch.no_grad():
        s, lp = tview.sample_and_log_prob(None, n, torch.from_numpy(c))
        s_only = tview.sample(None, n, torch.from_numpy(c))
    assert s.shape == j_s.shape == (m, n, D) and lp.shape == j_lp.shape == (m, n)
    _close(s, j_s, ATOL, 2e-6)
    _close(lp, j_lp, ATOL)
    _close(s_only, j_s, ATOL, 2e-6)


def test_embedding_net_runs_once_outside_the_kernel():
    jflow, tflow = _pair("rq", seed=48, embedding=True)
    calls = []
    tflow.embedding_net.register_forward_hook(lambda *args: calls.append(1))
    fused = nsf_fused.fuse_nsf(tflow)
    assert fused.context_features == C
    x, c = _x(seed=49), _x(seed=50, width=2)
    with torch.no_grad():
        lp = fused.log_prob(torch.from_numpy(x), torch.from_numpy(c))
        assert len(calls) == 1
        fused.sample_and_log_prob(torch.Generator().manual_seed(1), 3, torch.from_numpy(c[:4]))
        assert len(calls) == 2
        _close(lp, tflow.log_prob(torch.from_numpy(x), torch.from_numpy(c)), 1e-5)
    _close(lp, jflow.log_prob(x, c))
    # CompiledFlow takes the raw context's width; the kernel the embedded one
    served = CompiledFlow(tflow, batch_size=N, features=D, context_features=2, device="cpu")
    assert served.is_fused
    _close(served.log_prob(torch.from_numpy(x), torch.from_numpy(c)), lp, 1e-6)


def test_context_refusals(chains):
    _, tflow = chains["rq"]
    fused = nsf_fused.fuse_nsf(tflow)
    x, c = torch.from_numpy(_x(seed=51)), torch.from_numpy(_x(seed=52, width=C))
    with pytest.raises(ValueError, match="conditional"):
        fused.log_prob(x)
    with pytest.raises(ValueError, match="rows"):
        fused.log_prob(x, c[:10])
    with pytest.raises(ValueError, match="context must be"):
        fused.log_prob(x, c[:, :2])
    plain = NeuralSplineFlow(D, HIDDEN, num_layers=2, num_bins=4, device="cpu")
    with pytest.raises(ValueError, match="without context"):
        nsf_fused.fuse_nsf(plain).log_prob(x, c)
    with pytest.raises(ValueError, match="without context"):
        nsf_fused.fuse_nsf(plain).sample(None, 3, c)
    # CompiledFlow: conditionality and width must match the flow's
    with pytest.raises(ValueError, match="conditionality"):
        CompiledFlow(tflow, batch_size=N, features=D, use_fused=True, device="cpu")
    with pytest.raises(ValueError, match="conditionality"):
        CompiledFlow(tflow, batch_size=N, features=D, context_features=C + 1,
                     use_fused=True, device="cpu")
    mixed = Flow(CompositeTransform(list(tflow.transform.transforms[:2])
                                    + list(plain.transform.transforms[2:4])),
                 StandardNormal([D]))
    with pytest.raises(ValueError, match="homogeneous"):
        nsf_fused.fuse_nsf(mixed)


# -- serving, trainer selection and the autograd route ---------------------------------


@pytest.mark.parametrize("family", ["rq", "cubic", "additive"])
def test_compiled_flow_serves_a_conditional_flow_fused(chains, family):
    jflow, tflow = chains[family]
    served = CompiledFlow(tflow, batch_size=N, features=D, context_features=C, device="cpu")
    assert served.is_fused
    unfused = CompiledFlow(tflow, batch_size=N, features=D, context_features=C,
                           use_fused=False, device="cpu")
    x, c = _x(seed=54), _x(seed=55, width=C)
    lp = served.log_prob(torch.from_numpy(x), torch.from_numpy(c))
    _close(lp, unfused.log_prob(torch.from_numpy(x), torch.from_numpy(c)), 1e-5)
    _close(lp, jflow.log_prob(x, c), 5e-4 if family == "cubic" else ATOL)
    g = torch.Generator().manual_seed(2)
    s = served.sample(g, torch.from_numpy(c))
    assert s.shape == (N, N, D)
    s1, lp1 = served.sample_and_log_prob(torch.Generator().manual_seed(2),
                                         torch.from_numpy(c))
    _close(s1, s, 0.0)
    assert lp1.shape == (N, N)


def test_fused_trainer_refuses_an_embedding_net_naming_both_routes():
    _, tflow = _pair("rq", seed=56, embedding=True)
    with pytest.raises(ValueError) as err:
        fused_trainer(tflow, 128)
    text = str(err.value)
    assert "make_train_step" in text and "nsf_train_apply" in text
    assert "FusedNSFTrainer: fused training takes the RAW context" in text
    with pytest.raises(ValueError, match="embedding_net"):
        nsf_train.FusedNSFTrainer(tflow, batch_size=128)


def test_embedding_net_trains_through_nsf_train_apply():
    """An embedding net composed with ``nsf_train_apply`` under autograd gets
    the eager route's gradients (the port's unfused flow with the same
    embedding net), as do the chain's weights."""
    _, tflow = _pair("rq", seed=57, embedding=True)
    emb = tflow.embedding_net
    inner = Flow(tflow.transform, tflow.distribution)
    idx, weights, static, _, _ = nsf_fused._extract(inner, torch.float32, fold_wh_scale=False)
    weights = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    wh_scale = nsf_train.family_wh_scale(static, HIDDEN)
    x, c = torch.from_numpy(_x(n=128, seed=58)), torch.from_numpy(_x(128, 59, width=2))
    y, lad = nsf_train.nsf_train_apply(weights, x, idx, static, wh_scale, context=emb(c))
    loss = -(-0.5 * (y * y).sum(1) - 0.5 * D * np.log(2 * np.pi) + lad).mean()
    fused_grads = torch.autograd.grad(loss, list(emb.parameters()) + [weights["wc0"]])
    eager_loss = -tflow.log_prob(x, c).mean()
    _close(loss, eager_loss.detach(), 1e-5)
    eager_grads = torch.autograd.grad(eager_loss, list(emb.parameters()))
    for a, b in zip(fused_grads, eager_grads):
        _close(a, b, 1e-5)
    initial = tflow.transform.transforms[1].transform_net.initial_layer.weight
    g_initial = torch.autograd.grad(-tflow.log_prob(x, c).mean(), initial)[0]
    Tid = weights["w0"].shape[2]
    _close(fused_grads[-1][0], g_initial[:, Tid:], 1e-5)


# -- the launchers ------------------------------------------------------------------------


def test_the_training_launcher_gets_the_context(monkeypatch, chains):
    """B3/B4's launcher is handed C, the context, the context stacks in both
    layouts and their gradient buffers (B4 also gctx's), and null pointers
    with C = 0. The launch is caught before the library: the wrapper's
    kernel path on CPU tensors (as tests/test_torch_spline_train.py does)."""
    import contextlib
    import types

    from nflows_tpu_torch.ops.cuda import _build

    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(nsf_train_launch=launch)
    nsf_train._declare(lib)
    monkeypatch.setattr(_build, "load_library", lambda stem, declare: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=4))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    x, ctx = torch.from_numpy(_x(n=40)), torch.from_numpy(_x(n=40, seed=60, width=C))
    for flow, context in ((chains["rq"][1], ctx),
                          (NeuralSplineFlow(D, HIDDEN, num_layers=2, num_bins=4, device="cpu"),
                           None)):
        ttr = nsf_train.FusedNSFTrainer(flow, 128)
        packed = nsf_flow_kernel.pack_weights(ttr.weights, ttr._indices)
        for loss in (True, False):
            calls.clear()
            _, grads = nsf_train._launch(loss, x, x, x[:, 0].contiguous(), ttr.weights,
                                         ttr._indices, ttr._static, ttr._wh_scale, packed,
                                         None, 32, 1.0 / 40, context, cluster=1)
            (args,) = calls
            assert len(args) == len(launch.argtypes)
            # after the 17 pointers of the weights, gradients and scratch
            c, ctx_p, gctx_p, pwc0, pwcb, bcb, wc0, wcb, gwc0, gwcb, gbcb = args[33:44]
            if context is None:
                assert c == 0 and not any((ctx_p, gctx_p, pwc0, pwcb, bcb, wc0, wcb, gwc0,
                                           gwcb, gbcb))
                assert "ctx" not in grads
                continue
            assert c == C and ctx_p == context.data_ptr()
            assert (pwc0, pwcb, bcb) == tuple(packed[k].data_ptr() for k in ("wc0", "wcb", "bcb"))
            assert (wc0, wcb) == (ttr.weights["wc0"].data_ptr(), ttr.weights["wcb"].data_ptr())
            assert (gwc0, gwcb, gbcb) == tuple(grads[k].data_ptr() for k in ("wc0", "wcb", "bcb"))
            assert packed["wc0"].shape == (2, C, HIDDEN) and packed["bcb"].shape == (2, 2, HIDDEN)
            if loss:
                assert gctx_p == 0 and "ctx" not in grads
            else:
                assert gctx_p == grads["ctx"].data_ptr() and grads["ctx"].shape == (40, C)


# -- the launchers' shared-memory counts ------------------------------------------------


def _smem_bytes_of(source, **values):
    """Evaluate ``smem_bytes`` of a CUDA source in Python: the casts
    dropped, ``a.X`` read from ``values``, ``c ? t : f`` as a conditional."""
    text = (Path(nsf_flow_kernel.__file__).resolve().parents[2] / "csrc" / source).read_text()
    body = re.search(r"size_t smem_bytes\(int rows, const \w+(?:<\w+>)?& a\) \{\s*return "
                     r"(.*?);\s*\}", text, re.S).group(1)
    expr = body.replace("(size_t)", "").replace("sizeof(float)", "4")
    expr = re.sub(r"\(a\.(\w+) \? ([^:]+) : ([^)]+)\)", r"((\2) if a.\1 else (\3))", expr)
    expr = re.sub(r"\ba\.(\w+)", r"v['\1']", expr)
    return eval(expr, {"v": values, "rows": values["rows"], "KC": 32, "OC": 256})


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("dims", [
    dict(D=6, L=10, H=256, Tid=3, T=3, TM=69, C=0),
    dict(D=6, L=10, H=256, Tid=3, T=3, TM=69, C=10),
    dict(D=5, L=3, H=64, Tid=2, T=3, TM=33, C=7),
])
def test_shared_memory_counts_match_the_sources(rows, dims):
    r4 = nsf_flow_kernel._round4
    TB = max(dims["H"], r4(dims["TM"]), r4(dims["Tid"]))
    args = (rows, dims["D"], dims["H"], dims["Tid"], dims["T"], dims["TM"], dims["C"])
    # B2's kernel, for either weight type, is nsf_flow_kernel.cuh
    assert nsf_flow_kernel.shared_memory_bytes(*args) == _smem_bytes_of(
        "nsf_flow_kernel.cuh", rows=rows, TB=TB, **dims)
    assert nsf_train.shared_memory_bytes(
        rows, dims["D"], dims["L"], dims["H"], dims["Tid"], dims["T"], dims["TM"],
        dims["C"]) == _smem_bytes_of("nsf_train.cu", rows=rows, TB=TB, **dims)
    if dims["C"] == 10 and rows == 32:
        # the flagship's conditional twin fits 32-sample tiles in all three kernels
        assert nsf_train.tile_rows(4096, dims, sms=132) == 32
        assert nsf_flow_kernel.shared_memory_bytes(*args) <= nsf_flow_kernel.MAX_SHARED_MEMORY
