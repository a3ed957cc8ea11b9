"""Training an IAF by variational inference on the CPU: B10's inverse
direction (the backward of the IAF's sampling pass) in its plain version,
and ``FusedIAFTrainer`` (``sample_and_log_prob_fn``, ``make_vi_train_step``)
against the JAX package's ``FusedIAFTrainer`` in interpret mode, on carried
weights and the same numpy inputs.

Tolerances. The hand-derived adjoint against autograd over the plain chain
in float64: 1e-10. Against ``jax.vjp`` of the JAX kernels' custom_vjp in
fp32: gx and each gradient stack 2e-4, the JAX package's bar for its
training kernels (tests/ops/test_maf_train.py). Samples 1e-5 and log q 1e-4
against the JAX trainer and the unfused ``transform.inverse`` (the JAX
package's own bars, tests/ops/test_maf_train.py:230-238). Three reverse-KL
steps: losses 2e-4; weights 5e-4 on 99% of each stack and three steps of
lr on all (Adam moves an entry whose gradient is within rounding of zero
by up to lr either way). The IAFs' MADE blocks have their second linears
redrawn at the first's scale (``lively``), so that no gradient stack held
at 2e-4 sits near 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.models import InverseAutoregressiveFlow as JaxIAF
from nflows_tpu.ops.pallas import maf_fused as jax_fused
from nflows_tpu.ops.pallas.maf_train import FusedIAFTrainer as JaxIAFTrainer
from nflows_tpu.ops.pallas.maf_train import maf_train_vjp_call
from nflows_tpu_torch import (
    InverseAutoregressiveFlow,
    MaskedAutoregressiveFlow,
    fused_trainer,
    load_jax_params,
)
from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_train
from nflows_tpu_torch.training import fused as fused_module
from test_torch_maf_context import held, lively

torch.set_num_threads(1)

KEYS = maf_train.WEIGHT_KEYS


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(features=4, hidden=16, seed=0, permutations=False):
    kw = dict(features=features, hidden_features=hidden, num_layers=2, num_blocks_per_layer=2,
              use_random_permutations=permutations)
    jflow = lively(JaxIAF(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw),
                   hidden)
    tflow = InverseAutoregressiveFlow(device="cpu", rng=np.random.default_rng(seed + 100), **kw)
    load_jax_params(tflow, _jax_params(jflow))
    return jflow, tflow.eval()


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(a, b, atol, rtol=0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _target(features, seed, lib):
    """A correlated Gaussian N(mu, Sigma) with mu and Sigma fixed from a
    seed, as a log-density up to a constant in torch or jax.numpy."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=features).astype(np.float32)
    a = rng.normal(size=(features, features)) / math.sqrt(features)
    sigma = a @ a.T + 0.5 * np.eye(features)
    prec = np.linalg.inv(sigma).astype(np.float32)
    if lib == "torch":
        mu_t, prec_t = torch.from_numpy(mu), torch.from_numpy(prec)
        return (lambda x: -0.5 * (((x - mu_t) @ prec_t) * (x - mu_t)).sum(dim=1)), mu, sigma
    mu_j, prec_j = jnp.asarray(mu), jnp.asarray(prec)
    return (lambda x: -0.5 * jnp.sum(((x - mu_j) @ prec_j) * (x - mu_j), axis=1)), mu, sigma


@pytest.mark.parametrize("permutations", [False, True])
def test_bwd_plain_inverse_direction_matches_autograd_in_float64(permutations):
    _, tflow = _pair(5, seed=1, permutations=permutations)
    tr = maf_train.FusedIAFTrainer(tflow, batch_size=128)
    w = {k: v.detach().double() for k, v in tr._fold(tr.weights).items()}
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.normal(size=(61, 5)))
    gy, glad = torch.from_numpy(rng.normal(size=(61, 5))), torch.from_numpy(rng.normal(size=61))
    kw = dict(wh_scale=None, **tr._static)
    gz, grads = maf_train.maf_train_bwd_plain(z, gy, glad, w, tr._layers, direction="inverse",
                                              **kw)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    zl = z.clone().requires_grad_(True)
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(zl, leaves, tr._layers, inverse=True, **kw)
    want = torch.autograd.grad((y, lad), [zl] + [leaves[k] for k in KEYS], (gy, glad))
    _close(gz, want[0], 1e-10)
    for k, g in zip(KEYS, want[1:]):
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-10, rtol=0, err_msg=k)
    assert "ctx" not in grads


def test_bwd_plain_inverse_direction_matches_jax_vjp():
    jflow, tflow = _pair(5, seed=3, permutations=True)
    tr = maf_train.FusedIAFTrainer(tflow, batch_size=128)
    static, _, nb, _, transformer, spline_kw, _ = jax_fused._extract(
        jflow, jnp.float32, allow_wrapped=True)
    apply = maf_train_vjp_call(static, transformer, nb, spline_kw, 16, 128, True,
                               direction="inverse")
    folded = {k: v.detach() for k, v in tr._fold(tr.weights).items()}
    z = _normal(4, (128, 5))
    gy, glad = _normal(5, (128, 5)) / 128, _normal(6, (128,)) / 128
    (jx, jlad), vjp = jax.vjp(apply, {k: jnp.asarray(v.numpy()) for k, v in folded.items()},
                              jnp.asarray(z.T))
    j_gw, j_gz = vjp((jnp.asarray(gy.T), jnp.asarray(glad[None])))
    before = maf_train.bwd_launch_count
    gz, grads = maf_train.maf_train_bwd_cuda(
        torch.from_numpy(z), torch.from_numpy(gy), torch.from_numpy(glad), folded, tr._layers,
        direction="inverse", **tr._static)
    assert maf_train.bwd_launch_count == before         # the plain version launches nothing
    held(gz, np.asarray(j_gz).T, 2e-4, "gz")
    for k in KEYS:
        held(grads[k].numpy(), j_gw[k], 2e-4, k)


def test_sample_and_log_prob_fn_matches_jax_and_the_unfused_chain():
    jflow, tflow = _pair()
    jtr = JaxIAFTrainer(jflow, batch_size=128, interpret=True)
    tr = fused_trainer(tflow, 128)
    assert isinstance(tr, maf_train.FusedIAFTrainer)
    assert sorted(tr.weights) == sorted(jtr.weights) == sorted(KEYS)
    z = _normal(11, (128, 4))
    jx_t, jlq = jtr.sample_and_log_prob_fn(jtr.weights, jnp.asarray(z.T))
    with torch.no_grad():
        x, lq = tr.sample_and_log_prob_fn(tr.weights, torch.from_numpy(z))
        x_ref, lad_ref = tflow.transform.inverse(torch.from_numpy(z))
    _close(x, np.asarray(jx_t).T, 1e-5)
    _close(lq, jlq, 1e-4)
    _close(x, x_ref, 1e-5)
    lq_ref = -0.5 * (torch.from_numpy(z) ** 2).sum(dim=1) - 2 * math.log(2 * math.pi) - lad_ref
    _close(lq, lq_ref, 1e-4)
    with torch.no_grad():
        _close(lq, tflow.log_prob(x), 1e-3)        # through the fixed point and back


def test_three_reverse_kl_steps_match_jax_value_and_grad():
    """The port's step draws its noise from the generator; the same draws,
    fed to the JAX trainer's ``sample_and_log_prob_fn`` under
    ``jax.value_and_grad`` and optax's Adam, give the same losses and
    weights."""
    jflow, tflow = _pair(seed=7, permutations=True)
    jtr = JaxIAFTrainer(jflow, batch_size=128, interpret=True)
    tr = maf_train.FusedIAFTrainer(tflow, batch_size=128)
    t_target, _, _ = _target(4, 8, "torch")
    j_target, _, _ = _target(4, 8, "jax")
    opt = optax.adam(1e-2)
    weights, opt_state = jtr.weights, opt.init(jtr.weights)

    def j_loss(w, z_t):
        x_t, lq = jtr.sample_and_log_prob_fn(w, z_t)
        return jnp.mean(lq - j_target(x_t.T))

    step = tr.make_vi_train_step(tr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)), t_target)
    j_losses, t_losses = [], []
    for i in range(3):
        z = torch.randn(128, 4, generator=torch.Generator().manual_seed(100 + i))
        loss, grads = jax.value_and_grad(j_loss)(weights, jnp.asarray(z.numpy().T))
        updates, opt_state = opt.update(grads, opt_state, weights)
        weights = optax.apply_updates(weights, updates)
        j_losses.append(float(loss))
        t_losses.append(float(step(torch.Generator().manual_seed(100 + i))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    for k in KEYS:
        gap = np.abs(tr.weights[k].detach().numpy() - np.asarray(weights[k]))
        assert np.quantile(gap, 0.99) <= 5e-4 and gap.max() <= 3e-2, (k, gap.max())
    for k in maf_train.MASKED_KEYS:
        dead = tr._masks[k] == 0
        assert dead.any() and not tr.weights[k].grad[dead].any()


def test_vi_fits_a_correlated_gaussian():
    """Reverse-KL steps on a seeded N(mu, Sigma) target (JAX
    tests/ops/test_maf_train.py:285-313 fits a shifted Gaussian): the loss
    falls and the samples' mean moves to mu; to_flow() samples as the
    trainer does."""
    _, tflow = _pair(features=3, hidden=8, seed=2)
    tr = maf_train.FusedIAFTrainer(tflow, batch_size=128)
    target, mu, _ = _target(3, 9, "torch")
    step = tr.make_vi_train_step(tr.init_opt(lambda p: torch.optim.Adam(p, lr=5e-2)), target)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(gen)) for _ in range(40)]
    assert np.isfinite(losses).all() and np.mean(losses[-5:]) < losses[0] - 0.5, losses
    z = torch.from_numpy(_normal(5, (2048, 3)))
    with torch.no_grad():
        x, _ = tr.sample_and_log_prob_fn(tr.weights, z)
        assert np.all(np.abs(x.mean(dim=0).numpy() - mu) < 0.3), (x.mean(dim=0), mu)
        x_ref, _ = tr.to_flow().transform.inverse(z)
    _close(x, x_ref, 1e-5)


def test_conditional_vi_step_trains_the_context_weights():
    from test_torch_maf_context import _pair as context_pair

    jflow, tflow = context_pair("iaf", seed=3, hidden=16)
    jtr = JaxIAFTrainer(jflow, batch_size=128, interpret=True)
    tr = fused_trainer(tflow, 128)
    assert isinstance(tr, maf_train.FusedIAFTrainer) and tr.context_features == 3
    z, c = _normal(12, (128, 5)), _normal(13, (128, 3))
    jx_t, jlq = jtr.sample_and_log_prob_fn(jtr.weights, jnp.asarray(z.T), jnp.asarray(c.T))
    with torch.no_grad():
        x, lq = tr.sample_and_log_prob_fn(tr.weights, torch.from_numpy(z), torch.from_numpy(c))
    _close(x, np.asarray(jx_t).T, 1e-5)
    _close(lq, jlq, 1e-4)
    target = lambda v: -0.5 * ((v - 1.0) ** 2).sum(dim=1)  # noqa: E731
    start = {k: v.detach().clone() for k, v in tr.weights.items()}
    step = tr.make_vi_train_step(tr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)), target)
    loss = step(torch.Generator().manual_seed(0), torch.from_numpy(c))
    assert torch.isfinite(loss)
    for k in maf_flow_kernel.CONTEXT_KEYS:
        assert not torch.equal(tr.weights[k].detach(), start[k]), k
    with pytest.raises(ValueError, match="conditional"):
        step(torch.Generator().manual_seed(1))


def test_iaf_refusals():
    maf = MaskedAutoregressiveFlow(5, 16, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="all-wrapped"):
        maf_train.FusedIAFTrainer(maf, batch_size=128)
    _, iaf = _pair()
    with pytest.raises(ValueError, match="fixed point"):
        maf_train.FusedMAFTrainer(iaf, batch_size=128)
    tr = maf_train.FusedIAFTrainer(iaf, batch_size=128)
    with pytest.raises(NotImplementedError, match="SAMPLING"):
        tr.loss_fn(tr.weights, torch.zeros(128, 4))
    opt = tr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-3))
    with pytest.raises(NotImplementedError, match="SAMPLING"):
        tr.make_train_step(opt)
    with pytest.raises(NotImplementedError, match="SAMPLING"):
        tr.make_loop_step()
    step = tr.make_vi_train_step(opt, lambda x: -0.5 * (x * x).sum(dim=1))
    with pytest.raises(TypeError, match="torch.Generator"):
        step(0)
    with pytest.raises(ValueError, match="unconditional"):
        step(torch.Generator(), torch.zeros(128, 3))
    folded = {k: v.detach() for k, v in tr._fold(tr.weights).items()}
    z = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="fixed point"):
        maf_train.maf_train_bwd_plain(z, z, z[:, 0], folded, tr._layers, **tr._static)
    with pytest.raises(ValueError, match="direction must be"):
        maf_train.maf_train_apply(folded, z, tr._layers, tr._static, None, direction="back")
    maf_static = maf_train.FusedMAFTrainer(maf, 128)._layers
    with pytest.raises(ValueError, match="all-wrapped"):
        maf_train.maf_train_apply(folded, torch.zeros(8, 5), maf_static, tr._static, None,
                                  direction="inverse")


def test_fused_trainer_probes_the_iaf_trainer_after_the_maf_one():
    _, iaf = _pair()
    assert isinstance(fused_trainer(iaf, 128), maf_train.FusedIAFTrainer)
    assert isinstance(fused_trainer(iaf, 128, auto=True), maf_train.FusedIAFTrainer)
    assert "iaf" in fused_module.MIN_AUTO_BATCH
    feedforward = InverseAutoregressiveFlow(5, 16, 2, 1, use_residual_blocks=False,
                                            device="cpu")
    with pytest.raises(ValueError) as err:
        fused_trainer(feedforward, 128)
    text = str(err.value)
    assert text.index("FusedMAFTrainer: ") < text.index("FusedIAFTrainer: ") < text.index(
        "FusedMADEMoGTrainer: ")
