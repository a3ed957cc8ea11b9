"""The fused mixture-density training path on the CPU: the plain version of
kernel B12 (the adjoint written out) against autograd and against the JAX
package, and the port's ``FusedMADEMoGTrainer`` against the JAX package's
trainer, on the same weights and numpy inputs.

Tolerances. The written-out adjoint against autograd over the plain
log_prob in float64: 1e-10 (the same arithmetic in another order). Against
``jax.grad`` of the JAX trainer's loss in fp32: loss 1e-4, each gradient
stack, gx and gctx 2e-4, the JAX package's own bar for its training kernels
(tests/ops/test_mademog_train.py). Three Adam steps: losses 2e-4, weights
5e-4 (same source). ``to_dist()`` round trip: exact. Masked entries:
gradient exactly 0.0 and the entry bit-equal after training.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.nn.nde.made import MixtureOfGaussiansMADE as JaxMoG
from nflows_tpu.ops.pallas.mademog_train import FusedMADEMoGTrainer as JaxTrainer
from nflows_tpu.training import create_train_state as jax_create_train_state
from nflows_tpu.training import make_train_step as jax_make_train_step
from nflows_tpu_torch import (
    MADEMoG,
    MaskedAutoregressiveFlow,
    MixtureOfGaussiansMADE,
    NeuralSplineFlow,
    create_train_state,
    fused_trainer,
    load_jax_params,
    load_jax_trainer_weights,
    make_train_step,
)
from nflows_tpu_torch.ops.cuda import mademog_fused, mademog_train
from nflows_tpu_torch.ops.cuda.maf_train import FusedMAFTrainer
from nflows_tpu_torch.ops.cuda.nsf_train import FusedNSFTrainer

torch.set_num_threads(1)

KEYS = ("wi", "bi", "wb", "bb", "wf", "bf")
CONTEXT_KEYS = ("wci", "bci", "wcb", "bcb")


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(context_features=None, features=5, K=4, seed=0, hidden=16):
    kw = dict(features=features, hidden_features=hidden, context_features=context_features,
              num_blocks=2, num_mixture_components=K)
    jm = JaxMoG(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
    tm = MixtureOfGaussiansMADE(rng=np.random.default_rng(seed), device="cpu", **kw)
    load_jax_params(tm, _jax_params(jm))
    return jm, tm


def _batch(seed, n=128, d=5, context_features=None):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 1.5).astype(np.float32)
    c = (None if context_features is None
         else rng.normal(size=(n, context_features)).astype(np.float32))
    return x, c


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


@pytest.fixture(scope="module", params=[None, 3], ids=["unconditional", "context"])
def both(request):
    """(context features, JAX model, port model, JAX trainer, port trainer)."""
    jm, tm = _pair(request.param)
    return (request.param, jm, tm, JaxTrainer(jm, batch_size=128, interpret=True),
            mademog_train.FusedMADEMoGTrainer(tm, batch_size=128))


def _folded(trainer, dtype=torch.float32):
    return {k: v.detach().to(dtype).contiguous()
            for k, v in trainer._fold(trainer.weights).items()}


@pytest.mark.parametrize("context_features", [None, 3])
@pytest.mark.parametrize("K", [1, 4])
def test_bwd_plain_matches_autograd_in_float64(K, context_features):
    _, tm = _pair(context_features, K=K, seed=K)
    tr = mademog_train.FusedMADEMoGTrainer(tm, batch_size=128)
    w = _folded(tr, torch.float64)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(77, 5)) * 1.5)
    c = None if context_features is None else torch.from_numpy(rng.normal(size=(77, 3)))
    glp = torch.from_numpy(rng.normal(size=(77,)))
    gx, gctx, grads = mademog_train.mademog_train_bwd_plain(x, glp, w, tr._static, c)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    xl = x.clone().requires_grad_(True)
    cl = None if c is None else c.clone().requires_grad_(True)
    lp = mademog_fused.mademog_log_prob_plain(xl, leaves, tr._static, cl)
    inputs = [xl] + ([] if cl is None else [cl]) + list(leaves.values())
    want = torch.autograd.grad(lp, inputs, glp)
    _close(gx, want[0], 1e-10)
    if c is None:
        assert gctx is None
    else:
        _close(gctx, want[1], 1e-10)
    assert sorted(grads) == sorted(leaves)
    for k, g in zip(leaves, want[len(inputs) - len(leaves):]):
        assert grads[k].shape == w[k].shape and grads[k].dtype == torch.float64
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-10, rtol=0, err_msg=k)
    # the kernel's gradients are dense: masked entries do get one before the fold's chain rule
    assert grads["wb"][tr._masks["wb"] == 0].abs().max() > 0


def test_trainer_weights_are_the_jax_trainers(both):
    cf, _, _, jtr, ttr = both
    keys = KEYS + (CONTEXT_KEYS if cf else ())
    assert sorted(ttr.weights) == sorted(jtr.weights) == sorted(keys)
    for k in keys:
        np.testing.assert_array_equal(ttr.weights[k].detach().numpy(), np.asarray(jtr.weights[k]))
    for k in mademog_fused.MASKED_KEYS:
        np.testing.assert_array_equal(ttr._masks[k].numpy(), np.asarray(jtr._masks[k]))
    assert ttr._static == jtr._static and ttr.context_features == jtr.context_features


def test_bwd_plain_matches_jax_grad_including_gx_and_gctx(both):
    cf, _, _, jtr, ttr = both
    x, c = _batch(3, context_features=cf)
    args = (jtr.weights, jnp.asarray(x.T)) + (() if c is None else (jnp.asarray(c.T),))
    argnums = (0, 1) if c is None else (0, 1, 2)
    j_loss, j_grads = jax.value_and_grad(jtr.loss_fn, argnums=argnums)(*args)
    n = x.shape[0]
    folded = _folded(ttr)
    lp = mademog_fused.mademog_log_prob_cuda(_t(x), folded, ttr._static, _t(c))
    _close(-lp.mean(), j_loss, 1e-4)
    before = mademog_train.bwd_launch_count
    gx, gctx, grads = mademog_train.mademog_train_bwd_cuda(
        _t(x), torch.full((n,), -1.0 / n), folded, ttr._static, _t(c))
    assert mademog_train.bwd_launch_count == before    # the plain version launches nothing
    _close(gx, np.asarray(j_grads[1]).T, 2e-4)
    if c is not None:
        _close(gctx, np.asarray(j_grads[2]).T, 2e-4)
    for k, g in grads.items():
        g = g * ttr._masks[k] if k in ttr._masks else g     # the fold's chain rule
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[0][k]), atol=2e-4, rtol=0,
                                   err_msg=k)


def test_trainer_loss_and_gradients_match_jax(both):
    """``loss_fn`` through the fold and the differentiable apply (B11
    forward, B12 backward on the card; their plain versions here)."""
    cf, _, tm, jtr, ttr = both
    x, c = _batch(4, context_features=cf)
    args = (jtr.weights, jnp.asarray(x.T)) + (() if c is None else (jnp.asarray(c.T),))
    j_loss, j_gw = jax.value_and_grad(jtr.loss_fn)(*args)
    loss, grads = ttr._value_and_grad()(ttr.weights, _t(x), _t(c))
    _close(loss, j_loss, 1e-4)
    with torch.no_grad():
        _close(loss, -tm.log_prob(_t(x), _t(c)).mean(), 1e-5)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_gw[k]), atol=2e-4,
                                   rtol=0, err_msg=k)
    for k in mademog_fused.MASKED_KEYS:
        dead = ttr._masks[k] == 0
        assert dead.any() and not grads[k][dead].any()      # exactly 0.0
    # the context and the inputs get their cotangents through the apply too
    if c is not None:
        ct = _t(c).requires_grad_(True)
        xt = _t(x).requires_grad_(True)
        g_c, g_x = torch.autograd.grad(ttr.loss_fn(ttr.weights, xt, ct), [ct, xt])
        _, (_, j_gx, j_gc) = jax.value_and_grad(jtr.loss_fn, argnums=(0, 1, 2))(*args)
        _close(g_c, np.asarray(j_gc).T, 2e-4)
        _close(g_x, np.asarray(j_gx).T, 2e-4)


def test_three_adam_steps_match_the_jax_trainer(both):
    cf, jm, tm, _, _ = both
    jtr = JaxTrainer(jm, batch_size=128, interpret=True)
    opt = optax.adam(1e-2)
    jstep = jtr.make_train_step(opt, donate=False)
    weights, opt_state = jtr.weights, jtr.init_opt(opt)

    ttr = fused_trainer(tm, 128)
    assert isinstance(ttr, mademog_train.FusedMADEMoGTrainer)
    load_jax_trainer_weights(ttr, {k: np.asarray(v) for k, v in jtr.weights.items()})
    start = {k: v.detach().clone() for k, v in ttr.weights.items()}
    tstep = ttr.make_train_step(ttr.init_opt(_adam))
    j_losses, t_losses = [], []
    for i in range(3):
        x, c = _batch(10 + i, context_features=cf)
        jargs = (jnp.asarray(x),) + (() if c is None else (jnp.asarray(c),))
        weights, opt_state, loss = jstep(weights, opt_state, *jargs)
        j_losses.append(float(loss))
        t_losses.append(float(tstep(_t(x), _t(c))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    for k in ttr.weights:
        np.testing.assert_allclose(ttr.weights[k].detach().numpy(), np.asarray(weights[k]),
                                   atol=5e-4, rtol=0, err_msg=k)
    for k in mademog_fused.MASKED_KEYS:
        dead = ttr._masks[k] == 0
        assert torch.equal(ttr.weights[k].detach()[dead], start[k][dead])       # bit-equal
        assert not torch.equal(ttr.weights[k].detach()[~dead], start[k][~dead])


def test_three_adam_steps_of_the_eager_route_match_jax(both):
    cf, jm, tm, _, _ = both
    opt = optax.adam(1e-2)
    jstate = jax_create_train_state(jm, opt)
    jstep = jax_make_train_step(opt, donate=False)
    state = create_train_state(copy.deepcopy(tm).train(), _adam)
    step = make_train_step()
    fused = fused_trainer(copy.deepcopy(tm), 128)
    fused_step = fused.make_train_step(fused.init_opt(_adam))
    j_losses, t_losses, f_losses = [], [], []
    for i in range(3):
        x, c = _batch(20 + i, context_features=cf)
        jargs = (jnp.asarray(x),) + (() if c is None else (jnp.asarray(c),))
        jstate, metrics = jstep(jstate, *jargs)
        j_losses.append(float(metrics["loss"]))
        state, tmetrics = step(state, _t(x), _t(c))
        t_losses.append(float(tmetrics["loss"]))
        f_losses.append(float(fused_step(_t(x), _t(c))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    np.testing.assert_allclose(f_losses, t_losses, atol=2e-4, rtol=0)
    # the two routes of the port end at the same model
    x, c = _batch(30, context_features=cf)
    with torch.no_grad():
        _close(fused.to_dist().log_prob(_t(x), _t(c)), state.flow.log_prob(_t(x), _t(c)), 5e-3)


def test_masked_entries_do_not_move_in_twenty_steps():
    _, tm = _pair(seed=5)
    ttr = fused_trainer(tm, 128)
    start = {k: v.detach().clone() for k, v in ttr.weights.items()}
    step = ttr.make_train_step(ttr.init_opt(_adam))
    losses = [float(step(_t(_batch(40 + i % 4)[0]))) for i in range(20)]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    for k in mademog_fused.MASKED_KEYS:
        dead = ttr._masks[k] == 0
        assert torch.equal(ttr.weights[k].grad[dead], torch.zeros(int(dead.sum())))
        assert torch.equal(ttr.weights[k].detach()[dead], start[k][dead])
    # so the trained model is still autoregressive: feature k's parameters
    # ignore the inputs from k on
    made = ttr.to_made()
    x = _t(_batch(50, n=1)[0])[0]
    jac = torch.autograd.functional.jacobian(lambda v: made(v[None])[0], x)
    for k in range(5):
        assert not jac[12 * k:12 * (k + 1), k:].any()


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "mademog"])
def test_to_dist_round_trip_and_after_training(both, wrapped):
    cf, _, tm, _, _ = both
    model = tm
    if wrapped:
        model = MADEMoG(5, 16, cf, num_mixture_components=4, device="cpu")
        model.made.load_state_dict(tm.state_dict())
    ttr = fused_trainer(model, 128)
    x, c = _batch(5, context_features=cf)
    rebuilt = ttr.to_dist()
    assert type(rebuilt) is type(model) and rebuilt is not model
    for a, b in zip(rebuilt.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)                             # a pure re-laying
    assert isinstance(ttr.to_made(), MixtureOfGaussiansMADE)
    step = ttr.make_train_step(ttr.init_opt(_adam))
    step(_t(x), _t(c))
    with torch.no_grad():
        trained = ttr.to_dist().log_prob(_t(x), _t(c))
        assert (trained - model.log_prob(_t(x), _t(c))).abs().max() > 1e-3   # template untouched
        _close(-trained.mean(), ttr.loss_fn(ttr.weights, _t(x), _t(c)).detach(), 1e-5)
        served = mademog_fused.fuse_mademog(ttr.to_dist())
        _close(served.log_prob(_t(x), _t(c)), trained, 1e-5)


def test_load_jax_trainer_weights_takes_the_mademog_stacks(both):
    _, _, tm, jtr, _ = both
    ttr = mademog_train.FusedMADEMoGTrainer(copy.deepcopy(tm), 128)
    good = {k: np.asarray(v) * 0.5 for k, v in jtr.weights.items()}
    load_jax_trainer_weights(ttr, good)
    np.testing.assert_array_equal(ttr.weights["wf"].detach().numpy(), good["wf"])
    with pytest.raises(KeyError, match="missing"):
        load_jax_trainer_weights(ttr, {k: v for k, v in good.items() if k != "wi"})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_trainer_weights(ttr, {**good, "w0": good["wi"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_trainer_weights(ttr, {**good, "wb": good["wb"][:16]})


def test_fused_trainer_probes_and_guards_the_context():
    _, tm = _pair(seed=6)
    _, cm = _pair(3, seed=7)
    assert isinstance(fused_trainer(tm, 128), mademog_train.FusedMADEMoGTrainer)
    dist = MADEMoG(4, 16, None, num_mixture_components=3, device="cpu")
    assert isinstance(fused_trainer(dist, 128), mademog_train.FusedMADEMoGTrainer)
    # the other families are still taken by their own trainers, first
    assert isinstance(fused_trainer(MaskedAutoregressiveFlow(5, 16, 2, 1, device="cpu"), 128),
                      FusedMAFTrainer)
    assert isinstance(fused_trainer(NeuralSplineFlow(6, 16, num_layers=2, num_bins=4,
                                                     device="cpu"), 128), FusedNSFTrainer)
    feedforward = MixtureOfGaussiansMADE(5, 16, use_residual_blocks=False, device="cpu")
    with pytest.raises(ValueError) as err:
        fused_trainer(feedforward, 128)
    text = str(err.value)
    assert "no fused training kernel" in text and "eager route" in text
    assert text.index("FusedNSFTrainer") < text.index("FusedMAFTrainer") < text.index(
        "FusedMADEMoGTrainer: fused path requires residual-block MADE")
    assert fused_trainer(feedforward, 128, required=False) is None
    unconditional = fused_trainer(tm, 128)
    with pytest.raises(ValueError, match="unconditional"):
        unconditional.loss_fn(unconditional.weights, torch.zeros(128, 5), torch.zeros(128, 3))
    conditional = fused_trainer(cm, 128)
    with pytest.raises(ValueError, match="pass the context"):
        conditional.loss_fn(conditional.weights, torch.zeros(128, 5))
    with pytest.raises(ValueError, match="rows"):
        conditional.loss_fn(conditional.weights, torch.zeros(128, 5), torch.zeros(64, 3))
    with pytest.raises(ValueError, match="multiple of 128"):
        mademog_train.FusedMADEMoGTrainer(tm, batch_size=100)
    with pytest.raises(ValueError, match="batch of shape"):
        unconditional.make_train_step(unconditional.init_opt(_adam))(torch.zeros(64, 5))
