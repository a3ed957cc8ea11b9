"""The eager training route on the CPU: ``create_train_state`` /
``make_train_step`` of the port against the JAX package's on copied
weights, and the port's eager and fused routes against each other.

Tolerance: losses over three Adam steps (lr 1e-2) 2e-4, the JAX package's
own bar between its fused and XLA trajectories
(tests/ops/test_nsf_train.py); weights after the steps 5e-4 (same source);
``torch.optim.Adam`` and ``optax.adam`` share their defaults (b1 0.9, b2
0.999, eps 1e-8 outside the root).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.models import NeuralSplineFlow as JaxNSF
from nflows_tpu.training import create_train_state as jax_create_train_state
from nflows_tpu.training import make_train_step as jax_make_train_step
from nflows_tpu_torch import (
    NeuralSplineFlow,
    TrainState,
    create_train_state,
    fused_trainer,
    load_jax_params,
    make_train_step,
    nll_loss,
)

torch.set_num_threads(1)

CFG = dict(features=6, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
           num_bins=4, tail_bound=3.0, stacked=False)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


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


def _batch(seed, n=128, d=6, scale=1.5):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def flows():
    jflow = JaxNSF(key=jax.random.key(0), rng=np.random.default_rng(0), **CFG)
    tflow = NeuralSplineFlow(device="cpu", **CFG)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jflow)
    load_jax_params(tflow, {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    return jflow, tflow


def test_nll_loss_matches_jax(flows):
    jflow, tflow = flows
    x = _batch(1)
    with torch.no_grad():
        loss = nll_loss(tflow, torch.from_numpy(x))
    np.testing.assert_allclose(float(loss), float(-jnp.mean(jflow.log_prob(x))), atol=1e-4)


def test_three_adam_steps_match_the_jax_train_step(flows):
    jflow, tflow = flows
    opt = optax.adam(1e-2)
    jstate = jax_create_train_state(jflow, opt)
    jstep = jax_make_train_step(opt, donate=False)
    state = create_train_state(copy.deepcopy(tflow), _adam)
    step = make_train_step()
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jmetrics = jstep(jstate, jnp.asarray(batch))
        state, metrics = step(state, torch.from_numpy(batch))
        j_losses.append(float(jmetrics["loss"]))
        t_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    assert state.step == 3 and int(jstate.step) == 3
    trained = jstate.flow.transform.transforms[1].transform_net.final_layer
    ours = state.flow.transform.transforms[1].transform_net.final_layer
    np.testing.assert_allclose(ours.weight.detach().numpy().T, np.asarray(trained.weight),
                               atol=5e-4, rtol=0)
    x = _batch(4)
    with torch.no_grad():
        np.testing.assert_allclose(state.flow.log_prob(torch.from_numpy(x)).numpy(),
                                   np.asarray(jstate.flow.log_prob(x)), atol=5e-3, rtol=0)


@pytest.mark.parametrize("one_kernel", [True, False])
def test_eager_and_fused_routes_agree(flows, one_kernel):
    _, tflow = flows
    state = create_train_state(copy.deepcopy(tflow), _adam)
    eager_step = make_train_step()
    trainer = fused_trainer(copy.deepcopy(tflow), 128)
    optimizer = trainer.init_opt(_adam)
    fused_step = (trainer.make_train_step(optimizer) if one_kernel
                  else _autograd_step(trainer, optimizer))
    for i in range(3):
        batch = torch.from_numpy(_batch(20 + i))
        state, metrics = eager_step(state, batch)
        loss = fused_step(batch)
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), atol=2e-4, rtol=0)
    x = torch.from_numpy(_batch(5))
    with torch.no_grad():
        np.testing.assert_allclose(trainer.to_flow().log_prob(x).numpy(),
                                   state.flow.log_prob(x).numpy(), atol=5e-3, rtol=0)


def test_state_and_step_contract(flows):
    _, tflow = flows
    flow = copy.deepcopy(tflow)
    built = torch.optim.SGD(flow.parameters(), lr=0.1)
    state = create_train_state(flow, built)
    assert isinstance(state, TrainState) and state.optimizer is built
    assert state.flow is flow and state.step == 0
    before = [p.detach().clone() for p in flow.parameters()]
    seen = []

    def loss_fn(f, batch, context):
        seen.append(context)
        return nll_loss(f, batch, context)

    new_state, metrics = make_train_step(loss_fn)(state, torch.from_numpy(_batch(6)))
    assert new_state is state and state.step == 1 and seen == [None]
    assert metrics["loss"].ndim == 0 and not metrics["loss"].requires_grad
    assert any(not torch.equal(a, b) for a, b in zip(before, flow.parameters()))


def test_loss_falls_on_learnable_data(flows):
    """Twenty eager Adam steps on one fixed batch lower its NLL."""
    _, tflow = flows
    state = create_train_state(copy.deepcopy(tflow), _adam)
    step = make_train_step()
    batch = torch.from_numpy(_batch(7))
    losses = []
    for _ in range(20):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.5
