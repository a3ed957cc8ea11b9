"""The fused training path on the CPU: the port's plain versions of kernels
B3 and B4 and its ``FusedNSFTrainer`` against the JAX package's training
kernels in interpret mode, on the same weights and numpy inputs.

Tolerances. Extracted arrays are copies and transposes: exact. The unfolded
chain with ``wh_scale`` against the folded one: 2e-5 (one multiplication
moved from the weights to the conditioner's output; through three layers
that is a few fp32 ulps of values up to the tail bound 3, measured 1.2e-6
on the outputs and 7.2e-6 on the inverse's logabsdet, a log of ratios).
Loss 1e-4 and each gradient stack 2e-4, the JAX package's own bar
for its training kernels against autodiff
(tests/ops/test_nsf_train.py). Three Adam steps: losses 2e-4, weights 5e-4
(same source). ``to_flow()`` round trip 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.models import NeuralSplineFlow as JaxNSF
from nflows_tpu.ops.pallas import nsf_fused as jax_fused
from nflows_tpu.ops.pallas.nsf_train import FusedNSFTrainer as JaxTrainer
from nflows_tpu.ops.pallas.nsf_train import nsf_loss_grad_call
from nflows_tpu_torch import (
    NeuralSplineFlow,
    fused_trainer,
    load_jax_params,
    load_jax_trainer_weights,
)
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel, nsf_fused, nsf_train

torch.set_num_threads(1)

CFG = dict(features=6, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
           num_bins=4, tail_bound=3.0, stacked=False)
KEYS = ("w0", "b0", "wb", "bb", "wf", "bf")


def _jax_params(jflow):
    """Numpy leaves of a JAX flow keyed by pytree path. A scan-stacked
    chain is unstacked first: layer i's [permutation, coupling] become
    transforms 2i and 2i+1."""
    from nflows_tpu.transforms.stacked import StackedTransform

    if not isinstance(jflow.transform, StackedTransform):
        leaves, _ = jax.tree_util.tree_flatten_with_path(jflow)
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}
    params = {}
    for i, group in enumerate(jflow.transform.layers()):
        for j, t in enumerate(group.transforms):
            leaves, _ = jax.tree_util.tree_flatten_with_path(t)
            for p, v in leaves:
                key = f".transform.transforms[{2 * i + j}]{jax.tree_util.keystr(p)}"
                params[key] = np.asarray(v)
    return params


def _pair(seed=0, **overrides):
    """The same NSF in both packages: built in JAX, weights carried over."""
    cfg = {**CFG, **overrides}
    jflow = JaxNSF(key=jax.random.key(seed), rng=np.random.default_rng(seed), **cfg)
    tflow = NeuralSplineFlow(device="cpu", **cfg)
    load_jax_params(tflow, _jax_params(jflow))
    return jflow, tflow


def _batch(seed, n=128, d=6, scale=1.5):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def flows():
    return _pair()


@pytest.fixture(scope="module")
def trainers(flows):
    jflow, tflow = flows
    return (JaxTrainer(jflow, batch_size=128, interpret=True),
            nsf_train.FusedNSFTrainer(tflow, batch_size=128))


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


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("features", [6, 5])
def test_unfolded_extract_matches_jax(features):
    jflow, tflow = _pair(seed=features, features=features,
                         stacked=False if features == 6 else None)
    j_idx, j_w, _, _, _ = jax_fused._extract(jflow, jnp.float32, fold_wh_scale=False)
    t_idx, t_w, _, _, _ = nsf_fused._extract(tflow, torch.float32, fold_wh_scale=False)
    assert [tuple(i) for i in t_idx] == [tuple(i) for i in j_idx]
    assert sorted(t_w) == sorted(j_w)
    for name in j_w:
        np.testing.assert_array_equal(t_w[name].numpy(), np.asarray(j_w[name]))


def test_unfolded_weights_are_permutations_of_the_models(flows):
    """Without the fold every final-layer row is a row of the model's own
    final layer: the set of values is the same."""
    _, tflow = flows
    _, w, _, _, _ = nsf_fused._extract(tflow, torch.float32, fold_wh_scale=False)
    final = tflow.transform.transforms[1].transform_net.final_layer
    assert torch.equal(w["wf"][0].sort(dim=0).values, final.weight.detach().sort(dim=0).values)
    assert torch.equal(w["bf"][0, :, 0].sort().values, final.bias.detach().sort().values)


@pytest.mark.parametrize("inverse", [False, True])
def test_wh_scale_equals_the_folded_weights(flows, inverse):
    _, tflow = flows
    idx, folded, static, _, _ = nsf_fused._extract(tflow, torch.float32)
    _, unfolded, _, _, _ = nsf_fused._extract(tflow, torch.float32, fold_wh_scale=False)
    x = torch.from_numpy(_batch(1, n=70))
    y, lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, folded, idx, inverse=inverse, **static)
    y_s, lad_s = nsf_flow_kernel.nsf_flow_kernel_cuda(
        x, unfolded, idx, inverse=inverse, wh_scale=1.0 / np.sqrt(32.0), **static)
    _close(y_s, y, 2e-5)
    _close(lad_s, lad, 2e-5)
    assert not torch.equal(unfolded["wf"], folded["wf"])


@pytest.mark.parametrize("n", [128, 256])
def test_loss_grad_plain_matches_jax_kernel(trainers, n):
    jtr, ttr = trainers
    x = _batch(2, n=n)
    loss_and_grad = nsf_loss_grad_call(jtr._indices, jtr._static, 128, True)
    j_loss, j_grads = loss_and_grad(jtr.weights, jnp.asarray(x.T))
    before = nsf_train.loss_grad_launch_count
    loss, lp, grads = nsf_train.nsf_loss_grad_cuda(
        torch.from_numpy(x), ttr.weights, ttr._indices, wh_scale=ttr._wh_scale, **ttr._static)
    assert nsf_train.loss_grad_launch_count == before    # the plain version launches nothing
    assert lp.shape == (n,)
    _close(loss, j_loss, 1e-4)
    _close(-lp.mean(), j_loss, 1e-4)
    for k in KEYS:
        assert grads[k].shape == ttr.weights[k].shape
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_grads[k]), atol=2e-4,
                                   rtol=0, err_msg=k)


def test_bwd_plain_matches_jax_grad_including_gx(trainers):
    jtr, ttr = trainers
    x = _batch(3)
    j_gw, j_gx_t = jax.grad(jtr.loss_fn, argnums=(0, 1))(jtr.weights, jnp.asarray(x.T))
    xt = torch.from_numpy(x)
    n = x.shape[0]
    with torch.no_grad():
        y, _ = nsf_train.nsf_train_apply(ttr.weights, xt, ttr._indices, ttr._static,
                                         ttr._wh_scale)
    before = nsf_train.bwd_launch_count
    gx, grads = nsf_train.nsf_train_bwd_cuda(
        xt, y / n, torch.full((n,), -1.0 / n), ttr.weights, ttr._indices,
        wh_scale=ttr._wh_scale, **ttr._static)
    assert nsf_train.bwd_launch_count == before
    _close(gx, np.asarray(j_gx_t).T, 2e-4)
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_gw[k]), atol=2e-4,
                                   rtol=0, err_msg=k)


def test_trainer_loss_and_autograd_route_match_jax(trainers, monkeypatch):
    """``loss_fn`` through the differentiable apply (B2 forward, B4 backward
    on the card; the plain chain under autograd here), which is also what
    ``_value_and_grad`` falls back to without a one-kernel route."""
    jtr, ttr = trainers
    x = _batch(4)
    j_loss, j_gw = jax.value_and_grad(jtr.loss_fn)(jtr.weights, jnp.asarray(x.T))
    with monkeypatch.context() as m:
        m.setattr(ttr, "_build_loss_grad", lambda: None)
        loss, grads = ttr._value_and_grad()(ttr.weights, torch.from_numpy(x))
    _close(loss, j_loss, 1e-4)
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_gw[k]), atol=2e-4,
                                   rtol=0, err_msg=k)
    one_loss, one_grads = ttr._value_and_grad()(ttr.weights, torch.from_numpy(x))
    _close(one_loss, loss, 1e-6)
    for k in KEYS:
        _close(one_grads[k], grads[k], 1e-6)


@pytest.mark.parametrize("one_kernel", [True, False])
def test_three_adam_steps_match_the_jax_trainer(flows, one_kernel):
    jflow, tflow = flows
    jtr = JaxTrainer(jflow, batch_size=128, interpret=True)
    opt = optax.adam(1e-2)
    jstep = jtr.make_train_step(opt, donate=False)
    weights, opt_state = jtr.weights, jtr.init_opt(opt)

    ttr = fused_trainer(tflow, 128)
    load_jax_trainer_weights(ttr, {k: np.asarray(v) for k, v in jtr.weights.items()})
    optimizer = ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2))
    tstep = (ttr.make_train_step(optimizer) if one_kernel
             else _autograd_step(ttr, optimizer))
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _batch(10 + i)
        weights, opt_state, loss = jstep(weights, opt_state, jnp.asarray(batch))
        j_losses.append(float(loss))
        t_losses.append(float(tstep(torch.from_numpy(batch))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    for k in KEYS:
        np.testing.assert_allclose(ttr.weights[k].detach().numpy(), np.asarray(weights[k]),
                                   atol=5e-4, rtol=0, err_msg=k)


def test_loop_step_follows_the_train_step_contract(flows):
    _, tflow = flows
    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    a, b = fused_trainer(tflow, 128), fused_trainer(tflow, 128)
    step = a.make_train_step(a.init_opt(adam))
    state, loop_step = b.init_loop_state(adam), b.make_loop_step()
    for i in range(2):
        batch = torch.from_numpy(_batch(20 + i))
        loss = step(batch)
        state, metrics = loop_step(state, batch)
        assert float(metrics["loss"]) == float(loss)
    assert state.step == 2 and state.params is b.weights
    with pytest.raises(AttributeError):
        state.flow


def test_to_flow_round_trip_and_after_training(flows):
    _, tflow = flows
    ttr = fused_trainer(tflow, 128)
    x = torch.from_numpy(_batch(5))
    rebuilt = ttr.to_flow()
    assert rebuilt is not tflow
    with torch.no_grad():
        _close(rebuilt.log_prob(x), tflow.log_prob(x), 1e-5)
    step = ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)))
    step(x)
    with torch.no_grad():
        trained = ttr.to_flow().log_prob(x)
        assert (trained - tflow.log_prob(x)).abs().max() > 1e-3   # the template is untouched
        _close(-trained.mean(), ttr.loss_fn(ttr.weights, x).detach(), 1e-5)


def test_load_jax_trainer_weights_refuses_bad_dicts(trainers):
    jtr, ttr = trainers
    good = {k: np.asarray(v) for k, v in jtr.weights.items()}
    with pytest.raises(KeyError, match="missing"):
        load_jax_trainer_weights(ttr, {k: v for k, v in good.items() if k != "wf"})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_trainer_weights(ttr, {**good, "wc0": good["w0"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_trainer_weights(ttr, {**good, "wb": good["wb"][:, :2]})


def test_guards(flows):
    jflow, tflow = flows
    ttr = fused_trainer(tflow, 128)
    x = torch.from_numpy(_batch(6))
    with pytest.raises(ValueError, match="unconditional"):
        ttr.loss_fn(ttr.weights, x, context=torch.zeros(128, 3))
    step = ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.SGD(p, lr=0.1)))
    with pytest.raises(ValueError, match="unconditional"):
        step(x, torch.zeros(128, 3))
    with pytest.raises(ValueError, match="shape"):
        step(x[:64])
    # the same call raises the same way in both packages
    for build in (lambda: fused_trainer(tflow, 100),
                  lambda: nsf_train.FusedNSFTrainer(tflow, batch_size=100),
                  lambda: JaxTrainer(jflow, batch_size=100, interpret=True)):
        with pytest.raises(ValueError, match="multiple of 128"):
            build()


def test_flows_that_do_not_qualify():
    conditional = NeuralSplineFlow(6, 16, num_layers=2, num_bins=4, context_features=3,
                                   device="cpu")
    with pytest.raises(ValueError, match="conditional flows are not fused"):
        fused_trainer(conditional, 128)
    assert fused_trainer(conditional, 128, required=False) is None
    assert fused_trainer(conditional, 128, auto=True) is None
    with pytest.raises(ValueError, match="no fused training kernel"):
        fused_trainer(conditional, 128, auto=True, required=True)


def test_auto_uses_the_measured_floor(flows, monkeypatch):
    from nflows_tpu_torch.training import fused

    _, tflow = flows
    assert fused_trainer(tflow, 128, auto=True) is not None
    monkeypatch.setitem(fused.MIN_AUTO_BATCH, "nsf", 1024)
    assert fused_trainer(tflow, 512, auto=True) is None
    assert fused_trainer(tflow, 1024, auto=True) is not None
    assert fused_trainer(tflow, 512) is not None        # the floor only binds with auto
    monkeypatch.setitem(fused.MIN_AUTO_BATCH, "nsf", None)
    assert fused_trainer(tflow, 4096, auto=True) is None


def test_tile_choice_is_by_shared_memory_and_sm_count():
    flagship = dict(D=6, L=10, H=256, Tid=3, T=3, TM=69)
    narrow = dict(flagship, H=64)
    assert nsf_train.shared_memory_bytes(32, 6, 10, 256, 3, 3, 69) <= 232448
    assert nsf_train.shared_memory_bytes(64, 6, 10, 256, 3, 3, 69) > 232448
    assert nsf_train.tile_rows(65536, flagship, sms=132) == 32
    assert nsf_train.tile_rows(65536, narrow, sms=132) == 64
    assert nsf_train.tile_rows(4096, narrow, sms=132) == 32     # 64 tiles would idle SMs
    assert nsf_train.tile_rows(4096, dict(flagship, H=1024), sms=132) == 0
