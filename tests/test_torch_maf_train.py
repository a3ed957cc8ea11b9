"""The fused autoregressive training path on the CPU: the plain version of
kernel B10 (the adjoint derived by hand) against autograd and against the
JAX package, and the port's ``FusedMAFTrainer`` and eager route against the
JAX package's trainers, on the same weights and numpy inputs.

Tolerances. The hand-derived adjoint against autograd over the plain chain
in float64: 1e-10 (the same arithmetic in another order). Against
``jax.grad`` of the JAX trainer's loss in fp32: loss 1e-4 and each gradient
stack 2e-4, the JAX package's own bar for its training kernels against
autodiff (tests/ops/test_maf_train.py). Three Adam steps: losses 2e-4,
weights 5e-4 (same source). ``to_flow()`` round trip 1e-5. Masked entries:
gradient exactly 0.0 and the entry bit-equal after training.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.flows import MaskedAutoregressiveFlow as JaxMAF
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.ops.pallas.maf_train import FusedMAFTrainer as JaxTrainer
from nflows_tpu.training import create_train_state as jax_create_train_state
from nflows_tpu.training import make_train_step as jax_make_train_step
from nflows_tpu_torch import (
    Flow,
    InverseAutoregressiveFlow,
    MaskedAutoregressiveFlow,
    NeuralSplineFlow,
    NeuralSplineFlowAR,
    create_train_state,
    fused_trainer,
    load_jax_params,
    load_jax_trainer_weights,
    make_train_step,
)
from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_fused, maf_train
from nflows_tpu_torch.ops.cuda.nsf_train import FusedNSFTrainer

torch.set_num_threads(1)

KEYS = ("wi", "bi", "wb", "bb", "wf", "bf")
KINDS = {
    "maf": (JaxMAF, MaskedAutoregressiveFlow,
            dict(num_layers=2, num_blocks_per_layer=2, use_random_permutations=True)),
    "nsf_ar": (JaxNSFAR, NeuralSplineFlowAR,
               dict(num_layers=2, num_blocks_per_layer=1, num_bins=4, tail_bound=3.0)),
}


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(kind, features=5, seed=0):
    jcls, tcls, kw = KINDS[kind]
    kw = dict(features=features, hidden_features=32, **kw)
    jflow = jcls(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
    tflow = tcls(device="cpu", rng=np.random.default_rng(seed + 100), **kw)
    load_jax_params(tflow, _jax_params(jflow))
    return jflow, tflow


def _batch(seed, n=128, d=5, scale=1.5):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


@pytest.fixture(scope="module", params=sorted(KINDS))
def both(request):
    """(kind, JAX flow, port flow, JAX trainer, port trainer) on one model."""
    jflow, tflow = _pair(request.param)
    return (request.param, jflow, tflow, JaxTrainer(jflow, batch_size=128, interpret=True),
            maf_train.FusedMAFTrainer(tflow, batch_size=128))


def _folded(trainer, dtype=torch.float32):
    return {k: v.detach().to(dtype).contiguous()
            for k, v in trainer._fold(trainer.weights).items()}


@pytest.mark.parametrize("features", [5, 6])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bwd_plain_matches_autograd_in_float64(kind, features):
    _, tflow = _pair(kind, features, seed=features)
    tr = maf_train.FusedMAFTrainer(tflow, batch_size=128)
    w = _folded(tr, torch.float64)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(77, features)) * 1.5)
    gy = torch.from_numpy(rng.normal(size=(77, features)))
    glad = torch.from_numpy(rng.normal(size=(77,)))
    kw = dict(wh_scale=tr._wh_scale, **tr._static)
    gx, grads = maf_train.maf_train_bwd_plain(x, gy, glad, w, tr._layers, **kw)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    xl = x.clone().requires_grad_(True)
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(xl, leaves, tr._layers, inverse=False, **kw)
    want = torch.autograd.grad((y, lad), [xl] + [leaves[k] for k in KEYS], (gy, glad))
    _close(gx, want[0], 1e-10)
    for k, g in zip(KEYS, want[1:]):
        assert grads[k].shape == w[k].shape and grads[k].dtype == torch.float64
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-10, rtol=0, err_msg=k)
    # the kernel's gradients are dense: masked entries do get one before the fold's chain rule
    assert grads["wb"][tr._masks["wb"] == 0].abs().max() > 0


def test_trainer_weights_are_the_jax_trainers(both):
    _, _, _, jtr, ttr = both
    assert sorted(ttr.weights) == sorted(jtr.weights) == sorted(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(ttr.weights[k].detach().numpy(), np.asarray(jtr.weights[k]))
    for k in maf_train.MASKED_KEYS:
        np.testing.assert_array_equal(ttr._masks[k].numpy(), np.asarray(jtr._masks[k]))
    assert ttr._static["transformer"] == jtr._transformer
    assert tuple(ttr._layers) == tuple(jtr._static)


def test_bwd_plain_matches_jax_grad_including_gx(both):
    kind, _, _, jtr, ttr = both
    x = _batch(3)
    j_loss, (j_gw, j_gx_t) = jax.value_and_grad(jtr.loss_fn, argnums=(0, 1))(
        jtr.weights, jnp.asarray(x.T))
    xt = torch.from_numpy(x)
    n = x.shape[0]
    folded = _folded(ttr)
    kw = dict(wh_scale=ttr._wh_scale, **ttr._static)
    with torch.no_grad():
        y, lad = maf_flow_kernel.maf_flow_kernel_cuda(xt, folded, ttr._layers, inverse=False, **kw)
    loss = -(-0.5 * (y * y).sum(dim=1) - 0.5 * 5 * np.log(2 * np.pi) + lad).mean()
    _close(loss, j_loss, 1e-4)
    before = maf_train.bwd_launch_count
    gx, grads = maf_train.maf_train_bwd_cuda(
        xt, y / n, torch.full((n,), -1.0 / n), folded, ttr._layers, **kw)
    assert maf_train.bwd_launch_count == before          # the plain version launches nothing
    _close(gx, np.asarray(j_gx_t).T, 2e-4)
    for k in KEYS:
        g = grads[k] * ttr._masks[k] if k in ttr._masks else grads[k]   # the fold's chain rule
        np.testing.assert_allclose(g.numpy(), np.asarray(j_gw[k]), atol=2e-4, rtol=0, err_msg=k)


def test_trainer_loss_and_gradients_match_jax(both):
    """``loss_fn`` through the fold and the differentiable apply (B9 forward,
    B10 backward on the card; their plain versions here)."""
    _, _, tflow, jtr, ttr = both
    x = _batch(4)
    j_loss, j_gw = jax.value_and_grad(jtr.loss_fn)(jtr.weights, jnp.asarray(x.T))
    loss, grads = ttr._value_and_grad()(ttr.weights, torch.from_numpy(x))
    _close(loss, j_loss, 1e-4)
    with torch.no_grad():
        _close(loss, -tflow.log_prob(torch.from_numpy(x)).mean(), 1e-5)
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_gw[k]), atol=2e-4,
                                   rtol=0, err_msg=k)
    for k in maf_train.MASKED_KEYS:
        dead = ttr._masks[k] == 0
        assert dead.any() and not grads[k][dead].any()      # exactly 0.0
        assert not np.asarray(j_gw[k])[dead.numpy()].any()


def test_three_adam_steps_match_the_jax_trainer(both):
    kind, jflow, tflow, _, _ = both
    jtr = JaxTrainer(jflow, batch_size=128, interpret=True)
    opt = optax.adam(1e-2)
    jstep = jtr.make_train_step(opt, donate=False)
    weights, opt_state = jtr.weights, jtr.init_opt(opt)

    ttr = fused_trainer(tflow, 128)
    assert isinstance(ttr, maf_train.FusedMAFTrainer)
    load_jax_trainer_weights(ttr, {k: np.asarray(v) for k, v in jtr.weights.items()})
    start = {k: v.detach().clone() for k, v in ttr.weights.items()}
    tstep = ttr.make_train_step(ttr.init_opt(_adam))
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
    for k in maf_train.MASKED_KEYS:
        dead = ttr._masks[k] == 0
        assert torch.equal(ttr.weights[k].detach()[dead], start[k][dead])       # bit-equal
        assert not torch.equal(ttr.weights[k].detach()[~dead], start[k][~dead])


def test_three_adam_steps_of_the_eager_route_match_jax(both):
    kind, jflow, tflow, _, _ = both
    opt = optax.adam(1e-2)
    jstate = jax_create_train_state(jflow, opt)
    jstep = jax_make_train_step(opt, donate=False)
    state = create_train_state(copy.deepcopy(tflow).train(), _adam)
    step = make_train_step()
    fused = fused_trainer(copy.deepcopy(tflow), 128)
    fused_step = fused.make_train_step(fused.init_opt(_adam))
    masks = {name: buf.clone() for name, buf in state.flow.named_buffers() if "mask" in name}
    j_losses, t_losses, f_losses = [], [], []
    for i in range(3):
        batch = _batch(20 + i)
        jstate, metrics = jstep(jstate, jnp.asarray(batch))
        j_losses.append(float(metrics["loss"]))
        state, tmetrics = step(state, torch.from_numpy(batch))
        t_losses.append(float(tmetrics["loss"]))
        f_losses.append(float(fused_step(torch.from_numpy(batch))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    np.testing.assert_allclose(f_losses, t_losses, atol=2e-4, rtol=0)
    assert state.step == 3 and masks
    for name, buf in state.flow.named_buffers():
        if name in masks:
            assert torch.equal(buf, masks[name])
    # the two routes of the port end at the same model
    x = torch.from_numpy(_batch(30))
    with torch.no_grad():
        _close(fused.to_flow().log_prob(x), state.flow.log_prob(x), 5e-3)


def test_masked_entries_do_not_move_in_twenty_steps():
    _, tflow = _pair("maf")
    ttr = fused_trainer(tflow, 128)
    start = {k: v.detach().clone() for k, v in ttr.weights.items()}
    step = ttr.make_train_step(ttr.init_opt(_adam))
    losses = [float(step(torch.from_numpy(_batch(40 + i % 4)))) for i in range(20)]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    for k in maf_train.MASKED_KEYS:
        dead = ttr._masks[k] == 0
        assert torch.equal(ttr.weights[k].grad[dead], torch.zeros(int(dead.sum())))
        assert torch.equal(ttr.weights[k].detach()[dead], start[k][dead])
    # so the trained flow is still autoregressive: its first output ignores later inputs
    trained = ttr.to_flow()
    x = torch.from_numpy(_batch(50, n=1))[0]
    made = list(trained.transform.transforms)[1].autoregressive_net
    jac = torch.autograd.functional.jacobian(lambda v: made(v[None])[0], x)
    for k in range(5):
        assert not jac[2 * k:2 * k + 2, k:].any()


def test_to_flow_round_trip_and_after_training(both):
    _, _, tflow, _, _ = both
    ttr = fused_trainer(tflow, 128)
    x = torch.from_numpy(_batch(5))
    rebuilt = ttr.to_flow()
    assert rebuilt is not tflow
    with torch.no_grad():
        _close(rebuilt.log_prob(x), tflow.log_prob(x), 1e-5)
    for a, b in zip(rebuilt.state_dict().values(), tflow.state_dict().values()):
        assert torch.equal(a, b)                             # a pure re-laying
    step = ttr.make_train_step(ttr.init_opt(_adam))
    step(x)
    with torch.no_grad():
        trained = ttr.to_flow().log_prob(x)
        assert (trained - tflow.log_prob(x)).abs().max() > 1e-3   # the template is untouched
        _close(-trained.mean(), ttr.loss_fn(ttr.weights, x).detach(), 1e-5)
    served = maf_fused.fuse_maf(ttr.to_flow())
    with torch.no_grad():
        _close(served.log_prob(x), trained, 1e-4)


def test_load_jax_trainer_weights_takes_the_maf_stacks(both):
    _, _, tflow, jtr, _ = both
    ttr = maf_train.FusedMAFTrainer(copy.deepcopy(tflow), 128)
    good = {k: np.asarray(v) * 0.5 for k, v in jtr.weights.items()}
    load_jax_trainer_weights(ttr, good)
    np.testing.assert_array_equal(ttr.weights["wf"].detach().numpy(), good["wf"])
    with pytest.raises(KeyError, match="missing"):
        load_jax_trainer_weights(ttr, {k: v for k, v in good.items() if k != "wi"})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_trainer_weights(ttr, {**good, "w0": good["wi"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_trainer_weights(ttr, {**good, "wb": good["wb"][:32]})


def test_refusals():
    iaf = InverseAutoregressiveFlow(5, 16, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="InverseTransform-wrapped"):
        maf_train.FusedMAFTrainer(iaf, batch_size=128)
    with pytest.raises(ValueError, match="InverseTransform-wrapped"):
        JaxTrainer(jax_iaf(), batch_size=128, interpret=True)
    maf = MaskedAutoregressiveFlow(5, 16, 2, 1, device="cpu")
    embedded = Flow(maf.transform, maf.distribution, embedding_net=torch.nn.Linear(3, 3))
    with pytest.raises(ValueError, match="embedding_net"):
        maf_train.FusedMAFTrainer(embedded, batch_size=128)
    conditional = NeuralSplineFlowAR(5, 16, num_layers=2, num_bins=4, context_features=3,
                                     device="cpu")
    with pytest.raises(ValueError, match="conditional flows are not fused"):
        maf_train.FusedMAFTrainer(conditional, batch_size=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        maf_train.FusedMAFTrainer(maf, batch_size=100)
    ttr = maf_train.FusedMAFTrainer(maf, batch_size=128)
    with pytest.raises(ValueError, match="unconditional"):
        ttr.loss_fn(ttr.weights, torch.zeros(128, 5), context=torch.zeros(128, 3))
    wrapped = maf_fused._extract(iaf, torch.float32)
    with pytest.raises(ValueError, match="InverseTransform-wrapped"):
        maf_train.maf_train_bwd_cuda(
            torch.zeros(8, 5), torch.zeros(8, 5), torch.zeros(8), wrapped[1], wrapped[0],
            num_blocks=wrapped[2], transformer="affine")
    with pytest.raises(ValueError, match="wh_scale"):
        maf_train.maf_train_apply(ttr._fold(ttr.weights), torch.zeros(8, 5), ttr._layers,
                                  ttr._static, wh_scale=0.25)


def jax_iaf():
    from nflows_tpu.models import InverseAutoregressiveFlow as JaxIAF

    return JaxIAF(features=5, hidden_features=16, num_layers=2, num_blocks_per_layer=1,
                  key=jax.random.key(0))


def test_fused_trainer_probes_nsf_then_maf():
    maf = MaskedAutoregressiveFlow(5, 16, 2, 1, device="cpu")
    nsf = NeuralSplineFlow(6, 16, num_layers=2, num_bins=4, device="cpu")
    assert isinstance(fused_trainer(maf, 128), maf_train.FusedMAFTrainer)
    assert isinstance(fused_trainer(nsf, 128), FusedNSFTrainer)
    iaf = InverseAutoregressiveFlow(5, 16, 2, 1, device="cpu")
    with pytest.raises(ValueError) as err:
        fused_trainer(iaf, 128)
    text = str(err.value)
    assert "no fused training kernel" in text and "eager route" in text
    assert "FusedNSFTrainer: " in text and "FusedMAFTrainer: InverseTransform-wrapped" in text
    assert text.index("FusedNSFTrainer") < text.index("FusedMAFTrainer")
    assert fused_trainer(iaf, 128, required=False) is None
    assert fused_trainer(iaf, 128, auto=True) is None
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_trainer(maf, 100)


def test_auto_uses_the_measured_floor_of_each_family(monkeypatch):
    from nflows_tpu_torch.training import fused

    maf = MaskedAutoregressiveFlow(5, 16, 2, 1, device="cpu")
    nsf = NeuralSplineFlow(6, 16, num_layers=2, num_bins=4, device="cpu")
    assert set(fused.MIN_AUTO_BATCH) == {"nsf", "maf", "mademog"}
    floor = fused.MIN_AUTO_BATCH["maf"]
    assert floor is None or (isinstance(floor, int) and floor % 128 == 0)
    monkeypatch.setitem(fused.MIN_AUTO_BATCH, "maf", 1024)
    assert fused_trainer(maf, 512, auto=True) is None
    assert fused_trainer(maf, 1024, auto=True) is not None
    assert fused_trainer(maf, 512) is not None               # the floor only binds with auto
    assert fused_trainer(nsf, 512, auto=True) is not None    # each family has its own
    monkeypatch.setitem(fused.MIN_AUTO_BATCH, "maf", None)
    assert fused_trainer(maf, 4096, auto=True) is None


def test_tile_choice_is_by_shared_memory_and_sm_count():
    full = dict(D=10, L=5, H=256, P=20)
    rq = dict(full, P=230)
    assert maf_train.shared_memory_bytes(32, 10, 5, 256, 230) <= 232448
    assert maf_train.shared_memory_bytes(64, 10, 5, 256, 20) > 232448
    assert maf_train.tile_rows(65536, full, sms=132) == 32
    assert maf_train.tile_rows(65536, rq, sms=132) == 32
    assert maf_train.tile_rows(65536, dict(full, H=64), sms=132) == 64
    assert maf_train.tile_rows(4096, dict(full, H=64), sms=132) == 32    # 64 tiles would idle SMs
    assert maf_train.tile_rows(4096, dict(full, H=1024), sms=132) == 0
