"""Windows of train steps on the CPU: ``training.make_scan_train_step`` (the
eager route) and ``FusedTrainerBase.make_scan_train_step`` (every fused
trainer) against the per-step loop and against the JAX package's windows.

On the CPU a window is a loop of the same step (on the card, a CUDA graph of
it; ``chip_smoke.py`` holds that against the per-step loop), so a window
equals S calls of the step from an identical copy of the state exactly:
losses and every parameter bit for bit. Against the JAX package, after
``load_jax_params`` / ``load_jax_trainer_weights``: losses and final
parameters within 1e-4, the interop bar, with ``torch.optim.Adam`` against
``optax.adam`` (the same defaults, as tests/test_torch_train.py states).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.models import NeuralSplineFlow as JaxNSF
from nflows_tpu.ops.pallas.nsf_train import FusedNSFTrainer as JaxTrainer
from nflows_tpu.training import create_train_state as jax_create_train_state
from nflows_tpu.training import make_scan_train_step as jax_make_scan_train_step
from nflows_tpu_torch import (
    MADEMoG,
    InverseAutoregressiveFlow,
    MaskedAutoregressiveFlow,
    MixtureOfGaussiansMADE,
    NeuralSplineFlow,
    NeuralSplineFlowAR,
    create_train_state,
    fused_trainer,
    load_jax_params,
    load_jax_trainer_weights,
    make_scan_train_step,
    make_train_step,
)
from nflows_tpu_torch.core import _window

torch.set_num_threads(1)

CFG = dict(features=6, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
           num_bins=4, tail_bound=3.0, stacked=False)
S = 4
N = 128


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


def _batches(seed, d, s=S, n=N, scale=1.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(s, n, d)) * scale).astype(np.float32)


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def flows():
    jflow = JaxNSF(key=jax.random.key(0), rng=np.random.default_rng(0), **CFG)
    tflow = NeuralSplineFlow(device="cpu", **CFG)
    load_jax_params(tflow, _jax_params(jflow))
    return jflow, tflow


def _params(module):
    return [p.detach().clone() for p in module.parameters()]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- the eager route ------------------------------------------------------------------


def test_eager_window_equals_the_per_step_loop_exactly(flows):
    _, tflow = flows
    batches = torch.from_numpy(_batches(1, 6))
    state = create_train_state(copy.deepcopy(tflow), _adam)
    state, losses = make_scan_train_step()(state, batches)
    ref = create_train_state(copy.deepcopy(tflow), _adam)
    step = make_train_step()
    ref_losses = []
    for batch in batches:
        ref, metrics = step(ref, batch)
        ref_losses.append(metrics["loss"])
    assert losses.shape == (S,) and losses.dtype == torch.float32
    assert not losses.requires_grad
    assert torch.equal(losses, torch.stack(ref_losses))
    assert state.step == S == ref.step
    _assert_same(_params(state.flow), _params(ref.flow))
    # a second window goes on from where the first ended
    more = torch.from_numpy(_batches(2, 6, s=2))
    state, losses = make_scan_train_step()(state, more)
    for batch, loss in zip(more, losses):
        ref, metrics = step(ref, batch)
        assert torch.equal(loss, metrics["loss"])
    assert state.step == S + 2


def test_eager_window_matches_the_jax_window(flows):
    jflow, tflow = flows
    batches = _batches(3, 6)
    opt = optax.adam(1e-2)
    jstate, jlosses = jax_make_scan_train_step(opt, donate=False)(
        jax_create_train_state(jflow, opt), jnp.asarray(batches))
    state, losses = make_scan_train_step()(create_train_state(copy.deepcopy(tflow), _adam),
                                           torch.from_numpy(batches))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=1e-4, rtol=0)
    assert int(jstate.step) == S == state.step
    trained = _jax_params(jstate.flow)
    ours = dict(state.flow.named_parameters())
    for l in (1, 3, 5):
        net = f"transform.transforms.{l}.transform_net"
        for layer in ("initial_layer", "final_layer", "blocks.1.linear_1"):
            jkey = (f".transform.transforms[{l}].transform_net."
                    + layer.replace("blocks.1", "blocks[1]"))
            np.testing.assert_allclose(ours[f"{net}.{layer}.weight"].detach().numpy().T,
                                       trained[jkey + ".weight"], atol=1e-4, rtol=0)
            np.testing.assert_allclose(ours[f"{net}.{layer}.bias"].detach().numpy(),
                                       trained[jkey + ".bias"], atol=1e-4, rtol=0)


def test_eager_window_contract(flows):
    _, tflow = flows
    state = create_train_state(copy.deepcopy(tflow), _adam)
    steps = make_scan_train_step()
    new_state, losses = steps(state, torch.from_numpy(_batches(4, 6, s=5)))
    assert new_state is state and state.step == 5 and losses.shape == (5,)
    assert steps.window.captured == 0   # a loop here
    with pytest.raises(ValueError, match="each \\[S, ...\\]"):
        steps(state, torch.zeros(0, N, 6))


# -- the fused trainers ---------------------------------------------------------------


def _nsf(context_features=None):
    return NeuralSplineFlow(6, 16, num_layers=2, num_bins=4, context_features=context_features,
                            generator=torch.Generator().manual_seed(1),
                            rng=np.random.default_rng(1), device="cpu")


FUSED = {
    "nsf": (_nsf, 6, None),
    "conditional nsf": (lambda: _nsf(context_features=3), 6, 3),
    "maf": (lambda: MaskedAutoregressiveFlow(5, 16, 2, 2, device="cpu",
                                             generator=torch.Generator().manual_seed(2)),
            5, None),
    "nsf-ar": (lambda: NeuralSplineFlowAR(5, 16, num_layers=2, num_bins=4, device="cpu",
                                          generator=torch.Generator().manual_seed(3)),
               5, None),
    "mog-made": (lambda: MixtureOfGaussiansMADE(5, 16, num_blocks=2, num_mixture_components=3,
                                                rng=np.random.default_rng(4), device="cpu"),
                 5, None),
    "mademog": (lambda: MADEMoG(5, 16, 3, num_mixture_components=3, device="cpu"), 5, 3),
}


@pytest.mark.parametrize("family", sorted(FUSED))
def test_fused_window_equals_the_per_step_loop_exactly(family):
    build, d, cf = FUSED[family]
    model = build()
    a, b = fused_trainer(copy.deepcopy(model), N), fused_trainer(copy.deepcopy(model), N)
    assert type(a).__name__ != "FusedIAFTrainer"
    initial = {k: w.detach().clone() for k, w in a.weights.items()}
    batches = torch.from_numpy(_batches(10, d))
    contexts = None if cf is None else torch.from_numpy(_batches(11, cf, scale=1.0))
    steps = a.make_scan_train_step(a.init_opt(_adam))
    losses = steps(batches) if cf is None else steps(batches, contexts)
    step = b.make_train_step(b.init_opt(_adam))
    ref = [step(batches[i]) if cf is None else step(batches[i], contexts[i]) for i in range(S)]
    assert losses.shape == (S,) and torch.equal(losses, torch.stack(ref))
    for k in a.weights:
        assert torch.equal(a.weights[k], b.weights[k]), k
        assert not torch.equal(a.weights[k], initial[k]), k


def test_fused_window_takes_the_context_as_jax_does():
    cond = fused_trainer(_nsf(context_features=3), N)
    steps = cond.make_scan_train_step(cond.init_opt(_adam))
    with pytest.raises(TypeError):
        steps(torch.zeros(S, N, 6))
    with pytest.raises(ValueError, match="context of shape"):
        steps(torch.zeros(S, N, 6), torch.zeros(S, N, 4))
    uncond = fused_trainer(_nsf(), N)
    steps = uncond.make_scan_train_step(uncond.init_opt(_adam))
    with pytest.raises(ValueError, match="batch of shape"):
        steps(torch.zeros(S, 64, 6))


def test_fused_window_matches_the_jax_fused_window(flows):
    jflow, tflow = flows
    jtr = JaxTrainer(jflow, batch_size=N, interpret=True)
    opt = optax.adam(1e-2)
    batches = _batches(20, 6, s=3)
    weights, _, jlosses = jtr.make_scan_train_step(opt, donate=False)(
        jtr.weights, jtr.init_opt(opt), jnp.asarray(batches))
    ttr = fused_trainer(copy.deepcopy(tflow), N)
    load_jax_trainer_weights(ttr, {k: np.asarray(v) for k, v in jtr.weights.items()})
    losses = ttr.make_scan_train_step(ttr.init_opt(_adam))(torch.from_numpy(batches))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=1e-4, rtol=0)
    for k in ttr.weights:
        np.testing.assert_allclose(ttr.weights[k].detach().numpy(), np.asarray(weights[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_iaf_window_is_refused():
    iaf = fused_trainer(InverseAutoregressiveFlow(5, 16, 2, 1, device="cpu"), N)
    assert type(iaf).__name__ == "FusedIAFTrainer"
    with pytest.raises(NotImplementedError, match="make_vi_train_step"):
        iaf.make_scan_train_step(iaf.init_opt(_adam))


# -- the card's route, refused here -------------------------------------------------


def _counting_step():
    calls = []

    def step(batch):
        calls.append(batch)
        return batch.sum()

    return step, calls


def test_a_cuda_window_raises_without_cuda_rather_than_looping():
    step, calls = _counting_step()
    weight = torch.zeros(3, requires_grad=True)
    capturable = torch.optim.Adam([weight], lr=1e-2, capturable=True)
    window = _window.StepWindow()
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")   # decided at run time, not at import
    with pytest.raises(RuntimeError, match="no CUDA device"):
        window.run(step, (torch.zeros(S, 2),), capturable, torch.device("cuda"))
    assert calls == [] and window.captured == 0


@pytest.mark.parametrize("flags", [{}, {"foreach": True}])
def test_a_cuda_window_refuses_an_optimizer_it_cannot_capture(flags):
    step, calls = _counting_step()
    weight = torch.zeros(3, requires_grad=True)
    optimizer = torch.optim.Adam([weight], lr=1e-2, **flags)
    with pytest.raises(ValueError, match="capturable=True"):
        _window.StepWindow().run(step, (torch.zeros(S, 2),), optimizer, torch.device("cuda"))
    assert calls == []
    _window.check_capturable(torch.optim.Adam([weight], lr=1e-2, capturable=True))
    # on the CPU the window is a loop whatever the optimizer
    losses = _window.StepWindow().run(step, (torch.ones(S, 2),), optimizer,
                                       torch.device("cpu"))
    assert losses.tolist() == [2.0] * S and len(calls) == S


def test_a_changed_setting_recaptures():
    """A captured optimizer step bakes in its scalar settings, so a window
    keys its graph by them; a tensor learning rate is read at each replay."""
    weight = torch.nn.Parameter(torch.zeros(3))
    optimizer = torch.optim.Adam([weight], lr=0.1, capturable=True)
    before = _window._settings(optimizer)
    assert _window._settings(optimizer) == before
    optimizer.param_groups[0]["lr"] = 0.05
    assert _window._settings(optimizer) != before
    lr = torch.tensor(0.1)
    optimizer.param_groups[0]["lr"] = lr
    held = _window._settings(optimizer)
    lr.fill_(0.01)
    assert _window._settings(optimizer) == held


def test_a_graph_is_kept_for_its_optimizer_and_generator():
    """A graph reads the parameters and state of the optimizer it was
    captured with and draws from its generator: another optimizer or
    generator (a seed for each epoch) recaptures in place of it."""
    weight = torch.nn.Parameter(torch.zeros(3))
    optimizer = torch.optim.Adam([weight], lr=0.1, capturable=True)
    generator = torch.Generator().manual_seed(0)
    cap = _window._Captured(None, [], None, optimizer, generator, _window._settings(optimizer))
    assert cap.fits(optimizer, generator, _window._settings(optimizer))
    assert not cap.fits(optimizer, torch.Generator().manual_seed(0),
                        _window._settings(optimizer))
    assert not cap.fits(optimizer, None, _window._settings(optimizer))
    other = torch.optim.Adam([weight], lr=0.1, capturable=True)
    assert not cap.fits(other, generator, _window._settings(other))
