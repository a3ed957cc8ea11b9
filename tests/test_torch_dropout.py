"""Dropout under a generator on the CPU: ``nn.Dropout`` reads the ambient
generator of ``core.stochastic`` as the JAX Dropout reads ``next_rng_key()``;
``make_train_step(generator=)`` and ``make_scan_train_step``'s ``generator``
make it ambient around the loss, the counterparts of the JAX steps' ``key=``.

Exact checks: the identity without a generator or at rate 0, the survivors
scaled by exactly 1/keep, the same losses from the same seed. The zero
fraction lies within 4 sigma of the rate (sigma = sqrt(rate (1 - rate) / n)).
"""

import copy
import math

import jax
import numpy as np
import pytest
import torch

from nflows_tpu.nn.primitives import Dropout as JaxDropout
from nflows_tpu_torch import (
    MaskedAutoregressiveFlow,
    NeuralSplineFlow,
    create_train_state,
    make_scan_train_step,
    make_train_step,
)
from nflows_tpu_torch.core import has_stochastic_context, next_generator, stochastic
from nflows_tpu_torch.nn.primitives import Dropout

torch.set_num_threads(1)


def _x(shape=(64, 32), seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9])
def test_no_generator_is_the_identity_as_in_jax(rate):
    x = _x()
    assert Dropout(rate)(x) is x
    np.testing.assert_array_equal(np.asarray(JaxDropout(rate)(x.numpy())), x.numpy())


def test_rate_zero_is_the_identity_with_a_generator():
    x = _x()
    g = torch.Generator().manual_seed(0)
    assert Dropout(0.0)(x, generator=g) is x
    with stochastic(g):
        assert Dropout(0.0)(x) is x
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("ambient", [False, True])
def test_zero_fraction_and_scaling(rate, ambient):
    x = _x((256, 128)) + 10.0   # no input is zero
    g = torch.Generator().manual_seed(7)
    if ambient:
        with stochastic(g):
            y = Dropout(rate)(x)
    else:
        y = Dropout(rate)(x, generator=g)
    dropped = y == 0
    n = x.numel()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(float(dropped.float().mean()) - rate) < 4 * sigma
    keep = 1.0 - rate
    assert torch.equal(y[~dropped], x[~dropped] / keep)


def test_the_context_nests_and_unwinds():
    a, b = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    assert not has_stochastic_context() and next_generator() is None
    with stochastic(a):
        assert next_generator() is a
        with stochastic(b):
            assert next_generator() is b
        assert next_generator() is a
    assert not has_stochastic_context()
    with pytest.raises(TypeError):
        with stochastic(jax.random.key(0)):
            pass


FLOWS = {
    "coupling (ResidualNet)": lambda: NeuralSplineFlow(
        6, 16, num_layers=2, num_bins=4, dropout_probability=0.5, device="cpu",
        generator=torch.Generator().manual_seed(0), rng=np.random.default_rng(0)),
    "MAF (MADE blocks)": lambda: MaskedAutoregressiveFlow(
        5, 16, 2, 2, dropout_probability=0.5, device="cpu",
        generator=torch.Generator().manual_seed(0)),
}


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_the_ambient_generator_reaches_every_dropout_site(kind):
    flow = FLOWS[kind]()
    sites = [m for m in flow.modules() if isinstance(m, Dropout)]
    assert len(sites) >= 4
    seen = []

    def hook(module, args, output):
        # inputs after a ReLU hold zeros already: a draw zeroes more
        seen.append((module, bool((output == 0).sum() > (args[0] == 0).sum())))

    handles = [m.register_forward_hook(hook) for m in sites]
    x = _x((64, flow.transform.transforms[0].permutation.numel()))
    with torch.no_grad():
        plain = flow.log_prob(x)
        assert {m for m, _ in seen} == set(sites) and not any(d for _, d in seen)
        seen.clear()
        with stochastic(torch.Generator().manual_seed(3)):
            dropped = flow.log_prob(x)
    for h in handles:
        h.remove()
    assert {m for m, _ in seen} == set(sites) and all(d for _, d in seen)
    assert not torch.equal(plain, dropped) and torch.isfinite(dropped).all()


def _losses(flow, seed, steps=3, scan=False, lr=1e-2):
    state = create_train_state(copy.deepcopy(flow),
                               lambda p: torch.optim.Adam(p, lr=lr))
    batch = _x((128, 6), seed=11)
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    if scan:
        return make_scan_train_step()(state, batch.expand(steps, -1, -1).contiguous(),
                                      generator=generator)[1]
    step = make_train_step()
    return torch.stack([step(state, batch, generator=generator)[1]["loss"]
                        for _ in range(steps)])


def test_train_step_generator_is_reproducible_by_seed():
    flow = FLOWS["coupling (ResidualNet)"]()
    a, b, c, none = _losses(flow, 0), _losses(flow, 0), _losses(flow, 1), _losses(flow, None)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, none)
    # without a generator the step is deterministic: evaluation-mode dropout
    assert torch.equal(none, _losses(flow, None))


def test_window_draws_fresh_masks_each_step_and_reproduces_by_seed():
    flow = FLOWS["coupling (ResidualNet)"]()
    # learning rate 0: the weights stay, so the losses differ by the masks alone
    frozen = _losses(flow, 5, steps=4, scan=True, lr=0.0)
    assert len(set(frozen.tolist())) == 4
    assert torch.equal(frozen, _losses(flow, 5, steps=4, scan=True, lr=0.0))
    assert not torch.equal(frozen, _losses(flow, 6, steps=4, scan=True, lr=0.0))
    without = _losses(flow, None, steps=4, scan=True, lr=0.0)
    assert len(set(without.tolist())) == 1
    # the window draws as the per-step loop does
    assert torch.equal(_losses(flow, 5, steps=4, scan=True), _losses(flow, 5, steps=4))
