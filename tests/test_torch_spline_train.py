"""Fused training of the linear-rational, linear, quadratic and cubic coupling
flows on the CPU: ``FusedNSFTrainer`` against the JAX package's fused trainer
(its training kernel in interpret mode) for three Adam steps after
``load_jax_trainer_weights``; ``to_flow()``; and what the training kernels'
launcher is handed for these families' stages. On a CPU tensor the trainer
runs the plain versions of B3 and B4 (autograd over the plain chain); the
kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py). The plain B3 and B4 against ``jax.grad`` of the JAX chain
are in tests/test_torch_realnvp.py.

Tolerances (tests/ops/test_nsf_train.py): three Adam steps 2e-4 on the
losses and 5e-4 on the weights; ``to_flow()`` round trip 1e-5.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.distributions import StandardNormal as JaxStandardNormal
from nflows_tpu.flows.base import Flow as JaxFlow
from nflows_tpu.models import NeuralSplineFlow as JaxNSF
from nflows_tpu.nn import nets as jax_nets
from nflows_tpu.ops.pallas.nsf_train import FusedNSFTrainer as JaxTrainer
from nflows_tpu.transforms import coupling as jax_coupling
from nflows_tpu.transforms.base import CompositeTransform as JaxComposite
from nflows_tpu.transforms.permutations import Permutation as JaxPermutation
from nflows_tpu_torch import (
    Flow,
    NeuralSplineFlow,
    fused_trainer,
    load_jax_params,
    load_jax_trainer_weights,
)
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.ops.cuda import _build, nsf_flow_kernel, nsf_train
from nflows_tpu_torch.ops.cuda.rq_spline import _edge_derivative
from nflows_tpu_torch.transforms import (
    CompositeTransform,
    Permutation,
    PiecewiseCubicCouplingTransform,
    PiecewiseLinearCouplingTransform,
    PiecewiseQuadraticCouplingTransform,
)

torch.set_num_threads(1)

B = 3.0
HIDDEN = 32
KEYS = nsf_train.WEIGHT_KEYS
COUPLINGS = {
    "linear": (jax_coupling.PiecewiseLinearCouplingTransform,
               PiecewiseLinearCouplingTransform),
    "quadratic": (jax_coupling.PiecewiseQuadraticCouplingTransform,
                  PiecewiseQuadraticCouplingTransform),
    "cubic": (jax_coupling.PiecewiseCubicCouplingTransform,
              PiecewiseCubicCouplingTransform),
}
FAMILIES = ["cubic", "linear", "lrs", "quadratic"]


def _load(jax_module, module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax_module)
    load_jax_params(module, {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    return module


def _flow_pair(family, features=6, layers=2, bins=8, seed=0):
    """``layers`` x [random permutation, coupling of the family with linear
    tails and a 2-block ResidualNet of width HIDDEN], alternating masks, in
    both packages with the same weights; the LRS family is
    NeuralSplineFlow's own."""
    if family == "lrs":
        cfg = dict(features=features, hidden_features=HIDDEN, num_layers=layers,
                   num_bins=bins, tail_bound=B, spline="lrs", stacked=False)
        jflow = JaxNSF(key=jax.random.key(seed), rng=np.random.default_rng(seed), **cfg)
        return jflow, _load(jflow, NeuralSplineFlow(device="cpu", **cfg))
    jcls, tcls = COUPLINGS[family]
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed), layers)
    mask = np.ones(features, dtype=np.float32)
    mask[::2] = -1
    jchain, tchain = [], []
    for i in range(layers):
        perm = rng.permutation(features)
        kw = dict(mask=mask, num_bins=bins, tails="linear", tail_bound=B)
        jnet = lambda n_in, n_out, key=keys[i]: jax_nets.ResidualNet(  # noqa: E731
            n_in, n_out, hidden_features=HIDDEN, num_blocks=2, key=key)
        tnet = lambda n_in, n_out: nets.ResidualNet(  # noqa: E731
            n_in, n_out, hidden_features=HIDDEN, num_blocks=2, device="cpu")
        jchain += [JaxPermutation(perm), jcls(transform_net_create_fn=jnet, **kw)]
        tchain += [Permutation(perm, device="cpu"), tcls(transform_net_create_fn=tnet,
                                                          device="cpu", **kw)]
        mask = -mask
    jflow = JaxFlow(transform=JaxComposite(jchain), distribution=JaxStandardNormal([features]))
    tflow = Flow(transform=CompositeTransform(tchain), distribution=StandardNormal([features]))
    return jflow, _load(jflow, tflow)


def _x(n=128, seed=1, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal((n, 6))).astype(np.float32)


@pytest.mark.parametrize("family", ["cubic", "lrs"])
def test_three_adam_steps_match_the_jax_trainer(family):
    jflow, tflow = _flow_pair(family)
    jtr = JaxTrainer(jflow, batch_size=128, interpret=True)
    opt = optax.adam(1e-2)
    jstep = jtr.make_train_step(opt, donate=False)
    weights, opt_state = jtr.weights, jtr.init_opt(opt)
    ttr = fused_trainer(tflow, 128)
    assert isinstance(ttr, nsf_train.FusedNSFTrainer) and ttr._static["spline"] == family
    load_jax_trainer_weights(ttr, {k: np.asarray(v) for k, v in jtr.weights.items()})
    tstep = ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)))
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _x(seed=20 + i)
        weights, opt_state, loss = jstep(weights, opt_state, jnp.asarray(batch))
        j_losses.append(float(loss))
        t_losses.append(float(tstep(torch.from_numpy(batch))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    assert t_losses[-1] < t_losses[0]
    for k in KEYS:
        np.testing.assert_allclose(ttr.weights[k].detach().numpy(), np.asarray(weights[k]),
                                   atol=5e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_to_flow_round_trip(family):
    """The trainer's weights map back into the flow: log_prob of
    ``to_flow()`` is the flow's before a step and the trainer's own loss
    after one."""
    _, tflow = _flow_pair(family, seed=2)
    ttr = fused_trainer(tflow, 128)
    x = torch.from_numpy(_x(seed=12))
    with torch.no_grad():
        torch.testing.assert_close(ttr.to_flow().log_prob(x), tflow.log_prob(x), atol=1e-5,
                                   rtol=0)
    ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)))(x)
    with torch.no_grad():
        trained = ttr.to_flow().log_prob(x)
        assert (trained - tflow.log_prob(x)).abs().max() > 1e-3
        torch.testing.assert_close(-trained.mean(), ttr.loss_fn(ttr.weights, x), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_the_launcher_gets_every_stage_setting(monkeypatch, family):
    """B3 and B4 run the stage B2 runs, so their launcher is handed the same
    seven floats (``nsf_flow_kernel.stage_floats``): a non-default
    ``min_lambda`` for the LRS (a launcher that dropped it would run
    lambda's floor at 0), the boundary slope of its padded derivatives, and
    log(1/K) for the linear spline. The launch is caught
    before the library: the wrapper's kernel path on CPU tensors."""
    _, tflow = _flow_pair(family, seed=3, bins=5)
    if family == "lrs":
        for t in tflow.transform.transforms:
            if hasattr(t, "min_lambda"):
                t.min_lambda = 0.2
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
    ttr = nsf_train.FusedNSFTrainer(tflow, 128)
    static = ttr._static
    x = torch.from_numpy(_x(n=40))
    for loss in (True, False):
        nsf_train._launch(loss, x, x, x[:, 0].contiguous(), ttr.weights, ttr._indices,
                          static, ttr._wh_scale, None, None, 32, 1.0 / 40, cluster=1)
    assert len(calls) == 2
    for args in calls:
        assert len(args) == len(launch.argtypes)
        family_index, _, num_bins = args[-12:-9]
        floats = args[-9:-2]
        assert nsf_flow_kernel.FAMILIES[family_index] == family and num_bins == 5
        assert floats == pytest.approx(nsf_flow_kernel.stage_floats(**static))
        tail_bound, _, _, min_derivative, min_lambda, edge, log_inv_bins = floats
        assert tail_bound == B
        if family == "lrs":
            assert min_lambda == pytest.approx(0.2)
            assert edge == _edge_derivative(min_derivative)
        else:
            assert edge == 1.0
        assert log_inv_bins == (pytest.approx(np.log(1 / 5)) if family == "linear" else 0.0)
