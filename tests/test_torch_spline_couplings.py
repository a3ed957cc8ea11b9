"""The port's linear, quadratic, cubic and linear-rational couplings, the
flows built from them and ``NeuralSplineFlow(spline="lrs")`` against the JAX
package on the CPU, after ``load_jax_params``: each coupling alone (with
linear tails and without), each whole flow (log_prob, noise, and sampling
as the inverse of the same numpy noise), a three-step Adam trajectory of
the LRS NSF, and what serving and the fused trainer do with these families
(``CompiledFlow`` serves them fused through B2, and its plain version
here; ``use_fused=False`` runs the unfused chain, where each coupling runs
its elementwise kernel's plain version; ``fused_trainer`` trains them
through B3, and its plain version here, and the eager route still trains
them).

Tolerances: 1e-4 absolute on outputs, logabsdet and log_prob (the fp32
interop bar, MIGRATION.md); the cubic family's logabsdet and log_prob 5e-4,
the JAX package's bar for its cubic kernel against its XLA path
(tests/ops/test_pallas_cubic.py). Adam losses 1e-4 over three steps; the
weights after them 5e-4 (tests/test_torch_train.py).
"""

import copy
import warnings

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
from nflows_tpu.training import create_train_state as jax_create_train_state
from nflows_tpu.training import make_train_step as jax_make_train_step
from nflows_tpu.transforms import coupling as jax_coupling
from nflows_tpu.transforms.base import CompositeTransform as JaxComposite
from nflows_tpu.transforms.permutations import Permutation as JaxPermutation
from nflows_tpu_torch import (
    CompiledFlow,
    Flow,
    NeuralSplineFlow,
    create_train_state,
    fused_trainer,
    load_jax_params,
    make_train_step,
)
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.ops.cuda.nsf_train import FusedNSFTrainer
from nflows_tpu_torch.transforms import (
    CompositeTransform,
    Permutation,
    PiecewiseCubicCouplingTransform,
    PiecewiseLinearCouplingTransform,
    PiecewiseLinearRationalCouplingTransform,
    PiecewiseQuadraticCouplingTransform,
    PiecewiseRationalQuadraticCouplingTransform,
)

torch.set_num_threads(1)

B = 3.0
ATOL = 1e-4
HIDDEN = 16
COUPLINGS = {
    "lrs": (jax_coupling.PiecewiseLinearRationalCouplingTransform,
            PiecewiseLinearRationalCouplingTransform),
    "linear": (jax_coupling.PiecewiseLinearCouplingTransform,
               PiecewiseLinearCouplingTransform),
    "quadratic": (jax_coupling.PiecewiseQuadraticCouplingTransform,
                  PiecewiseQuadraticCouplingTransform),
    "cubic": (jax_coupling.PiecewiseCubicCouplingTransform,
              PiecewiseCubicCouplingTransform),
}


def _lad_atol(family):
    return 5e-4 if family == "cubic" else ATOL


def _load(jax_module, module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax_module)
    load_jax_params(module, {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    return module


def _jax_net(key):
    return lambda i, o: jax_nets.ResidualNet(i, o, hidden_features=HIDDEN, num_blocks=2,
                                             key=key)


def _net(i, o):
    return nets.ResidualNet(i, o, hidden_features=HIDDEN, num_blocks=2, device="cpu")


def _coupling_pair(family, features, tails, seed=0, bins=4):
    jcls, tcls = COUPLINGS[family]
    mask = np.ones(features, dtype=np.float32)
    mask[::2] = -1
    kw = dict(mask=mask, num_bins=bins, tails=tails, tail_bound=B)
    jc = jcls(transform_net_create_fn=_jax_net(jax.random.key(seed)), **kw)
    tc = tcls(transform_net_create_fn=_net, device="cpu", **kw)
    return jc, _load(jc, tc)


def _flow_pair(family, features, seed=0, layers=3, bins=8):
    """The flagship's structure at a small width: ``layers`` x [random
    permutation, coupling of the family with linear tails], alternating
    masks, StandardNormal base. The LRS family is NeuralSplineFlow's own."""
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
        jchain += [JaxPermutation(perm), jcls(transform_net_create_fn=_jax_net(keys[i]), **kw)]
        tchain += [Permutation(perm, device="cpu"),
                   tcls(transform_net_create_fn=_net, device="cpu", **kw)]
        mask = -mask
    jflow = JaxFlow(transform=JaxComposite(jchain), distribution=JaxStandardNormal([features]))
    tflow = Flow(transform=CompositeTransform(tchain), distribution=StandardNormal([features]))
    return jflow, _load(jflow, tflow)


def _x(features, n=64, seed=1, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal((n, features))).astype(
        np.float32)


def _close(a, b, atol=ATOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("family", sorted(COUPLINGS))
@pytest.mark.parametrize("features", [5, 6])
@pytest.mark.parametrize("tails", ["linear", None])
def test_coupling_matches_jax(family, features, tails):
    """One coupling, forward and inverse; without tails the inputs lie in
    [0, 1] and the splines take K+1 boundary parameters."""
    jc, tc = _coupling_pair(family, features, tails, seed=features)
    x = _x(features, seed=2)
    if tails is None:
        x = 1.0 / (1.0 + np.exp(-x))
    with torch.no_grad():
        for direction in ("forward", "inverse"):
            y, lad = getattr(tc, direction)(torch.from_numpy(x))
            j_y, j_lad = getattr(jc, direction)(x)
            _close(y, j_y)
            _close(lad, j_lad, _lad_atol(family))


@pytest.mark.parametrize("family", sorted(COUPLINGS))
@pytest.mark.parametrize("features", [5, 6])
def test_flow_matches_jax(family, features):
    jflow, tflow = _flow_pair(family, features, seed=features)
    x = _x(features, seed=3)
    z = _x(features, seed=4, scale=1.0)
    atol = _lad_atol(family)
    with torch.no_grad():
        _close(tflow.log_prob(torch.from_numpy(x)), jflow.log_prob(x), atol)
        _close(tflow.transform_to_noise(torch.from_numpy(x)), jflow.transform_to_noise(x))
        # sampling: the same base noise through both inverse chains
        s, s_lad = tflow.transform.inverse(torch.from_numpy(z))
    j_s, j_lad = jflow.transform.inverse(z)
    _close(s, j_s)
    _close(s_lad, j_lad, atol)


@pytest.mark.parametrize("family", sorted(COUPLINGS))
def test_sample_and_log_prob_is_consistent(family):
    _, tflow = _flow_pair(family, 6)
    with torch.no_grad():
        s, lp = tflow.sample_and_log_prob(torch.Generator().manual_seed(5), 40)
        _close(lp, tflow.log_prob(s), 5e-3 if family == "cubic" else 1e-3)


def test_lrs_nsf_three_adam_steps_match_jax():
    jflow, tflow = _flow_pair("lrs", 6, seed=7)
    opt = optax.adam(1e-2)
    jstate = jax_create_train_state(jflow, opt)
    jstep = jax_make_train_step(opt, donate=False)
    state = create_train_state(copy.deepcopy(tflow),
                               lambda p: torch.optim.Adam(p, lr=1e-2))
    step = make_train_step()
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _x(6, n=128, seed=10 + i)
        jstate, jmetrics = jstep(jstate, jnp.asarray(batch))
        state, metrics = step(state, torch.from_numpy(batch))
        j_losses.append(float(jmetrics["loss"]))
        t_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-4, rtol=0)
    trained = jstate.flow.transform.transforms[1].transform_net.final_layer
    ours = state.flow.transform.transforms[1].transform_net.final_layer
    np.testing.assert_allclose(ours.weight.detach().numpy().T, np.asarray(trained.weight),
                               atol=5e-4, rtol=0)


def test_nsf_takes_rq_and_lrs_only():
    for spline in ("cubic", "linear"):
        with pytest.raises(ValueError):
            JaxNSF(6, HIDDEN, num_layers=2, spline=spline, key=jax.random.key(0))
        with pytest.raises(ValueError):
            NeuralSplineFlow(6, HIDDEN, num_layers=2, spline=spline, device="cpu")
    flow = NeuralSplineFlow(6, HIDDEN, num_layers=2, spline="lrs", device="cpu")
    cpl = flow.transform.transforms[1]
    assert isinstance(cpl, PiecewiseLinearRationalCouplingTransform)
    assert cpl.transform_net.final_layer.out_features == 3 * (4 * 8 - 1)


@pytest.mark.parametrize("family", sorted(COUPLINGS))
def test_serving_runs_the_unfused_chain_and_training_the_eager_route(family):
    """B2 has a stage for these families: ``CompiledFlow`` serves them fused
    by default (``use_fused=True`` too), and the fused view agrees with the
    unfused chain, which ``use_fused=False`` serves. B3 and B4 have their
    adjoints: ``fused_trainer`` gives the fused trainer, and the eager route
    trains them too."""
    _, tflow = _flow_pair(family, 6, layers=2)
    assert CompiledFlow(tflow, batch_size=32, features=6, use_fused=True, device="cpu").is_fused
    served = CompiledFlow(tflow, batch_size=32, features=6, device="cpu")
    unfused = CompiledFlow(tflow, batch_size=32, features=6, use_fused=False, device="cpu")
    assert served.is_fused and not unfused.is_fused
    x = torch.from_numpy(_x(6, n=32, seed=8))
    with torch.no_grad():
        assert torch.equal(unfused.log_prob(x), tflow.log_prob(x))
        _close(served.log_prob(x), unfused.log_prob(x), _lad_atol(family))
    s, lp = served.sample_and_log_prob(torch.Generator().manual_seed(9))
    assert s.shape == (32, 6) and lp.shape == (32,) and torch.isfinite(lp).all()
    assert isinstance(fused_trainer(tflow, 128), FusedNSFTrainer)
    state = create_train_state(copy.deepcopy(tflow), lambda p: torch.optim.Adam(p, lr=1e-2))
    step = make_train_step()
    batch = torch.from_numpy(_x(6, n=128, seed=11))
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(10)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# the five spline families with their learned CDF on the identity half
CDF_COUPLINGS = {**COUPLINGS, "rq": (jax_coupling.PiecewiseRationalQuadraticCouplingTransform,
                                     PiecewiseRationalQuadraticCouplingTransform)}


def _cdf_coupling_pair(family, features, tails, seed=0, bins=4):
    jcls, tcls = CDF_COUPLINGS[family]
    mask = np.ones(features, dtype=np.float32)
    mask[::2] = -1
    kw = dict(mask=mask, num_bins=bins, tails=tails, tail_bound=B,
              apply_unconditional_transform=True)
    jc = jcls(transform_net_create_fn=_jax_net(jax.random.key(seed)), **kw)
    tc = tcls(transform_net_create_fn=_net, device="cpu", **kw)
    return jc, _load(jc, tc)


@pytest.mark.parametrize("tails", ["linear", None])
@pytest.mark.parametrize("family", sorted(CDF_COUPLINGS))
def test_coupling_with_a_cdf_matches_jax(family, tails):
    """``apply_unconditional_transform=True``: the family's learned CDF on
    the identity half, with the coupling's bins, tails and bound, carried
    across with the conditioner; forward and inverse."""
    jc, tc = _cdf_coupling_pair(family, 5, tails, seed=3)
    cdf = tc.unconditional_transform
    assert type(cdf).__name__ == type(jc.unconditional_transform).__name__
    assert (cdf.tails, cdf.tail_bound) == (tails, B)
    x = _x(5, seed=2)
    if tails is None:
        x = 1.0 / (1.0 + np.exp(-x))
    with torch.no_grad():
        for direction in ("forward", "inverse"):
            y, lad = getattr(tc, direction)(torch.from_numpy(x))
            j_y, j_lad = getattr(jc, direction)(x)
            _close(y, j_y)
            _close(lad, j_lad, _lad_atol(family))


@pytest.mark.parametrize("cls", ["AffineCouplingTransform", "AdditiveCouplingTransform"])
def test_affine_coupling_with_an_unconditional_transform_matches_jax(cls):
    from nflows_tpu.transforms import nonlinearities as jnl
    from nflows_tpu_torch.transforms import coupling as torch_coupling
    from nflows_tpu_torch.transforms import nonlinearities as tnl

    mask = np.array([1, -1, 1, -1, 1, -1], dtype=np.float32)
    kw = dict(num_bins=4, tails="linear", tail_bound=B)
    jc = getattr(jax_coupling, cls)(
        mask, _jax_net(jax.random.key(4)),
        unconditional_transform=lambda features: jnl.PiecewiseRationalQuadraticCDF(
            [features], key=jax.random.key(5), **kw))
    tc = _load(jc, getattr(torch_coupling, cls)(
        mask, _net, device="cpu",
        unconditional_transform=lambda features: tnl.PiecewiseRationalQuadraticCDF(
            [features], **kw)))
    x = _x(6, seed=5)
    with torch.no_grad():
        for direction in ("forward", "inverse"):
            y, lad = getattr(tc, direction)(torch.from_numpy(x))
            j_y, j_lad = getattr(jc, direction)(x)
            _close(y, j_y)
            _close(lad, j_lad)


@pytest.mark.parametrize("family", sorted(CDF_COUPLINGS))
def test_order_in_a_coupling_with_a_cdf(family):
    """Forward runs the conditioner on the identity half as it came in,
    then the CDF; the inverse runs the CDF's inverse first and the
    conditioner on its output; the logabsdet is the sum in both."""
    _, tc = _cdf_coupling_pair(family, 5, "linear")
    bare = copy.deepcopy(tc)
    bare.unconditional_transform = None
    cdf = tc.unconditional_transform
    x = torch.from_numpy(_x(5, seed=6))
    ids, trs = tc.identity_features, tc.transform_features
    with torch.no_grad():
        y, lad = tc.forward(x)
        y_bare, lad_bare = bare.forward(x)
        id_out, id_lad = cdf.forward(x[:, ids])
        assert torch.equal(y[:, trs], y_bare[:, trs])
        assert torch.equal(y[:, ids], id_out)
        _close(lad, lad_bare + id_lad, 1e-6)
        back, lad_back = tc.inverse(y)
        id_in, id_lad_inv = cdf.inverse(y[:, ids])
        assert torch.equal(back[:, ids], id_in)
        mid = y.clone()
        mid[:, ids] = id_in
        back_bare, lad_back_bare = bare.inverse(mid)
        assert torch.equal(back[:, trs], back_bare[:, trs])
        _close(lad_back, lad_back_bare + id_lad_inv, 1e-6)
        _close(back, x, 1e-4)


@pytest.mark.parametrize("family", sorted(CDF_COUPLINGS))
def test_no_fuser_takes_a_coupling_with_a_cdf(family):
    """B2, B3 and B4 have no stage for a map of the identity half: the
    fuser's ``_extract`` refuses a coupling with an unconditional
    transform, as the JAX one does (nflows_tpu/ops/pallas/nsf_fused.py:
    200-201), even in one layer of a chain. ``CompiledFlow`` then serves
    the flow unfused (``use_fused=True`` raises with that reason), and no
    fused trainer takes it (``required=False`` gives None)."""
    from nflows_tpu_torch.ops.cuda.nsf_fused import FusedNSF, _extract, fuse_nsf

    jcls, tcls = CDF_COUPLINGS[family]
    mask = np.array([1, -1, 1, -1, 1, -1], dtype=np.float32)
    kw = dict(num_bins=4, tails="linear", tail_bound=B)
    tflow = Flow(CompositeTransform([
        Permutation(np.arange(6)[::-1].copy(), device="cpu"),
        tcls(mask, _net, device="cpu", **kw),
        Permutation(np.arange(6)[::-1].copy(), device="cpu"),
        tcls(-mask, _net, apply_unconditional_transform=True, device="cpu", **kw)]),
        StandardNormal([6]))
    for fuse in (lambda: _extract(tflow, torch.float32), lambda: fuse_nsf(tflow),
                 lambda: FusedNSF(tflow), lambda: FusedNSFTrainer(tflow, batch_size=128),
                 lambda: fused_trainer(tflow, 128),
                 lambda: CompiledFlow(tflow, batch_size=32, features=6, use_fused=True,
                                      device="cpu")):
        with pytest.raises(ValueError, match="unconditional_transform not supported"):
            fuse()
    assert fused_trainer(tflow, 128, required=False) is None
    served = CompiledFlow(tflow, batch_size=32, features=6, device="cpu")
    assert not served.is_fused
    x = torch.from_numpy(_x(6, n=32, seed=7))
    with torch.no_grad():
        assert torch.equal(served.log_prob(x), tflow.log_prob(x))
    s, lp = served.sample_and_log_prob(torch.Generator().manual_seed(9))
    assert s.shape == (32, 6) and torch.isfinite(lp).all()


class _ChannelNet(torch.nn.Module):
    """A conditioner with ``hidden_channels`` and no ``hidden_features``."""

    hidden_channels = 16

    def __init__(self, i, o):
        super().__init__()
        self.linear = torch.nn.Linear(i, o)

    def forward(self, x, context=None):
        return self.linear(x)


def test_softmax_rescale_follows_the_reference_rule():
    """Only the RQ coupling falls back to ``hidden_channels`` (and warns
    without it); the other families rescale only with ``hidden_features``."""
    params = torch.ones(2, 3)
    kw = dict(mask=[1, -1, 1, -1], tails="linear", device="cpu")
    rq = PiecewiseRationalQuadraticCouplingTransform(transform_net_create_fn=_ChannelNet, **kw)
    assert torch.allclose(rq._softmax_rescale(params, include_channels=True)[0], params / 4)
    for family in ("quadratic", "cubic", "lrs"):
        cpl = COUPLINGS[family][1](transform_net_create_fn=_ChannelNet, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert torch.equal(cpl._softmax_rescale(params)[0], params)
    bare = PiecewiseRationalQuadraticCouplingTransform(
        transform_net_create_fn=lambda i, o: torch.nn.Linear(i, o), **kw)
    with pytest.warns(UserWarning, match="not scaled down"):
        bare._softmax_rescale(params, include_channels=True)
