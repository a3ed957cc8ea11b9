"""The port's normalization transforms (``BatchNorm``, ``ActNorm``), the
batch statistics inside the conditioners (``_BatchScale`` in ResidualNet and
in both MADE blocks), the flows that use them (MAF and SimpleRealNVP with
``batch_norm_between_layers``; NSF, IAF, NSF-AR, MAF and RealNVP with
``batch_norm_within_layers``; the mixture MADEs with ``use_batch_norm``) and
the fusers' refusals of such chains, against the JAX package on the CPU, on
carried parameters and the same numpy inputs.

At construction every normalization is near the identity (BatchNorm's scale
1 - eps and running statistics 0, ActNorm's 0 and 0, _BatchScale's 1 and 0),
so each JAX parameter is first moved by seeded numpy draws, and the running
statistics are set by ``initialize_with_data`` on a batch that is neither
centred nor of unit scale.

Tolerances. Outputs, logabsdet, running statistics and the flows' log_prob
1e-4, the interop bar between the two packages in fp32 (MIGRATION.md:32);
batches are odd (33), where a biased variance in place of an unbiased one
moves _BatchScale's outputs by 1.5%. Samples 2e-4 through an autoregressive
inverse (a fixed point of D MADE passes a layer, the bar of
tests/test_torch_autoregressive.py), 1e-4 through couplings, both relative
to 1 + |sample|: an eval-mode BatchNorm's inverse multiplies by the running
standard deviation over the learned scale, and at perturbed parameters some
samples reach several hundred, where an fp32 ulp is 3e-5 and the two
packages' rounding differs by a few. The IAF's log_prob (its fixed point,
dividing by the scales) and its losses likewise at 1e-4 of 1 + |value|: they
reach 1e4. Adam steps' losses 2e-4, the bar of tests/test_torch_train.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.core import set_training
from nflows_tpu.distributions import MADEMoG as JaxMADEMoG
from nflows_tpu.flows import MaskedAutoregressiveFlow as JaxMAF
from nflows_tpu.flows import SimpleRealNVP as JaxRealNVP
from nflows_tpu.models import InverseAutoregressiveFlow as JaxIAF
from nflows_tpu.models import NeuralSplineFlow as JaxNSF
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.nn import made as jax_made
from nflows_tpu.nn.nde.made import MixtureOfGaussiansMADE as JaxMoG
from nflows_tpu.nn.nets import resnet as jax_resnet
from nflows_tpu.ops.pallas import maf_fused as jax_maf_fused
from nflows_tpu.ops.pallas import mademog_fused as jax_mademog_fused
from nflows_tpu.ops.pallas import nsf_fused as jax_nsf_fused
from nflows_tpu.serving import CompiledFlow as JaxCompiledFlow
from nflows_tpu.training import create_train_state as jax_create_train_state
from nflows_tpu.training import make_train_step as jax_make_train_step
from nflows_tpu.transforms import base as jax_base
from nflows_tpu.transforms import lu as jax_lu
from nflows_tpu.transforms import normalization as jax_norm
from nflows_tpu_torch import (
    CompiledFlow,
    InverseAutoregressiveFlow,
    MADEMoG,
    MaskedAutoregressiveFlow,
    MixtureOfGaussiansMADE,
    NeuralSplineFlow,
    NeuralSplineFlowAR,
    SimpleRealNVP,
    create_train_state,
    fused_trainer,
    load_jax_params,
    make_train_step,
)
from nflows_tpu_torch.nn import made as torch_made
from nflows_tpu_torch.nn.nets import resnet as torch_resnet
from nflows_tpu_torch.transforms import ActNorm, BatchNorm, CompositeTransform, LULinear
from nflows_tpu_torch.transforms.base import InverseNotAvailable

torch.set_num_threads(1)

BATCH = 33


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _movable(key):
    """A leaf that may be moved: not a MADE mask (the loader checks it
    against the port's) and not a running statistic (set through
    initialize_with_data)."""
    return "mask" not in key and "running_" not in key


def _perturbed(module, seed, scale=0.2):
    """``module`` with every movable float leaf moved by ``scale`` times a
    seeded standard normal draw."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(module)
    rng = np.random.default_rng(seed)
    moved = []
    for path, leaf in leaves:
        value = np.asarray(leaf)
        if np.issubdtype(value.dtype, np.floating) and _movable(jax.tree_util.keystr(path)):
            value = value + scale * rng.standard_normal(value.shape).astype(value.dtype)
        moved.append(jnp.asarray(value))
    return jax.tree_util.tree_unflatten(treedef, moved)


def _carry(jmodule, tmodule, seed=100):
    jmodule = _perturbed(jmodule, seed)
    load_jax_params(tmodule, _jax_params(jmodule))
    return jmodule, tmodule


def _data(seed, shape, scale=1.5, shift=0.7):
    """A batch that is neither centred nor of unit scale."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, atol):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _close_relative(a, b, bar):
    """max |a - b| / (1 + |b|) within ``bar``."""
    a, b = _np(a), _np(b)
    err = float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
    assert err <= bar, f"relative error {err:.3e} past {bar:g}"


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- BatchNorm -------------------------------------------------------------------------


@pytest.fixture
def batch_norms():
    jm, tm = _carry(jax_norm.BatchNorm(5), BatchNorm(5, device="cpu"))
    assert tm.unconstrained_weight.abs().min() > 0.0 and tm.bias.abs().max() > 0.1
    return jm, tm


def test_batch_norm_in_training_mode_matches_jax(batch_norms):
    """Training mode normalises by the batch's mean and unbiased variance;
    the forward leaves the running statistics alone; there is no inverse."""
    jm, tm = batch_norms
    x = _data(1, (BATCH, 5))
    with torch.no_grad():
        out, lad = tm(_t(x))
    j_out, j_lad = jm(jnp.asarray(x))
    _close(out, j_out, 1e-4)
    _close(lad, j_lad, 1e-4)
    # unbiased: the normalised batch has variance 1 with correction=1
    normalised = (out - tm.bias) / tm.weight
    _close(torch.var(normalised, dim=0, correction=1).detach(), np.ones(5), 1e-3)
    assert tm.training and torch.equal(tm.running_mean, torch.zeros(5))
    with pytest.raises(InverseNotAvailable):
        tm.inverse(_t(x))
    with pytest.raises(jax_base.InverseNotAvailable):
        jm.inverse(jnp.asarray(x))


def test_batch_norm_statistics_and_eval_mode_match_jax(batch_norms):
    """initialize_with_data sets the running statistics to the batch's, with
    no momentum; update_running_stats takes one EMA step; eval mode then
    normalises by them, forward and inverse."""
    jm, tm = batch_norms
    x = _data(2, (BATCH, 5), scale=2.0, shift=-1.3)
    jm, j_out = jm.initialize_with_data(jnp.asarray(x))
    new, out = tm.initialize_with_data(_t(x))
    assert new is tm
    _close(out, j_out, 1e-4)
    _close(tm.running_mean, jm.running_mean, 1e-5)
    _close(tm.running_var, jm.running_var, 1e-4)
    _close(tm.running_var, np.var(x, axis=0, ddof=1), 1e-4)
    y = _data(3, (BATCH, 5), scale=0.5, shift=2.0)
    jm = jm.update_running_stats(jnp.asarray(y))
    assert tm.update_running_stats(_t(y)) is tm
    _close(tm.running_mean, jm.running_mean, 1e-5)
    _close(tm.running_var, jm.running_var, 1e-4)
    assert not tm.running_var.requires_grad
    jm = set_training(jm, False)
    tm.eval()
    z = _data(4, (BATCH, 5))
    with torch.no_grad():
        out, lad = tm(_t(z))
        inv, ilad = tm.inverse(_t(z))
        back, blad = tm.inverse(out)
    _close(out, jm(jnp.asarray(z))[0], 1e-4)
    _close(lad, jm(jnp.asarray(z))[1], 1e-4)
    _close(inv, jm.inverse(jnp.asarray(z))[0], 1e-4)
    _close(ilad, jm.inverse(jnp.asarray(z))[1], 1e-4)
    _close(back, z, 1e-5)
    _close(lad + blad, np.zeros(BATCH), 1e-5)
    assert set(tm.state_dict()) == {"unconstrained_weight", "bias", "running_mean",
                                    "running_var"}


def test_batch_norm_constructor_and_refusals():
    assert not BatchNorm(4, training=False, device="cpu").training
    with pytest.raises(ValueError, match="2-dim"):
        BatchNorm(4, device="cpu")(torch.ones(2, 4, 1))
    with pytest.raises(TypeError):
        BatchNorm(0, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        BatchNorm(4, stats_axis="data", device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        torch_resnet._BatchScale(4, stats_axis="data", device="cpu")


# -- ActNorm ---------------------------------------------------------------------------


def test_actnorm_initialisation_matches_jax_and_is_idempotent():
    x = _data(5, (BATCH, 6), scale=3.0, shift=-2.0)
    jm, j_out = jax_norm.ActNorm(6).initialize_with_data(jnp.asarray(x))
    tm = ActNorm(6, device="cpu")
    assert not bool(tm.initialized)
    new, out = tm.initialize_with_data(_t(x))
    assert new is tm and bool(tm.initialized)
    _close(out, j_out, 1e-4)
    _close(tm.log_scale, jm.log_scale, 1e-5)
    _close(tm.shift, jm.shift, 1e-5)
    # the map's outputs on the batch: zero mean and unit (unbiased) variance
    _close(out.mean(0).detach(), np.zeros(6), 1e-5)
    _close(out.std(0, correction=1).detach(), np.ones(6), 1e-5)
    # a second call on another batch leaves the map as it was, in both
    before = copy.deepcopy(tm.state_dict())
    y = _data(6, (BATCH, 6))
    jm2, j_out2 = jm.initialize_with_data(jnp.asarray(y))
    _, out2 = tm.initialize_with_data(_t(y))
    for k, v in before.items():
        assert torch.equal(v, tm.state_dict()[k])
    _close(jm2.log_scale, jm.log_scale, 0)
    _close(out2, j_out2, 1e-4)
    with torch.no_grad():
        inv, ilad = tm.inverse(_t(y))
        lad = tm(_t(y))[1]
    _close(inv, jm.inverse(jnp.asarray(y))[0], 1e-4)
    _close(ilad, jm.inverse(jnp.asarray(y))[1], 1e-4)
    _close(lad, jm(jnp.asarray(y))[1], 1e-4)


def test_actnorm_flag_is_taken_by_the_loader():
    """JAX keeps ``initialized`` as a static field, so it is no leaf; the
    port keeps it as a persistent bool buffer. The caller adds it to the
    params from the JAX module; missing, the loader raises and names it.
    After the load, initialize_with_data on both packages gives the same
    outputs: neither initialises again."""
    x = _data(7, (BATCH, 4), scale=2.0)
    jflow_t, _ = jax_base.CompositeTransform(
        [jax_norm.ActNorm(4), jax_lu.LULinear(4)]).initialize_with_data(jnp.asarray(x))
    jflow_t = _perturbed(jflow_t, seed=8)
    params = _jax_params(jflow_t)
    assert not any(k.endswith("initialized") for k in params)
    tm = CompositeTransform([ActNorm(4, device="cpu"), LULinear(4, device="cpu")])
    with pytest.raises(KeyError, match=r"initialized.*static field"):
        load_jax_params(tm, params)
    params[".transforms[0].initialized"] = np.asarray(jflow_t.transforms[0].initialized)
    load_jax_params(tm, params)
    assert bool(tm.transforms[0].initialized)
    y = _data(9, (BATCH, 4), scale=0.3)
    _, j_out = jflow_t.initialize_with_data(jnp.asarray(y))
    _, out = tm.initialize_with_data(_t(y))
    _close(out, j_out, 1e-4)
    _close(tm.transforms[0].log_scale, jflow_t.transforms[0].log_scale, 0)
    # the flag travels in the port's own state dict
    fresh = CompositeTransform([ActNorm(4, device="cpu"), LULinear(4, device="cpu")])
    fresh.load_state_dict(tm.state_dict())
    assert bool(fresh.transforms[0].initialized)


def test_actnorm_refuses_images():
    with pytest.raises(NotImplementedError, match="queue A item 6c"):
        ActNorm(3, device="cpu")(torch.ones(2, 3, 4, 4))
    with pytest.raises(ValueError, match="2D or a 4D"):
        ActNorm(3, device="cpu")(torch.ones(2, 3, 4))


# -- batch statistics inside the conditioners -------------------------------------------


@pytest.mark.parametrize("context_features", [None, 3])
def test_batch_scale_in_residual_net_matches_jax(context_features):
    """_BatchScale's variance is biased (correction=0), BatchNorm's is not:
    at N = 33 the two differ by 1.5%, far past the bar."""
    kw = dict(in_features=4, out_features=7, hidden_features=16,
              context_features=context_features, num_blocks=2, use_batch_norm=True)
    jnet, tnet = _carry(jax_resnet.ResidualNet(key=jax.random.key(0), **kw),
                        torch_resnet.ResidualNet(device="cpu", **kw))
    assert tnet.blocks[0].batch_norm_0.scale.abs().min() > 0.0
    x = _data(10, (BATCH, 4))
    c = None if context_features is None else _data(11, (BATCH, context_features))
    with torch.no_grad():
        out = tnet(_t(x), None if c is None else _t(c))
    _close(out, jnet(jnp.asarray(x), None if c is None else jnp.asarray(c)), 1e-4)
    # the biased variance, checked on the block's first normalisation alone
    bn = tnet.blocks[0].batch_norm_0
    h = _t(_data(12, (BATCH, 16)))
    with torch.no_grad():
        want = ((h - h.mean(0)) / torch.sqrt(h.var(0, correction=0) + 1e-3)) * bn.scale + bn.offset
        _close(bn(h), want, 1e-5)
        assert (bn(h) - ((h - h.mean(0)) / torch.sqrt(h.var(0, correction=1) + 1e-3))
                * bn.scale - bn.offset).abs().max() > 1e-3


@pytest.mark.parametrize("residual", [True, False])
def test_batch_scale_in_made_blocks_matches_jax(residual):
    """Both MADE blocks: the feedforward block's ``batch_norm`` and the
    residual block's ``batch_norm_0``/``batch_norm_1``. Normalising each unit
    over the batch never mixes units, so output d still depends on no input
    at d or after (checked by moving one feature for the whole batch)."""
    kw = dict(features=5, hidden_features=16, num_blocks=2, output_multiplier=2,
              use_residual_blocks=residual, use_batch_norm=True)
    jm, tm = _carry(jax_made.MADE(key=jax.random.key(1), **kw),
                    torch_made.MADE(device="cpu", **kw))
    block = tm.blocks[0]
    norms = [block.batch_norm_0, block.batch_norm_1] if residual else [block.batch_norm]
    assert all(isinstance(n, torch_resnet._BatchScale) for n in norms)
    x = _data(13, (BATCH, 5))
    with torch.no_grad():
        out = tm(_t(x))
    _close(out, jm(jnp.asarray(x)), 1e-4)
    for d in range(5):
        moved = x.copy()
        moved[:, d] += 1.0
        with torch.no_grad():
            delta = (tm(_t(moved)) - out).reshape(BATCH, 5, 2).abs().amax(dim=(0, 2))
        assert delta[:d + 1].max() == 0.0 and (d == 4 or delta[d + 1:].max() > 0.0)


# -- the flows -----------------------------------------------------------------------------

SMALL = dict(features=5, hidden_features=16, num_layers=2, num_blocks_per_layer=2)
AR_SPLINE = dict(num_bins=4, tail_bound=3.0)

# name -> (JAX class, port class, arguments, whether its inverse is a fixed point)
# An IAF's log_prob runs the fixed point and divides by the scales, so its
# values grow fast with the inputs' size (tests/test_torch_autoregressive.py):
# it is fed inputs at scale 1, centred.
FLOWS = {
    "maf_between": (JaxMAF, MaskedAutoregressiveFlow,
                    dict(batch_norm_between_layers=True), True),
    "maf_within": (JaxMAF, MaskedAutoregressiveFlow,
                   dict(batch_norm_within_layers=True), True),
    "realnvp_both": (JaxRealNVP, SimpleRealNVP,
                     dict(batch_norm_between_layers=True, batch_norm_within_layers=True),
                     False),
    "nsf_within": (JaxNSF, NeuralSplineFlow,
                   dict(batch_norm_within_layers=True, stacked=False, **AR_SPLINE), False),
    "iaf_within": (JaxIAF, InverseAutoregressiveFlow,
                   dict(batch_norm_within_layers=True), False),
    "nsf_ar_within": (JaxNSFAR, NeuralSplineFlowAR,
                      dict(batch_norm_within_layers=True, **AR_SPLINE), True),
}


def _hold_density(name, a, b):
    """The density direction at 1e-4: relative for the IAF (its fixed
    point), absolute for the others."""
    if name == "iaf_within":
        _close_relative(a, b, 1e-4)
    else:
        _close(a, b, 1e-4)


def _inputs(name, seed, shape):
    if name == "iaf_within":
        return _data(seed, shape, scale=1.0, shift=0.0)
    return _data(seed, shape)


def _flow_pair(name, seed=0):
    jcls, tcls, extra, _ = FLOWS[name]
    kw = {**SMALL, **extra}
    rng = lambda: {} if tcls is SimpleRealNVP else dict(rng=np.random.default_rng(seed))  # noqa: E731
    jflow = jcls(key=jax.random.key(seed), **kw, **rng())
    tflow = tcls(device="cpu", **kw, **rng())
    assert [type(t).__name__ for t in tflow.transform.transforms] == \
        [type(t).__name__ for t in jflow.transform.transforms]
    return _carry(jflow, tflow, seed=seed + 200)


@pytest.fixture(scope="module", params=sorted(FLOWS))
def flow_pair(request):
    return request.param, *_flow_pair(request.param)


def test_flow_log_prob_in_training_mode_matches_jax(flow_pair):
    """The same batch in both packages: in training mode each sample's
    density depends on its batch-mates."""
    name, jflow, tflow = flow_pair
    x = _inputs(name, 20, (BATCH, 5))
    with torch.no_grad():
        lp = tflow.log_prob(_t(x))
        other = tflow.log_prob(_t(x[:BATCH - 4]))
    _hold_density(name, lp, jflow.log_prob(jnp.asarray(x)))
    # the batch-mates matter (batch norm everywhere in these flows)
    assert (lp[:BATCH - 4] - other).abs().max() > 1e-4


def test_flow_after_initialize_with_data_in_eval_mode_matches_jax(flow_pair):
    """initialize_with_data on a batch sets every BatchNorm's running
    statistics (the chain passes each the outputs before it); in eval mode
    log_prob no longer depends on the batch, and the samples from shared base
    noise match."""
    name, jflow, tflow = flow_pair
    tflow = copy.deepcopy(tflow)
    x = _inputs(name, 21, (4 * BATCH, 5))
    new_t, j_out = jflow.transform.initialize_with_data(jnp.asarray(x))
    jflow = set_training(jflow.replace(transform=new_t), False)
    t_new, out = tflow.transform.initialize_with_data(_t(x))
    assert t_new is tflow.transform
    _hold_density(name, out, j_out)
    tflow.eval()
    norms = [m for m in tflow.modules() if isinstance(m, BatchNorm)]
    assert all(m.running_var.min() > 0 for m in norms)
    y = _inputs(name, 22, (BATCH, 5))
    z = _data(23, (BATCH, 5), scale=1.0, shift=0.0)
    with torch.no_grad():
        lp = tflow.log_prob(_t(y))
        samples, lad = tflow.transform.inverse(_t(z))
    _hold_density(name, lp, jflow.log_prob(jnp.asarray(y)))
    j_samples, j_lad = jflow.transform.inverse(jnp.asarray(z))
    bar = 2e-4 if FLOWS[name][3] else 1e-4
    _close_relative(samples, j_samples, bar)
    _close_relative(lad, j_lad, bar)
    if norms and not any(isinstance(m, torch_resnet._BatchScale) for m in tflow.modules()):
        # running statistics alone: a sample's density is its own
        with torch.no_grad():
            _close(tflow.log_prob(_t(y[:7])), lp[:7], 1e-5)


def test_flow_adam_steps_match_jax(flow_pair):
    """Two Adam steps (lr 1e-2) in training mode from carried weights: the
    losses within 2e-4; the running statistics do not move."""
    name, jflow, tflow = flow_pair
    opt = optax.adam(1e-2)
    jstate = jax_create_train_state(jflow, opt)
    jstep = jax_make_train_step(opt, donate=False)
    state = create_train_state(copy.deepcopy(tflow), lambda p: torch.optim.Adam(p, lr=1e-2))
    step = make_train_step()
    j_losses, t_losses = [], []
    for i in range(2):
        batch = _inputs(name, 30 + i, (129, 5))
        jstate, jm = jstep(jstate, jnp.asarray(batch))
        state, tm = step(state, _t(batch))
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    if name == "iaf_within":
        _close_relative(t_losses, j_losses, 1e-4)
    else:
        np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    for m in state.flow.modules():
        if isinstance(m, BatchNorm):
            assert torch.equal(m.running_var, torch.zeros(5))


# -- the mixture MADEs -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mog", "mademog"])
def test_mixture_made_with_batch_norm_matches_jax(kind):
    kw = dict(features=5, hidden_features=16, num_blocks=2, num_mixture_components=3,
              use_batch_norm=True)
    if kind == "mog":
        jm, tm = _carry(JaxMoG(key=jax.random.key(2), rng=np.random.default_rng(2), **kw),
                        MixtureOfGaussiansMADE(rng=np.random.default_rng(2), device="cpu", **kw))
        blocks = tm.blocks
    else:
        kw["context_features"] = 3
        jm, tm = _carry(JaxMADEMoG(key=jax.random.key(3), rng=np.random.default_rng(3), **kw),
                        MADEMoG(rng=np.random.default_rng(3), device="cpu", **kw))
        blocks = tm.made.blocks
    assert blocks[0].batch_norm_0 is not None
    x = _data(40, (BATCH, 5))
    c = None if kind == "mog" else _data(41, (BATCH, 3))
    with torch.no_grad():
        lp = tm.log_prob(_t(x), None if c is None else _t(c))
    _close(lp, jm.log_prob(jnp.asarray(x), None if c is None else jnp.asarray(c)), 1e-4)
    opt = optax.adam(1e-2)
    jstate = jax_create_train_state(jm, opt)
    jstep = jax_make_train_step(opt, donate=False)
    state = create_train_state(copy.deepcopy(tm), lambda p: torch.optim.Adam(p, lr=1e-2))
    step = make_train_step()
    for i in range(2):
        batch = _data(42 + i, (129, 5))
        ctx = None if c is None else _data(44 + i, (129, 3))
        jstate, j_metrics = jstep(jstate, jnp.asarray(batch),
                                  None if ctx is None else jnp.asarray(ctx))
        state, t_metrics = step(state, _t(batch), None if ctx is None else _t(ctx))
        np.testing.assert_allclose(float(t_metrics["loss"]), float(j_metrics["loss"]),
                                   atol=2e-4, rtol=0)


# -- serving and the fusers' refusals ----------------------------------------------------


def test_training_mode_batch_norm_sample_raises_in_both_packages():
    """CompiledFlow switches no modes in either package: a request for
    samples of a flow whose BatchNorm is in training mode raises
    InverseNotAvailable, as the JAX one does; log_prob is served."""
    jflow, tflow = _flow_pair("maf_between")
    served = CompiledFlow(tflow, batch_size=16, features=5, device="cpu")
    served.log_prob(torch.randn(16, 5))
    with pytest.raises(InverseNotAvailable):
        served.sample(torch.Generator().manual_seed(0))
    with pytest.raises(jax_base.InverseNotAvailable):
        JaxCompiledFlow(jflow, batch_size=16, features=5).sample(jax.random.key(0))


def _nsf_with(between):
    """A 2-layer flagship chain in both packages with ``between`` (an
    LULinear or a BatchNorm) after the first coupling, parameters carried."""
    jflow = JaxNSF(key=jax.random.key(0), rng=np.random.default_rng(0), stacked=False,
                   **SMALL, **AR_SPLINE)
    tflow = NeuralSplineFlow(rng=np.random.default_rng(0), stacked=False, device="cpu",
                             **SMALL, **AR_SPLINE)
    j_extra, t_extra = {"lu": (jax_lu.LULinear(5), LULinear(5, device="cpu")),
                        "batch_norm": (jax_norm.BatchNorm(5),
                                       BatchNorm(5, device="cpu"))}[between]
    j_ts, t_ts = list(jflow.transform.transforms), list(tflow.transform.transforms)
    jflow = jflow.replace(
        transform=jax_base.CompositeTransform(j_ts[:2] + [j_extra] + j_ts[2:]))
    tflow.transform = CompositeTransform(t_ts[:2] + [t_extra] + t_ts[2:])
    return _carry(jflow, tflow)


def _refusal_cases():
    return {
        "batch-normed flagship": lambda: _flow_pair("nsf_within"),
        "batch-normed MAF": lambda: _flow_pair("maf_within"),
        "MAF with BatchNorm between layers": lambda: _flow_pair("maf_between"),
        "batch-normed MoG-MADE": lambda: _carry(
            JaxMoG(5, 16, num_mixture_components=3, use_batch_norm=True,
                   key=jax.random.key(0), rng=np.random.default_rng(0)),
            MixtureOfGaussiansMADE(5, 16, num_mixture_components=3, use_batch_norm=True,
                                   rng=np.random.default_rng(0), device="cpu")),
        "NSF-AR with LU layers": lambda: _carry(
            JaxNSFAR(key=jax.random.key(0), rng=np.random.default_rng(0),
                     use_linear_layers=True, **SMALL, **AR_SPLINE),
            NeuralSplineFlowAR(rng=np.random.default_rng(0), device="cpu",
                               use_linear_layers=True, **SMALL, **AR_SPLINE)),
        "NSF with an LULinear between couplings": lambda: _nsf_with("lu"),
        "NSF with a BatchNorm between couplings": lambda: _nsf_with("batch_norm"),
    }


def _jax_reason(name, jmodel):
    """The JAX fuser's reason for refusing ``jmodel``: the prober of the
    family the model belongs to."""
    probe = {"batch-normed MoG-MADE": lambda m: jax_mademog_fused._validate(m),
             "batch-normed MAF": lambda m: jax_maf_fused._extract(m, jnp.float32),
             "MAF with BatchNorm between layers":
                 lambda m: jax_maf_fused._extract(m, jnp.float32),
             "NSF-AR with LU layers": lambda m: jax_maf_fused._extract(m, jnp.float32)}.get(
                 name, lambda m: jax_nsf_fused._extract(m, jnp.float32))
    with pytest.raises(ValueError) as e:
        probe(jmodel)
    return str(e.value)


@pytest.mark.parametrize("name", sorted(_refusal_cases()))
def test_fusers_refuse_with_the_jax_reason(name):
    """Each fuser checks what it cannot run (a missed check would serve a
    chain with its normalisation or linear layer silently dropped):
    CompiledFlow(use_fused=None) serves unfused and agrees with the model,
    use_fused=True and fused_trainer raise with the JAX prober's reason, and
    fused_trainer(required=False) returns None."""
    jmodel, tmodel = _refusal_cases()[name]()
    reason = _jax_reason(name, jmodel)
    expected = {"batch-normed flagship": "batch-norm/dropout conditioners not fused",
                "batch-normed MAF": "batch-norm MADE not fused",
                "MAF with BatchNorm between layers":
                    "layer must start with a feature Permutation",
                "batch-normed MoG-MADE": "batch-norm MADE not fused",
                "NSF-AR with LU layers":
                    "only affine / RQ-spline autoregressive layers are fused",
                "NSF with an LULinear between couplings":
                    "unsupported transform in chain: LULinear",
                "NSF with a BatchNorm between couplings":
                    "unsupported transform in chain: BatchNorm"}[name]
    assert reason == expected
    x = torch.from_numpy(_data(50, (16, 5)))
    served = CompiledFlow(tmodel, batch_size=16, features=5, device="cpu")
    assert not served.is_fused
    with torch.no_grad():
        _close(served.log_prob(x), tmodel.log_prob(x), 0)
        _close(served.log_prob(x), jmodel.log_prob(jnp.asarray(x.numpy())), 1e-4)
    with pytest.raises(ValueError) as e:
        CompiledFlow(tmodel, batch_size=16, features=5, use_fused=True, device="cpu")
    assert reason in str(e.value)
    with pytest.raises(ValueError) as e:
        fused_trainer(tmodel, 128)
    assert reason in str(e.value)
    assert fused_trainer(tmodel, 128, required=False) is None
