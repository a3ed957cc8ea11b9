"""The port's affine and additive couplings, ``SimpleRealNVP``, ``MLP`` and the
whole-chain kernels' other families against the JAX package on the CPU,
after ``load_jax_params``: each coupling and scale activation forward and
inverse; SimpleRealNVP (affine and additive) log_prob and sampling as the
inverse of the same numpy noise; B2's plain version for all seven coupling
families against the JAX whole-chain Pallas kernel in interpret mode and
against the JAX XLA chain; the plain versions of B3 and B4 for the affine,
general-affine and additive couplings against ``jax.grad`` of the JAX
chain (the layer functions its training kernels differentiate, in XLA); a three-step Adam trajectory of ``FusedNSFTrainer`` on
RealNVP against the JAX trainer in interpret mode; ``to_flow()``; and what
the port refuses.

Tolerances. Extracted arrays are copies and transposes: exact. Outputs and
logabsdet of one coupling: 1e-5 absolute, plus 2e-6 relative on the
inverse, the JAX package's own band for its affine kernel
(tests/ops/test_realnvp_fused.py: the inverse divides by scales down to
1e-3, which amplifies a one-ulp difference of the sigmoid). Flows, chains
and log_prob: 1e-4 absolute (the fp32 interop bar, MIGRATION.md); the cubic
family's logabsdet and log_prob 5e-4, the JAX package's bar for its cubic
kernel (tests/ops/test_pallas_cubic.py). Unfolded weights with ``wh_scale``
against the folded ones: 2e-5 (tests/test_torch_nsf_train.py). Loss 1e-4,
gradients 2e-4, three Adam steps 2e-4 on the losses and 5e-4 on the weights
(tests/ops/test_nsf_train.py). ``to_flow()`` round trip 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu.distributions import StandardNormal as JaxStandardNormal
from nflows_tpu.flows import SimpleRealNVP as JaxRealNVP
from nflows_tpu.flows.base import Flow as JaxFlow
from nflows_tpu.nn import nets as jax_nets
from nflows_tpu.ops.pallas import nsf_fused as jax_fused
from nflows_tpu.ops.pallas.nsf_flow_kernel import nsf_flow_kernel_call
from nflows_tpu.ops.pallas.nsf_train import FusedNSFTrainer as JaxTrainer
from nflows_tpu.transforms import coupling as jax_coupling
from nflows_tpu.transforms.base import CompositeTransform as JaxComposite
from nflows_tpu.transforms.permutations import Permutation as JaxPermutation
from nflows_tpu_torch import (
    CompiledFlow,
    Flow,
    NeuralSplineFlow,
    SimpleRealNVP,
    fused_trainer,
    load_jax_params,
    load_jax_trainer_weights,
)
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel, nsf_fused, nsf_train
from nflows_tpu_torch.transforms import (
    AdditiveCouplingTransform,
    AffineCouplingTransform,
    CompositeTransform,
    Permutation,
    PiecewiseCubicCouplingTransform,
    PiecewiseLinearCouplingTransform,
    PiecewiseLinearRationalCouplingTransform,
    PiecewiseQuadraticCouplingTransform,
    PiecewiseRationalQuadraticCouplingTransform,
)

torch.set_num_threads(1)

HIDDEN = 16
ATOL = 1e-4
KEYS = nsf_train.WEIGHT_KEYS
# kind -> (JAX class, port class, JAX scale activation, port scale activation)
AFFINE = {
    "affine": (jax_coupling.AffineCouplingTransform, AffineCouplingTransform,
               jax_coupling.AffineCouplingTransform.DEFAULT_SCALE_ACTIVATION,
               AffineCouplingTransform.DEFAULT_SCALE_ACTIVATION),
    "general": (jax_coupling.AffineCouplingTransform, AffineCouplingTransform,
                jax_coupling.AffineCouplingTransform.GENERAL_SCALE_ACTIVATION,
                AffineCouplingTransform.GENERAL_SCALE_ACTIVATION),
    "additive": (jax_coupling.AdditiveCouplingTransform, AdditiveCouplingTransform,
                 None, None),
}
SPLINES = {
    "rq": (jax_coupling.PiecewiseRationalQuadraticCouplingTransform,
           PiecewiseRationalQuadraticCouplingTransform),
    "lrs": (jax_coupling.PiecewiseLinearRationalCouplingTransform,
            PiecewiseLinearRationalCouplingTransform),
    "linear": (jax_coupling.PiecewiseLinearCouplingTransform,
               PiecewiseLinearCouplingTransform),
    "quadratic": (jax_coupling.PiecewiseQuadraticCouplingTransform,
                  PiecewiseQuadraticCouplingTransform),
    "cubic": (jax_coupling.PiecewiseCubicCouplingTransform,
              PiecewiseCubicCouplingTransform),
}
FAMILIES = sorted(SPLINES) + sorted(AFFINE)


def _load(jax_module, module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax_module)
    load_jax_params(module, {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    return module


def _jax_net(key):
    return lambda i, o: jax_nets.ResidualNet(i, o, hidden_features=HIDDEN, num_blocks=2,
                                             key=key)


def _net(i, o):
    return nets.ResidualNet(i, o, hidden_features=HIDDEN, num_blocks=2, device="cpu")


def _mask(features):
    mask = np.ones(features, dtype=np.float32)
    mask[::2] = -1
    return mask


def _coupling_kw(kind):
    """(JAX class, port class, JAX kwargs, port kwargs) of a family."""
    if kind in AFFINE:
        jcls, tcls, j_act, t_act = AFFINE[kind]
        if j_act is None:
            return jcls, tcls, {}, {}
        return jcls, tcls, dict(scale_activation=j_act), dict(scale_activation=t_act)
    jcls, tcls = SPLINES[kind]
    kw = dict(num_bins=4, tails="linear", tail_bound=3.0)
    return jcls, tcls, kw, kw


def _chain_pair(kind, features=6, layers=2, seed=0, permute=True):
    """``layers`` couplings of one family with flipping checkerboard masks
    (and random permutations between them when ``permute``), StandardNormal
    base, in both packages with the same weights."""
    jcls, tcls, jkw, tkw = _coupling_kw(kind)
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed), layers)
    mask = _mask(features)
    jchain, tchain = [], []
    for i in range(layers):
        if permute:
            perm = rng.permutation(features)
            jchain.append(JaxPermutation(perm))
            tchain.append(Permutation(perm, device="cpu"))
        jchain.append(jcls(mask=mask, transform_net_create_fn=_jax_net(keys[i]), **jkw))
        tchain.append(tcls(mask=mask, transform_net_create_fn=_net, device="cpu", **tkw))
        mask = -mask
    jflow = JaxFlow(transform=JaxComposite(jchain), distribution=JaxStandardNormal([features]))
    tflow = Flow(transform=CompositeTransform(tchain), distribution=StandardNormal([features]))
    return jflow, _load(jflow, tflow)


def _realnvp_pair(volume_preserving, features=6, layers=3, seed=0):
    cfg = dict(features=features, hidden_features=HIDDEN, num_layers=layers,
               num_blocks_per_layer=2, use_volume_preserving=volume_preserving)
    jflow = JaxRealNVP(key=jax.random.key(seed), **cfg)
    return jflow, _load(jflow, SimpleRealNVP(device="cpu", **cfg))


def _x(features=6, n=64, seed=1, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal((n, features))).astype(
        np.float32)


def _close(a, b, atol=ATOL, rtol=0.0):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


# -- the modules ---------------------------------------------------------------------


def test_scale_activations_match_jax():
    """Across the range, softplus's far tail included (F.softplus would turn
    linear above 20 where JAX's logaddexp does not)."""
    v = np.concatenate([np.linspace(-30, 30, 601), [-100.0, 100.0]]).astype(np.float32)
    for kind in ("affine", "general"):
        _, _, j_act, t_act = AFFINE[kind]
        _close(t_act(torch.from_numpy(v)), j_act(jnp.asarray(v)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kind", sorted(AFFINE))
@pytest.mark.parametrize("features", [5, 6])
def test_coupling_matches_jax(kind, features):
    jcls, tcls, jkw, tkw = _coupling_kw(kind)
    mask = _mask(features)
    jc = jcls(mask=mask, transform_net_create_fn=_jax_net(jax.random.key(features)), **jkw)
    tc = _load(jc, tcls(mask=mask, transform_net_create_fn=_net, device="cpu", **tkw))
    x = _x(features, seed=2)
    with torch.no_grad():
        y, lad = tc.forward(torch.from_numpy(x))
        x_back, lad_inv = tc.inverse(y)
        z, z_lad = tc.inverse(torch.from_numpy(x))
    j_y, j_lad = jc.forward(x)
    j_z, j_z_lad = jc.inverse(x)
    _close(y, j_y, 1e-5)
    _close(lad, j_lad, 1e-5)
    _close(z, j_z, 1e-5, 2e-6)
    _close(z_lad, j_z_lad, 1e-5, 2e-6)
    _close(x_back, x, 1e-5)
    _close(lad + lad_inv, np.zeros(len(x)), 1e-5)
    if kind == "additive":
        assert not lad.any()


@pytest.mark.parametrize("volume_preserving", [False, True])
@pytest.mark.parametrize("features", [5, 6])
def test_realnvp_matches_jax(volume_preserving, features):
    jflow, tflow = _realnvp_pair(volume_preserving, features, seed=features)
    x = _x(features, seed=3)
    z = _x(features, seed=4, scale=1.0)
    assert all(isinstance(t, AdditiveCouplingTransform if volume_preserving
                          else AffineCouplingTransform) for t in tflow.transform.transforms)
    with torch.no_grad():
        _close(tflow.log_prob(torch.from_numpy(x)), jflow.log_prob(x))
        _close(tflow.transform_to_noise(torch.from_numpy(x)), jflow.transform_to_noise(x))
        # sampling: the same base noise through both inverse chains
        s, s_lad = tflow.transform.inverse(torch.from_numpy(z))
    j_s, j_lad = jflow.transform.inverse(z)
    _close(s, j_s)
    _close(s_lad, j_lad)


@pytest.mark.parametrize("activate_output", [False, True])
def test_mlp_matches_jax(activate_output):
    from nflows_tpu.nn.nets import MLP as JaxMLP

    jmlp = JaxMLP((3, 2), (2, 4), [8, 8, 5], key=jax.random.key(2),
                  activate_output=activate_output)
    tmlp = _load(jmlp, nets.MLP((3, 2), (2, 4), [8, 8, 5], activate_output=activate_output))
    x = _x(6, n=10, seed=5).reshape(10, 3, 2)
    with torch.no_grad():
        out = tmlp(torch.from_numpy(x))
    assert out.shape == (10, 2, 4)
    _close(out, jmlp(x), 1e-6)
    if activate_output:
        assert (out >= 0).all()
    with pytest.raises(ValueError, match="Expected inputs of shape"):
        tmlp(torch.zeros(10, 6))
    with pytest.raises(ValueError, match="can't be empty"):
        nets.MLP((3,), (2,), [])


def test_what_realnvp_refuses():
    """Nothing of the reference's options now: batch norm between the
    couplings and inside their conditioners builds and holds against JAX in
    training mode, on parameters moved off their identity start (more in
    tests/test_torch_normalization.py)."""
    for kw in (dict(batch_norm_between_layers=True), dict(batch_norm_within_layers=True)):
        jflow = JaxRealNVP(6, HIDDEN, 2, 2, key=jax.random.key(0), **kw)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(jflow)
        rng = np.random.default_rng(1)
        jflow = jax.tree_util.tree_unflatten(treedef, [
            v + 0.2 * rng.standard_normal(v.shape).astype(np.float32)
            if jnp.issubdtype(v.dtype, jnp.floating) and "running_" not in
            jax.tree_util.keystr(p) else v for p, v in leaves])
        tflow = _load(jflow, SimpleRealNVP(6, HIDDEN, 2, 2, device="cpu", **kw))
        x = _x(n=33)
        with torch.no_grad():
            _close(tflow.log_prob(torch.from_numpy(x)), jflow.log_prob(jnp.asarray(x)))


# -- B2 for every family ---------------------------------------------------------------


@pytest.fixture(scope="module")
def chains():
    """A small chain of each family in both packages: SimpleRealNVP for the
    affine and additive couplings (no permutations), GENERAL-activation
    affine couplings without permutations, and the five spline families with
    a random permutation before each coupling."""
    out = {"affine": _realnvp_pair(False, layers=2), "additive": _realnvp_pair(True, layers=2),
           "general": _chain_pair("general", permute=False)}
    for family in SPLINES:
        out[family] = _chain_pair(family)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_extract_and_plain_chain_match_the_jax_kernel(chains, family):
    """One case a family: the port's ``_extract`` against the JAX one, then
    B2's plain version against the JAX whole-chain kernel in interpret mode
    (the forward; both directions against the XLA chain below)."""
    jflow, tflow = chains[family]
    j_idx, j_w, j_static, j_feat, _ = jax_fused._extract(jflow, jnp.float32)
    t_idx, t_w, t_static, t_feat, _ = nsf_fused._extract(tflow, torch.float32)
    assert [tuple(i) for i in t_idx] == [tuple(i) for i in j_idx]
    assert sorted(t_w) == sorted(j_w) and t_feat == j_feat
    for name in j_w:
        np.testing.assert_array_equal(t_w[name].numpy(), np.asarray(j_w[name]), err_msg=name)
    assert t_static == j_static
    x = _x(seed=6, scale=2.0)
    y_t, lad = nsf_flow_kernel_call(
        jnp.asarray(x.T), j_w["w0"], j_w["b0"], j_w["wb"], j_w["bb"], j_w["wf"], j_w["bf"],
        j_idx, inverse=False, lanes=64, interpret=True, **j_static)
    y, lad_t = nsf_flow_kernel.nsf_flow_kernel_plain(
        torch.from_numpy(x), t_w, t_idx, inverse=False, **t_static)
    _close(y, np.asarray(y_t).T)
    _close(lad_t, np.asarray(lad)[0], 5e-4 if family == "cubic" else ATOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_view_matches_the_jax_chain(chains, family):
    """``fuse_nsf`` (B2's plain version here) against the JAX XLA chain, both
    directions, and ``CompiledFlow``, which fuses every family."""
    jflow, tflow = chains[family]
    fused = tflow.fused() if isinstance(tflow, NeuralSplineFlow) else nsf_fused.fuse_nsf(tflow)
    x = _x(seed=7, scale=2.0)
    lad_atol = 5e-4 if family == "cubic" else ATOL
    with torch.no_grad():
        for direction in ("forward", "inverse"):
            y, lad = getattr(fused, direction)(torch.from_numpy(x))
            j_y, j_lad = getattr(jflow.transform, direction)(x)
            _close(y, j_y, ATOL, 2e-6)
            _close(lad, j_lad, lad_atol, 2e-6)
        served = CompiledFlow(tflow, batch_size=64, features=6, device="cpu")
        assert served.is_fused
        _close(served.log_prob(torch.from_numpy(x)), jflow.log_prob(x), lad_atol)


@pytest.mark.parametrize("family", FAMILIES)
def test_wh_scale_equals_the_folded_weights(chains, family):
    """The trainers' unfolded weights with the family's ``wh_scale`` give the
    folded chain: 2KT rows for rq, lrs and cubic, every row for quadratic
    (2K-1 parameters a feature, fewer than 2K), none for the others."""
    _, tflow = chains[family]
    idx, folded, static, _, _ = nsf_fused._extract(tflow, torch.float32)
    _, unfolded, _, _, _ = nsf_fused._extract(tflow, torch.float32, fold_wh_scale=False)
    wh_scale = nsf_train.family_wh_scale(static, HIDDEN)
    assert (wh_scale is None) == (family in ("linear", "affine", "general", "additive"))
    assert torch.equal(unfolded["wf"], folded["wf"]) == (wh_scale is None)
    x = torch.from_numpy(_x(seed=8, n=40))
    for inverse in (False, True):
        y, lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, folded, idx, inverse=inverse,
                                                       **static)
        y_s, lad_s = nsf_flow_kernel.nsf_flow_kernel_cuda(
            x, unfolded, idx, inverse=inverse, wh_scale=wh_scale, **static)
        _close(y_s, y, 2e-5)
        _close(lad_s, lad, 2e-5)


# -- B3 and B4 for the affine and additive couplings -------------------------------------


def _jax_chain_loss(static, layer_indices, features, wh_scale=None):
    """The JAX package's training loss on kernel-layout weights, in XLA: its
    traced layer functions (nsf_train.py ``_make_layer_fn``, the math its
    training kernels differentiate with jax.vjp) chained outside a kernel,
    with the family's softmax rescale ``wh_scale`` of unfolded weights."""
    from nflows_tpu.ops.pallas.nsf_train import _family_spline_config, _make_layer_fn

    spline_kw, _, name, _ = _family_spline_config(static)
    nb2 = 2 * static["num_blocks"]
    fns = [_make_layer_fn(li, name, static.get("num_bins", 0), static["num_blocks"], wh_scale,
                          spline_kw) for li in layer_indices]

    def loss(w, x_t):
        lad = 0.0
        for l, fn in enumerate(fns):
            ws = ([w["w0"][l], w["b0"][l]] + [w["wb"][l, j] for j in range(nb2)]
                  + [w["bb"][l, j] for j in range(nb2)] + [w["wf"][l], w["bf"][l]])
            x_t, layer_lad = fn(x_t, *ws)
            lad = lad + layer_lad[0]
        lp = -0.5 * jnp.sum(x_t * x_t, axis=0) - 0.5 * features * np.log(2 * np.pi) + lad
        return -jnp.mean(lp)
    return loss


@pytest.mark.parametrize("kind", sorted(AFFINE) + ["cubic", "linear", "lrs", "quadratic"])
def test_plain_b3_b4_match_jax_grad(chains, kind):
    jflow, tflow = chains[kind]
    j_idx, j_w, j_static, _, _ = jax_fused._extract(jflow, jnp.float32, fold_wh_scale=False)
    ttr = nsf_train.FusedNSFTrainer(tflow, batch_size=128)
    assert ttr._static["spline"] == {"additive": "additive", "general": "affine"}.get(kind, kind)
    assert (ttr._wh_scale is None) == (kind in ("linear",) + tuple(AFFINE))
    x = _x(n=128, seed=9)
    j_loss, (j_gw, j_gx_t) = jax.jit(jax.value_and_grad(
        _jax_chain_loss(j_static, j_idx, 6, ttr._wh_scale), argnums=(0, 1)))(
            j_w, jnp.asarray(x.T))
    xt = torch.from_numpy(x)
    loss, lp, grads = nsf_train.nsf_loss_grad_cuda(xt, ttr.weights, ttr._indices,
                                                   wh_scale=ttr._wh_scale, **ttr._static)
    _close(loss, j_loss, 1e-4)
    _close(lp, jflow.log_prob(x), 5e-4 if kind == "cubic" else ATOL)
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_gw[k]), atol=2e-4,
                                   rtol=0, err_msg=k)
    n = x.shape[0]
    with torch.no_grad():
        y, _ = nsf_train.nsf_train_apply(ttr.weights, xt, ttr._indices, ttr._static,
                                         ttr._wh_scale)
    gx, grads = nsf_train.nsf_train_bwd_cuda(xt, y / n, torch.full((n,), -1.0 / n),
                                             ttr.weights, ttr._indices, wh_scale=ttr._wh_scale,
                                             **ttr._static)
    _close(gx, np.asarray(j_gx_t).T, 2e-4)
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_gw[k]), atol=2e-4,
                                   rtol=0, err_msg=k)


def test_three_adam_steps_match_the_jax_trainer():
    jflow, tflow = _realnvp_pair(False, layers=2, seed=11)
    jtr = JaxTrainer(jflow, batch_size=128, interpret=True)
    opt = optax.adam(1e-2)
    jstep = jtr.make_train_step(opt, donate=False)
    weights, opt_state = jtr.weights, jtr.init_opt(opt)
    ttr = fused_trainer(tflow, 128)
    load_jax_trainer_weights(ttr, {k: np.asarray(v) for k, v in jtr.weights.items()})
    tstep = ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)))
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _x(n=128, seed=20 + i)
        weights, opt_state, loss = jstep(weights, opt_state, jnp.asarray(batch))
        j_losses.append(float(loss))
        t_losses.append(float(tstep(torch.from_numpy(batch))))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    for k in KEYS:
        np.testing.assert_allclose(ttr.weights[k].detach().numpy(), np.asarray(weights[k]),
                                   atol=5e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", sorted(AFFINE))
def test_to_flow_round_trip(chains, kind):
    """RealNVP's layers are (None, coupling) pairs: the identity permutation."""
    _, tflow = chains[kind]
    assert all(perm is None for perm, _ in nsf_fused._layer_groups(tflow.transform))
    ttr = fused_trainer(tflow, 128)
    x = torch.from_numpy(_x(n=128, seed=12))
    with torch.no_grad():
        _close(ttr.to_flow().log_prob(x), tflow.log_prob(x), 1e-5)
    ttr.make_train_step(ttr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-2)))(x)
    with torch.no_grad():
        trained = ttr.to_flow().log_prob(x)
        assert (trained - tflow.log_prob(x)).abs().max() > 1e-3
        _close(-trained.mean(), ttr.loss_fn(ttr.weights, x), 1e-5)


@pytest.mark.parametrize("family", ["cubic", "linear", "lrs", "quadratic"])
def test_training_kernels_refuse_the_spline_families(chains, family):
    """B3 and B4 have these stages' adjoints: ``fused_trainer`` gives a
    ``FusedNSFTrainer`` that runs them, with the family's softmax rescale,
    and so it does for the conditional twin, whose context it demands. What
    the fused trainers still refuse is a conditional flow with an embedding
    net, on every device, naming the eager route."""
    _, tflow = chains[family]
    trainer = fused_trainer(tflow, 128)
    assert isinstance(trainer, nsf_train.FusedNSFTrainer)
    assert trainer._static["spline"] == family
    assert (trainer._wh_scale is None) == (family == "linear")
    assert nsf_fused.can_fuse_nsf(tflow)
    _, tcls, _, tkw = _coupling_kw(family)
    conditional = Flow(CompositeTransform([
        Permutation(np.arange(6)[::-1].copy(), device="cpu"),
        tcls(mask=_mask(6), transform_net_create_fn=lambda i, o: nets.ResidualNet(
            i, o, hidden_features=HIDDEN, context_features=2, num_blocks=2, device="cpu"),
            device="cpu", **tkw)]), StandardNormal([6]))
    trainer = fused_trainer(conditional, 128)
    assert isinstance(trainer, nsf_train.FusedNSFTrainer) and trainer.context_features == 2
    with pytest.raises(ValueError, match="pass the context"):
        trainer.loss_fn(trainer.weights, torch.from_numpy(_x(n=128)))
    embedded = Flow(conditional.transform, conditional.distribution,
                    embedding_net=torch.nn.Linear(4, 2))
    with pytest.raises(ValueError, match="make_train_step(.|\\n)*embedding_net"):
        fused_trainer(embedded, 128)
    with pytest.raises(ValueError, match="embedding_net"):
        nsf_train.FusedNSFTrainer(embedded, batch_size=128)


def test_fused_method_and_what_fuse_nsf_refuses():
    flow = NeuralSplineFlow(6, HIDDEN, num_layers=2, num_bins=4, device="cpu")
    assert isinstance(flow.fused(), nsf_fused.FusedNSF)
    # bf16, the JAX package's default, is ported; other dtypes are refused
    assert flow.fused(torch.bfloat16)._weights["wf"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flow.fused(torch.float16)
    other = AffineCouplingTransform(_mask(6), _net, scale_activation=torch.sigmoid, device="cpu")
    other_flow = Flow(CompositeTransform([other]), StandardNormal([6]))
    with pytest.raises(ValueError, match="DEFAULT/GENERAL"):
        nsf_fused.fuse_nsf(other_flow)
    mixed = Flow(CompositeTransform([copy.deepcopy(other), AdditiveCouplingTransform(
        _mask(6), _net, device="cpu")]), StandardNormal([6]))
    mixed.transform.transforms[0].scale_activation = AffineCouplingTransform.DEFAULT_SCALE_ACTIVATION
    with pytest.raises(ValueError, match="homogeneous"):
        nsf_fused.fuse_nsf(mixed)
