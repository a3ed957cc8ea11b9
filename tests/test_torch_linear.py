"""The port's invertible linear transforms (``NaiveLinear``, ``LULinear``,
``QRLinear``, ``SVDLinear``, ``HouseholderSequence``), their caches and
``precompute_linear_caches``, and NSF-AR with ``use_linear_layers=True``
against the JAX package on the CPU, on carried parameters and the same
numpy inputs.

Most of these transforms are the identity, or close to it, when built (the
LU and SVD starts, NaiveLinear's orthogonal start, Householder pairs that
cancel), so every JAX parameter is first moved by seeded numpy draws and
then carried by ``load_jax_params``.

Tolerances. Outputs, logabsdet, ``weight()``, ``weight_inverse()`` and the
flows' ``log_prob`` 1e-4, the interop bar between the two packages in fp32
(MIGRATION.md:32). The round trip inverse(forward(x)) and a cached map
against the uncached one 1e-5: both run in one package, and at these sizes
(D = 5 or 7, entries of order 1) fp32 rounding stays near 1e-6.
``HouseholderSequence.matrix()`` orthogonal to 1e-5. The NSF-AR samples
(its inverse, a fixed point of D MADE passes a layer) 2e-4, the bar of
tests/test_torch_autoregressive.py for the same inverse.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nflows_tpu import transforms as jax_transforms
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.training import create_train_state as jax_create_train_state
from nflows_tpu.training import make_train_step as jax_make_train_step
from nflows_tpu.utils import linalg as jax_linalg
from nflows_tpu_torch import (
    NeuralSplineFlowAR,
    create_train_state,
    load_jax_params,
    make_train_step,
)
from nflows_tpu_torch import transforms as torch_transforms
from nflows_tpu_torch.utils import linalg as torch_linalg

torch.set_num_threads(1)

BATCH = 33


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _perturbed(module, seed, scale=0.3, where=lambda key: True):
    """``module`` with every float leaf whose key ``where`` accepts moved by
    ``scale`` times a seeded standard normal draw."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(module)
    rng = np.random.default_rng(seed)
    moved = []
    for path, leaf in leaves:
        value = np.asarray(leaf)
        if np.issubdtype(value.dtype, np.floating) and where(jax.tree_util.keystr(path)):
            value = value + scale * rng.standard_normal(value.shape).astype(value.dtype)
        moved.append(jnp.asarray(value))
    return jax.tree_util.tree_unflatten(treedef, moved)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, atol):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# name -> (class name, constructor arguments)
LINEAR = {
    "naive_orthogonal": ("NaiveLinear", {}),
    "naive_uniform": ("NaiveLinear", dict(orthogonal_initialization=False)),
    "lu_identity": ("LULinear", {}),
    "lu_random": ("LULinear", dict(identity_init=False)),
    "qr": ("QRLinear", dict(num_householder=3)),
    "svd_identity": ("SVDLinear", dict(num_householder=4)),
    "svd_random": ("SVDLinear", dict(num_householder=2, identity_init=False)),
}


def _pair(kind, features, seed=0):
    """A JAX linear transform with every parameter moved off its start, and
    the port's carrying its parameters."""
    name, kw = LINEAR[kind]
    jm = _perturbed(getattr(jax_transforms, name)(features, key=jax.random.key(seed), **kw),
                    seed=seed + 100)
    tm = getattr(torch_transforms, name)(
        features, generator=torch.Generator().manual_seed(seed), device="cpu", **kw)
    load_jax_params(tm, _jax_params(jm))
    return jm, tm


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("features", [5, 7])
@pytest.mark.parametrize("kind", sorted(LINEAR))
def test_linear_transform_matches_jax(kind, features, cached):
    jm, tm = _pair(kind, features, seed=features)
    if cached:
        jm = jm.precompute()
        assert tm.precompute() is tm and tm.using_cache
    x = _normal(1, (BATCH, features), scale=1.5)
    with torch.no_grad():
        out, lad = tm(_t(x))
        inv, ilad = tm.inverse(_t(x))
        back, blad = tm.inverse(out)
        weight, weight_inverse = tm.weight(), tm.weight_inverse()
    j_out, j_lad = jm(jnp.asarray(x))
    j_inv, j_ilad = jm.inverse(jnp.asarray(x))
    _close(out, j_out, 1e-4)
    _close(lad, j_lad, 1e-4)
    _close(inv, j_inv, 1e-4)
    _close(ilad, j_ilad, 1e-4)
    _close(weight, jm.weight(), 1e-4)
    _close(weight_inverse, jm.weight_inverse(), 1e-4)
    _close(tm.logabsdet().detach(), jm.logabsdet(), 1e-4)
    _close(back, x, 1e-5)
    _close(lad + blad, np.zeros(BATCH), 1e-5)
    # the map is not the identity: the test would prove little otherwise
    assert np.abs(np.asarray(out) - x).max() > 0.1
    assert np.abs(np.asarray(lad)).max() > 1e-2 or kind.startswith("naive_orth")


@pytest.mark.parametrize("kind", sorted(LINEAR))
def test_cache_agrees_with_the_uncached_map(kind):
    """precompute() fills the three caches in place; the cached forward and
    inverse are each one product and agree with the solves within 1e-5;
    invalidate_cache() empties them."""
    _, tm = _pair(kind, 6, seed=3)
    x = _t(_normal(2, (BATCH, 6), scale=1.5))
    with torch.no_grad():
        plain = tm(x), tm.inverse(x)
        assert tm.cache_weight is None and not tm.using_cache
        tm.precompute()
        assert tm.cache_weight.shape == (6, 6) and tm.cache_logabsdet.shape == ()
        cached = tm(x), tm.inverse(x)
    for (a, la), (b, lb) in zip(plain, cached):
        _close(a, b, 1e-5)
        _close(la, lb, 1e-5)
    # the caches are not in the state dict
    assert not any(k.startswith("cache_") for k in tm.state_dict())
    assert tm.invalidate_cache() is tm
    assert tm.cache_weight is None and tm.cache_inverse is None and not tm.using_cache


def test_load_takes_a_precomputed_jax_linear_s_caches():
    """A JAX Linear after precompute() carries its caches as leaves; the
    loader writes them into the port's caches and sets using_cache, so the
    port serves from JAX's caches."""
    jm, _ = _pair("lu_random", 5, seed=4)
    jm = jm.precompute()
    params = _jax_params(jm)
    assert {".cache_weight", ".cache_inverse", ".cache_logabsdet"} <= set(params)
    tm = torch_transforms.LULinear(5, device="cpu")
    load_jax_params(tm, params)
    assert tm.using_cache
    np.testing.assert_array_equal(tm.cache_inverse.numpy(), params[".cache_inverse"])
    x = _normal(5, (BATCH, 5))
    with torch.no_grad():
        _close(tm(_t(x))[0], jm(jnp.asarray(x))[0], 1e-5)
        _close(tm.inverse(_t(x))[0], jm.inverse(jnp.asarray(x))[0], 1e-5)
    partial = {k: v for k, v in params.items() if k != ".cache_inverse"}
    with pytest.raises(KeyError, match="Linear caches"):
        load_jax_params(torch_transforms.LULinear(5, device="cpu"), partial)


@pytest.mark.parametrize("num_transforms", [1, 4, 5])
def test_householder_sequence_matches_jax(num_transforms):
    jm = _perturbed(jax_transforms.HouseholderSequence(6, num_transforms), seed=num_transforms)
    tm = torch_transforms.HouseholderSequence(6, num_transforms, device="cpu")
    load_jax_params(tm, _jax_params(jm))
    x = _normal(6, (BATCH, 6))
    with torch.no_grad():
        out, lad = tm(_t(x))
        inv, _ = tm.inverse(_t(x))
        matrix = tm.matrix()
    _close(out, jm(jnp.asarray(x))[0], 1e-4)
    _close(inv, jm.inverse(jnp.asarray(x))[0], 1e-4)
    _close(lad, np.zeros(BATCH), 0)
    _close(matrix, jm.matrix(), 1e-4)
    _close(matrix @ matrix.T, np.eye(6), 1e-5)
    _close(tm.inverse(out)[0].detach(), x, 1e-5)
    assert np.abs(np.asarray(matrix) - np.eye(6)).max() > 0.1


def test_householder_start_is_the_identity_for_even_k():
    tm = torch_transforms.HouseholderSequence(5, 4, device="cpu")
    np.testing.assert_array_equal(tm.q_vectors.detach().numpy(),
                                  np.asarray(jax_transforms.HouseholderSequence(5, 4).q_vectors))
    _close(tm.matrix().detach(), np.eye(5), 1e-7)


def test_identity_starts_and_generator_draws():
    """LULinear and SVDLinear start as the identity, as in JAX; the random
    starts are drawn from the generator: one seed, one module."""
    x = _t(_normal(7, (BATCH, 5)))
    for m in (torch_transforms.LULinear(5, device="cpu"),
              torch_transforms.SVDLinear(5, 2, device="cpu")):
        with torch.no_grad():
            out, lad = m(x)
        _close(out, x, 1e-6)
        _close(lad, np.zeros(BATCH), 1e-6)
    for name, kw in (("NaiveLinear", {}), ("LULinear", dict(identity_init=False)),
                     ("QRLinear", dict(num_householder=2)),
                     ("SVDLinear", dict(num_householder=2, identity_init=False))):
        cls = getattr(torch_transforms, name)
        a, b = (cls(5, generator=torch.Generator().manual_seed(9), device="cpu", **kw)
                for _ in range(2))
        for pa, pb in zip(a.parameters(), b.parameters()):
            assert torch.equal(pa, pb)
    naive = torch_transforms.NaiveLinear(5, generator=torch.Generator().manual_seed(1),
                                         device="cpu")
    _close(naive.weight_param.detach() @ naive.weight_param.detach().T, np.eye(5), 1e-5)
    with pytest.raises(AssertionError):
        torch_transforms.SVDLinear(5, 3, device="cpu")
    with pytest.raises(TypeError):
        torch_transforms.LULinear(0, device="cpu")


def test_linalg_helpers():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    _close(torch_linalg.logabsdet(_t(a)), jax_linalg.logabsdet(jnp.asarray(a)), 1e-5)
    q = torch_linalg.random_orthogonal(6, generator=torch.Generator().manual_seed(0))
    _close(q @ q.T, np.eye(6), 1e-5)
    q2 = torch_linalg.random_orthogonal(6, generator=torch.Generator().manual_seed(0))
    assert torch.equal(q, q2)
    # the sign correction: Q's columns make R's diagonal positive
    _, r = torch.linalg.qr(torch.randn(6, 6, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(q, torch.linalg.qr(torch.randn(
        6, 6, generator=torch.Generator().manual_seed(0)))[0] * torch.sign(torch.diagonal(r)))


def test_lu_builds_no_index_from_the_host():
    """The strict-triangle indices are buffers made at construction, in
    numpy's tril / triu order, not in the state dict, and move with the
    module."""
    m = torch_transforms.LULinear(5, device="cpu")
    rows, cols = np.tril_indices(5, -1)
    np.testing.assert_array_equal(m.lower_indices.numpy(), np.stack([rows, cols]))
    rows, cols = np.triu_indices(5, 1)
    np.testing.assert_array_equal(m.upper_indices.numpy(), np.stack([rows, cols]))
    assert set(m.state_dict()) == {"bias", "lower_entries", "upper_entries",
                                   "unconstrained_upper_diag"}
    assert m.double().lower_indices.dtype == torch.int64


# -- NSF-AR with use_linear_layers=True --------------------------------------------------

NSF_AR = dict(features=5, hidden_features=16, num_layers=2, num_blocks_per_layer=2,
              num_bins=4, tail_bound=3.0, use_linear_layers=True)


def _is_lu(key):
    return any(n in key for n in ("lower_entries", "upper_entries", "unconstrained_upper_diag")) \
        or key.endswith((".transforms[1].bias", ".transforms[4].bias"))


@pytest.fixture(scope="module")
def nsf_ar_lu():
    jflow = _perturbed(JaxNSFAR(key=jax.random.key(0), rng=np.random.default_rng(0), **NSF_AR),
                       seed=11, where=_is_lu)
    tflow = NeuralSplineFlowAR(device="cpu", rng=np.random.default_rng(0), **NSF_AR)
    assert isinstance(tflow.transform.transforms[1], torch_transforms.LULinear)
    assert [type(t).__name__ for t in tflow.transform.transforms] == \
        [type(t).__name__ for t in jflow.transform.transforms]
    load_jax_params(tflow, _jax_params(jflow))
    lu = tflow.transform.transforms[1]
    assert (lu.lower_entries.abs().max() > 0.1 and lu.bias.abs().max() > 0.1)
    return jflow, tflow


@pytest.mark.parametrize("cached", [False, True])
def test_nsf_ar_with_lu_layers_matches_jax(nsf_ar_lu, cached):
    jflow, tflow = nsf_ar_lu
    tflow = copy.deepcopy(tflow)
    if cached:
        jflow = jax_transforms.precompute_linear_caches(jflow)
        assert torch_transforms.precompute_linear_caches(tflow) is tflow
        assert all(m.using_cache for m in tflow.modules()
                   if isinstance(m, torch_transforms.Linear))
    x = _normal(3, (BATCH, 5), scale=1.5)
    z = _normal(4, (BATCH, 5))
    with torch.no_grad():
        _close(tflow.log_prob(_t(x)), jflow.log_prob(jnp.asarray(x)), 1e-4)
        samples, lad = tflow.transform.inverse(_t(z))
    j_samples, j_lad = jflow.transform.inverse(jnp.asarray(z))
    _close(samples, j_samples, 2e-4)
    _close(lad, j_lad, 2e-4)


def test_nsf_ar_with_lu_layers_trains_as_jax(nsf_ar_lu):
    """Two Adam steps (lr 1e-2) from carried weights: the losses within 2e-4,
    the bar of tests/test_torch_train.py, and the LU parameters moved alike
    (5e-4)."""
    jflow, tflow = nsf_ar_lu
    opt = optax.adam(1e-2)
    jstate = jax_create_train_state(jflow, opt)
    jstep = jax_make_train_step(opt, donate=False)
    state = create_train_state(copy.deepcopy(tflow),
                               lambda p: torch.optim.Adam(p, lr=1e-2))
    step = make_train_step()
    j_losses, t_losses = [], []
    for i in range(2):
        batch = _normal(20 + i, (128, 5), scale=1.5)
        jstate, jm = jstep(jstate, jnp.asarray(batch))
        state, tm = step(state, _t(batch))
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-4, rtol=0)
    lu = state.flow.transform.transforms[1]
    j_lu = jstate.flow.transform.transforms[1]
    _close(lu.lower_entries.detach(), j_lu.lower_entries, 5e-4)
    _close(lu.unconstrained_upper_diag.detach(), j_lu.unconstrained_upper_diag, 5e-4)
