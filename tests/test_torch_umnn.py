"""The port's UMNN transforms (``nflows_tpu_torch.transforms.umnn``, the
``UMNN`` alias package, ``MaskedUMNNAutoregressiveTransform`` and
``UMNNCouplingTransform``) against the JAX package's on the CPU, after
``load_jax_params``, at a small size (integrand [16, 16], cond_size 3,
nb_steps 12): the Clenshaw-Curtis nodes and weights, the normalizer's
forward (z, jac) and its bisection inverse, the autoregressive transform
with and without a context, the coupling with and without the
unconditional normalizer on its identity half, and the import paths.

Tolerances: 1e-4 absolute on outputs, jacobians and logabsdet (the fp32
interop bar, MIGRATION.md). The inverse is 25 halvings of [-20, 20], whose
last interval is 1.2e-6 wide; a comparison that a rounding flips on a tie
lands within that interval, so the inverse holds to the same 1e-4 (the
autoregressive inverse 2e-4, as tests/test_torch_autoregressive.py holds
its D passes).
"""

import jax
import numpy as np
import pytest
import torch

from nflows_tpu.nn import nets as jax_nets
from nflows_tpu.transforms import autoregressive as jax_ar
from nflows_tpu.transforms import coupling as jax_coupling
from nflows_tpu.transforms import umnn as jax_umnn
from nflows_tpu_torch import load_jax_params
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.transforms import (
    MaskedUMNNAutoregressiveTransform,
    UMNNCouplingTransform,
    umnn,
)

torch.set_num_threads(1)

ATOL = 1e-4
LAYERS = [16, 16]
COND = 3
STEPS = 12


def _load(jmod, tmod):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jmod)
    load_jax_params(tmod, {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    return tmod


def _close(a, b, atol=ATOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("steps", [7, 12, 20])
def test_cc_nodes_weights_equal_jax(steps):
    nodes, weights = umnn.cc_nodes_weights(steps)
    j_nodes, j_weights = jax_umnn.cc_nodes_weights(steps)
    assert nodes.dtype == weights.dtype == np.float32
    np.testing.assert_array_equal(nodes, j_nodes)
    np.testing.assert_array_equal(weights, j_weights)
    assert nodes[0] == 1.0 and weights.sum() == pytest.approx(2.0, abs=1e-6)


def _normalizer_pair(cond=COND, seed=0):
    jn = jax_umnn.MonotonicNormalizer(LAYERS, cond, STEPS, key=jax.random.key(seed))
    return jn, _load(jn, umnn.MonotonicNormalizer(LAYERS, cond, STEPS))


@pytest.mark.parametrize("cond", [COND, 0])
def test_normalizer_forward_and_inverse_match_jax(cond):
    jn, tn = _normalizer_pair(cond)
    assert set(tn.state_dict()) == {f"integrand_net.layers.{i}.{w}"
                                    for i in range(3) for w in ("weight", "bias")}
    x = _normal(1, (33, 4), 2.0)
    h = _normal(2, (33, 4, cond))
    with torch.no_grad():
        z, jac = tn.forward(torch.from_numpy(x), torch.from_numpy(h))
        back = tn.inverse_transform(z, torch.from_numpy(h))
    j_z, j_jac = jn.forward(x, h)
    _close(z, j_z)
    _close(jac, j_jac)
    assert (jac > 0).all()
    _close(back, jn.inverse_transform(np.asarray(j_z), h))
    _close(back, x)


def test_normalizer_offset_jacobian_and_bisection():
    """z(0) is h's channel 0 (zero without conditioning); the jacobian is
    the integrand at node 0, which is x itself; the inverse is exactly 25
    forwards (the halvings) on [-20, 20]."""
    _, tn = _normalizer_pair()
    x = torch.from_numpy(_normal(3, (8, 4)))
    h = torch.from_numpy(_normal(4, (8, 4, COND)))
    with torch.no_grad():
        z0, _ = tn.forward(torch.zeros_like(x), h)
        assert torch.equal(z0, h[:, :, 0])
        _, jac = tn.forward(x, h)
        assert torch.equal(jac, tn.integrand_net(x, h))
    assert float(tn.nodes[0]) == 1.0
    calls = []
    forward = tn.forward
    tn.forward = lambda *a, **k: calls.append(1) or forward(*a, **k)
    with torch.no_grad():
        far = tn.inverse_transform(torch.full_like(x, 1e6), h)
    assert len(calls) == 25
    assert torch.allclose(far, torch.full_like(x, 20.0), atol=1e-5)


def test_umnn_import_paths():
    from nflows_tpu_torch.transforms import IntegrandNet, MonotonicNormalizer
    from nflows_tpu_torch.transforms import UMNN
    from nflows_tpu_torch.transforms.UMNN import MonotonicNormalizer as from_package
    from nflows_tpu_torch.transforms.UMNN.MonotonicNormalizer import (
        IntegrandNet as from_module,
    )

    assert from_package is MonotonicNormalizer is umnn.MonotonicNormalizer
    assert from_module is IntegrandNet is umnn.IntegrandNet
    assert UMNN.__all__ == ["MonotonicNormalizer", "IntegrandNet"]


@pytest.mark.parametrize("context_features", [None, 2])
def test_masked_umnn_autoregressive_transform_matches_jax(context_features):
    kw = dict(features=3, hidden_features=16, context_features=context_features,
              integrand_net_layers=LAYERS, cond_size=COND, nb_steps=STEPS)
    jt = jax_ar.MaskedUMNNAutoregressiveTransform(key=jax.random.key(5), **kw)
    tt = _load(jt, MaskedUMNNAutoregressiveTransform(device="cpu", **kw)).eval()
    x = _normal(6, (17, 3), 1.5)
    ctx = None if context_features is None else _normal(7, (17, context_features))
    tctx = None if ctx is None else torch.from_numpy(ctx)
    with torch.no_grad():
        y, lad = tt.forward(torch.from_numpy(x), tctx)
        back, lad_back = tt.inverse(y, tctx)
    j_y, j_lad = jt.forward(x, ctx)
    j_back, j_lad_back = jt.inverse(np.asarray(j_y), ctx)
    _close(y, j_y)
    _close(lad, j_lad)
    _close(back, j_back, 2e-4)
    _close(lad_back, j_lad_back, 2e-4)
    _close(back, x, 2e-4)


def _coupling_pair(apply_unconditional_transform, seed=0):
    mask = np.array([1, -1, 1, -1, 1], dtype=np.float32)
    key = jax.random.key(seed)
    kw = dict(mask=mask, integrand_net_layers=LAYERS, cond_size=COND, nb_steps=STEPS,
              apply_unconditional_transform=apply_unconditional_transform)
    jc = jax_coupling.UMNNCouplingTransform(
        transform_net_create_fn=lambda i, o: jax_nets.ResidualNet(
            i, o, hidden_features=16, num_blocks=1, key=key), key=key, **kw)
    tc = UMNNCouplingTransform(
        transform_net_create_fn=lambda i, o: nets.ResidualNet(
            i, o, hidden_features=16, num_blocks=1, device="cpu"), device="cpu", **kw)
    return jc, _load(jc, tc)


@pytest.mark.parametrize("apply_unconditional_transform", [False, True])
def test_umnn_coupling_matches_jax(apply_unconditional_transform):
    jc, tc = _coupling_pair(apply_unconditional_transform)
    assert (tc.unconditional_transform is None) != apply_unconditional_transform
    x = _normal(8, (17, 5), 1.5)
    with torch.no_grad():
        y, lad = tc.forward(torch.from_numpy(x))
        back, lad_back = tc.inverse(y)
    j_y, j_lad = jc.forward(x)
    j_back, j_lad_back = jc.inverse(np.asarray(j_y))
    _close(y, j_y)
    _close(lad, j_lad)
    _close(back, j_back)
    _close(lad_back, j_lad_back)
    _close(back, x)
    _close(lad_back, -lad.numpy())
    if not apply_unconditional_transform:
        # the identity half passes through untouched
        assert torch.equal(y[:, 1::2], torch.from_numpy(x)[:, 1::2])


def test_umnn_coupling_refuses_images():
    _, tc = _coupling_pair(False)
    with pytest.raises(NotImplementedError):
        tc.forward(torch.zeros(2, 5, 4, 4))


def test_no_fuser_takes_a_umnn_flow():
    """B2 has no UMNN stage and B9 no UMNN transformer: ``fuse_nsf`` and
    ``fuse_maf`` refuse the UMNN coupling and autoregressive flows, which
    CompiledFlow serves unfused, and no fused trainer takes them."""
    from nflows_tpu_torch import CompiledFlow, Flow, fused_trainer
    from nflows_tpu_torch.distributions import StandardNormal
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf
    from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf
    from nflows_tpu_torch.transforms import CompositeTransform, ReversePermutation

    _, coupling = _coupling_pair(True)
    ar = MaskedUMNNAutoregressiveTransform(5, 16, integrand_net_layers=LAYERS, cond_size=COND,
                                           nb_steps=STEPS, device="cpu")
    for layer, fuser, reason in ((coupling, fuse_nsf, "is not fused"),
                                 (ar, fuse_maf, "only affine / RQ-spline")):
        flow = Flow(CompositeTransform([ReversePermutation(5, device="cpu"), layer]),
                    StandardNormal([5]))
        with pytest.raises(ValueError, match=reason):
            fuser(flow)
        served = CompiledFlow(flow, batch_size=16, features=5, device="cpu")
        assert not served.is_fused
        x = torch.from_numpy(_normal(9, (16, 5)))
        with torch.no_grad():
            assert torch.equal(served.log_prob(x), flow.log_prob(x))
        assert fused_trainer(flow, 128, required=False) is None
