"""Kernel B2's host side on the CPU: the port's ``_extract`` against the JAX
package's, and B2's plain version against the JAX whole-chain Pallas
kernel in interpret mode, on the same weights and inputs.

Tolerance: the extracted arrays are copies and transposes, compared
exactly; chain outputs and logabsdet atol 1e-4, rtol 0 (fp32 interop bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.models import NeuralSplineFlow as JaxNSF
from nflows_tpu.ops.pallas import nsf_fused as jax_fused
from nflows_tpu.ops.pallas.nsf_flow_kernel import nsf_flow_kernel_call
from nflows_tpu_torch import NeuralSplineFlow, load_jax_params
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel, nsf_fused

torch.set_num_threads(1)

ATOL = 1e-4
CFG = dict(features=6, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
           num_bins=8, tail_bound=3.0, stacked=False)


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


@pytest.fixture(scope="module")
def flows():
    return _pair()


@pytest.mark.parametrize("features,stacked", [(6, False), (6, None), (5, None)])
def test_extract_matches_jax(features, stacked):
    """Odd features with the default ``stacked`` pin the mask parity in both
    packages; the JAX side is then a scan-stacked chain."""
    jflow, tflow = _pair(seed=features, features=features, stacked=stacked)
    j_idx, j_w, j_static, j_feat, j_ctx = jax_fused._extract(jflow, jnp.float32)
    t_idx, t_w, t_static, t_feat, t_ctx = nsf_fused._extract(tflow, torch.float32)
    assert [tuple(i) for i in t_idx] == [tuple(i) for i in j_idx]
    assert t_idx[0]._fields == j_idx[0]._fields
    assert sorted(t_w) == sorted(j_w)
    for name in j_w:
        np.testing.assert_array_equal(t_w[name].numpy(), np.asarray(j_w[name]))
    assert (t_feat, t_ctx) == (j_feat, j_ctx)
    for key, value in t_static.items():
        assert j_static[key] == value


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [256, 203])
def test_plain_chain_matches_jax_kernel(flows, inverse, n):
    jflow, tflow = flows
    j_idx, j_w, j_static, _, _ = jax_fused._extract(jflow, jnp.float32)
    t_idx, t_w, t_static, _, _ = nsf_fused._extract(tflow, torch.float32)
    x = (2.0 * np.random.default_rng(n).standard_normal((n, 6))).astype(np.float32)
    pad = (-n) % 128
    x_t = jnp.pad(jnp.asarray(x.T), ((0, 0), (0, pad)))
    y_t, lad = nsf_flow_kernel_call(
        x_t, j_w["w0"], j_w["b0"], j_w["wb"], j_w["bb"], j_w["wf"], j_w["bf"],
        j_idx, inverse=inverse, lanes=128, interpret=True, **j_static)
    y, lad_t = nsf_flow_kernel.nsf_flow_kernel_plain(
        torch.from_numpy(x), t_w, t_idx, inverse=inverse, **t_static)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_t)[:, :n].T, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lad_t.numpy(), np.asarray(lad)[0, :n], atol=ATOL, rtol=0)


def test_wrapper_on_cpu_runs_plain_and_round_trips(flows):
    _, tflow = flows
    t_idx, t_w, t_static, _, _ = nsf_fused._extract(tflow, torch.float32)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((70, 6)).astype(np.float32))
    before = nsf_flow_kernel.launch_count
    y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, t_w, t_idx, inverse=False, **t_static)
    assert nsf_flow_kernel.launch_count == before  # the plain version launches nothing
    x_rec, lad_inv = nsf_flow_kernel.nsf_flow_kernel_cuda(y, t_w, t_idx, inverse=True,
                                                          **t_static)
    np.testing.assert_allclose(x_rec.numpy(), x.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose((lad + lad_inv).numpy(), 0.0, atol=ATOL, rtol=0)


def test_pack_weights_layout(flows):
    """The kernel layout holds the same numbers: in-major matrices, the
    initial layer's inputs and final layer's outputs zero-padded to 4."""
    _, tflow = flows
    t_idx, t_w, _, _, _ = nsf_fused._extract(tflow, torch.float32)
    p = nsf_flow_kernel.pack_weights(t_w, t_idx)
    L, H, Tid = t_w["w0"].shape
    TM = t_w["wf"].shape[1]
    assert p["w0"].shape == (L, 4, H) and p["wf"].shape == (L, H, 72)
    assert torch.equal(p["w0"][:, :Tid], t_w["w0"].transpose(1, 2))
    assert not p["w0"][:, Tid:].any() and not p["wf"][:, :, TM:].any()
    assert torch.equal(p["wb"], t_w["wb"].transpose(2, 3))
    assert torch.equal(p["wf"][:, :, :TM], t_w["wf"].transpose(1, 2))
    assert torch.equal(p["bf"][:, :TM], t_w["bf"][..., 0])
    assert p["idx"].dtype == torch.int32 and p["idx"].shape == (L, 2 * 6 + 2 * 6)
    assert p["idx"][0].tolist() == [i for f in t_idx[0] for i in f]
