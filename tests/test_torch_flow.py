"""The port's flagship flow and serving path against the JAX package on the
CPU: NeuralSplineFlow after load_jax_params, the unfused chain (kernel B1's
plain version inside every coupling) and CompiledFlow on both paths (the
fused one runs kernel B2's plain version), plus the errors serving raises.

The two packages draw different random numbers, so sampling is compared
by feeding the same numpy noise to both inverse chains. Tolerance: atol
1e-4, rtol 0 on outputs, logabsdet and log_prob (fp32 interop bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.models import NeuralSplineFlow as JaxNSF
from nflows_tpu.ops.pallas.nsf_fused import fuse_nsf as jax_fuse_nsf
from nflows_tpu.serving import CompiledFlow as JaxCompiledFlow
from nflows_tpu_torch import CompiledFlow, NeuralSplineFlow, load_jax_params
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel, rq_spline
from nflows_tpu_torch.ops.cuda.nsf_fused import can_fuse_nsf, fuse_nsf
from nflows_tpu_torch.transforms import InverseTransform

torch.set_num_threads(1)

ATOL = 1e-4
BATCH = 64
CFG = dict(features=6, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
           num_bins=8, tail_bound=3.0, stacked=False)


def _pair(seed=0, **overrides):
    cfg = {**CFG, **overrides}
    jflow = JaxNSF(key=jax.random.key(seed), rng=np.random.default_rng(seed), **cfg)
    tflow = NeuralSplineFlow(device="cpu", **cfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jflow)
    load_jax_params(tflow, {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    return jflow, tflow


@pytest.fixture(scope="module")
def flows():
    return _pair()


def _x(n=BATCH, seed=1, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal((n, 6))).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("random_permutations", [True, False])
def test_log_prob_and_noise_match_jax(flows, random_permutations):
    jflow, tflow = (flows if random_permutations
                    else _pair(seed=13, use_random_permutations=False))
    x = _x()
    with torch.no_grad():
        _close(tflow.log_prob(torch.from_numpy(x)), jflow.log_prob(x))
        _close(tflow.transform_to_noise(torch.from_numpy(x)), jflow.transform_to_noise(x))


def test_inverse_from_shared_noise_matches_jax(flows):
    jflow, tflow = flows
    z = _x(seed=2, scale=1.0)
    j_s, j_lad = jflow.transform.inverse(z)
    with torch.no_grad():
        t_s, t_lad = tflow.transform.inverse(torch.from_numpy(z))
    _close(t_s, j_s)
    _close(t_lad, j_lad)


def test_inverse_transform_swaps_directions(flows):
    _, tflow = flows
    coupling = tflow.transform.transforms[1]
    x = torch.from_numpy(_x(seed=14))
    with torch.no_grad():
        y, lad = InverseTransform(coupling).forward(x)
        y_ref, lad_ref = coupling.inverse(x)
        x_rec, lad_back = InverseTransform(coupling).inverse(y)
    assert torch.equal(y, y_ref) and torch.equal(lad, lad_ref)
    _close(x_rec, x)
    _close(lad + lad_back, np.zeros(BATCH))


def test_sample_and_log_prob_is_consistent(flows):
    _, tflow = flows
    with torch.no_grad():
        s, lp = tflow.sample_and_log_prob(torch.Generator().manual_seed(3), 40)
        _close(lp, tflow.log_prob(s))


def test_conditional_flow_matches_jax():
    jflow, tflow = _pair(seed=4, context_features=3)
    x = _x(seed=5)
    c = np.random.default_rng(6).standard_normal((BATCH, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tflow.log_prob(torch.from_numpy(x), torch.from_numpy(c)),
               jflow.log_prob(x, c))
        s = tflow.sample(torch.Generator().manual_seed(7), 5,
                         context=torch.from_numpy(c[:4]))
    assert s.shape == (4, 5, 6)


@pytest.mark.parametrize("use_fused", [True, False])
def test_compiled_flow_matches_jax(flows, use_fused):
    jflow, tflow = flows
    x = _x(seed=8)
    served = CompiledFlow(tflow, batch_size=BATCH, features=6,
                          use_fused=use_fused, device="cpu")
    assert served.is_fused == use_fused
    lp = served.log_prob(torch.from_numpy(x))
    if use_fused:
        ref = jax_fuse_nsf(jflow, dtype=jnp.float32, lanes=128, interpret=True)
        _close(lp, ref.log_prob(x))
    ref_served = JaxCompiledFlow(jflow, batch_size=BATCH, features=6,
                                 use_fused=False)
    _close(lp, ref_served.log_prob(x))
    s, slp = served.sample_and_log_prob(torch.Generator().manual_seed(9))
    assert s.shape == (BATCH, 6) and torch.isfinite(s).all()
    _close(slp, served.log_prob(s))
    assert served.sample(torch.Generator().manual_seed(9)).shape == (BATCH, 6)


def test_fused_view_matches_jax_fused_view(flows):
    jflow, tflow = flows
    ref = jax_fuse_nsf(jflow, dtype=jnp.float32, lanes=128, interpret=True)
    fused = fuse_nsf(tflow)
    z = _x(n=50, seed=10, scale=1.0)
    y, lad = fused.inverse(torch.from_numpy(z))
    j_y, j_lad = ref.inverse(z)
    _close(y, j_y)
    _close(lad, j_lad)


def test_serving_errors_match_jax(flows):
    jflow, tflow = flows
    served = CompiledFlow(tflow, batch_size=BATCH, features=6, device="cpu")
    ref = JaxCompiledFlow(jflow, batch_size=BATCH, features=6)
    x = _x(n=BATCH + 1)
    # shape drift
    with pytest.raises(ValueError):
        ref.log_prob(x)
    with pytest.raises(ValueError):
        served.log_prob(torch.from_numpy(x))
    # a context passed to an unconditional server
    c = np.zeros((BATCH, 3), np.float32)
    with pytest.raises(ValueError):
        ref.log_prob(_x(), c)
    with pytest.raises(ValueError):
        served.log_prob(torch.from_numpy(_x()), torch.from_numpy(c))
    # a missing / wrong key or generator
    with pytest.raises(TypeError):
        ref.sample(123)
    with pytest.raises(TypeError):
        served.sample(123)
    with pytest.raises(TypeError):
        served.sample(None)


def test_conditional_context_errors_match_jax():
    jflow, tflow = _pair(seed=11, context_features=3, num_layers=2)
    served = CompiledFlow(tflow, batch_size=BATCH, features=6, context_features=3,
                          device="cpu")
    ref = JaxCompiledFlow(jflow, batch_size=BATCH, features=6, context_features=3)
    x = _x()
    for ctx in (None, np.zeros((BATCH, 4), np.float32)):
        with pytest.raises(ValueError):
            ref.log_prob(x, ctx)
        with pytest.raises(ValueError):
            served.log_prob(torch.from_numpy(x),
                            None if ctx is None else torch.from_numpy(ctx))


def test_conditional_flow_is_served_unfused():
    _, tflow = _pair(seed=12, context_features=3, num_layers=2)
    with pytest.raises(ValueError):
        fuse_nsf(tflow)
    assert not can_fuse_nsf(tflow)
    served = CompiledFlow(tflow, batch_size=BATCH, features=6, context_features=3,
                          device="cpu")
    assert not served.is_fused
    with pytest.raises(ValueError):
        CompiledFlow(tflow, batch_size=BATCH, features=6, context_features=3,
                     use_fused=True, device="cpu")


def test_bf16_is_not_ported_yet(flows):
    _, tflow = flows
    with pytest.raises(NotImplementedError):
        fuse_nsf(tflow, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        CompiledFlow(tflow, batch_size=BATCH, features=6, dtype=torch.bfloat16,
                     device="cpu")


def test_no_device_and_no_cuda_raises(flows, monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    _, tflow = flows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        NeuralSplineFlow(6, 32, num_layers=2)
    with pytest.raises(RuntimeError):
        CompiledFlow(tflow, batch_size=BATCH, features=6)
    with pytest.raises(RuntimeError):
        NeuralSplineFlow(6, 32, num_layers=2, device="cuda")


def test_cpu_paths_launch_no_kernel(flows):
    _, tflow = flows
    b1, b2 = rq_spline.launch_count, nsf_flow_kernel.launch_count
    x = torch.from_numpy(_x())
    CompiledFlow(tflow, BATCH, 6, device="cpu").log_prob(x)
    CompiledFlow(tflow, BATCH, 6, device="cpu", use_fused=False).log_prob(x)
    assert (rq_spline.launch_count, nsf_flow_kernel.launch_count) == (b1, b2)


def test_load_jax_params_rejects_mismatches(flows):
    jflow, _ = flows
    leaves, _ = jax.tree_util.tree_flatten_with_path(jflow)
    params = {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}
    fresh = NeuralSplineFlow(device="cpu", **CFG)
    key = ".transform.transforms[1].transform_net.initial_layer.weight"
    with pytest.raises(KeyError):
        load_jax_params(fresh, {k: v for k, v in params.items() if k != key})
    with pytest.raises(KeyError):
        load_jax_params(fresh, {**params, ".transform.extra": np.zeros(1)})
    with pytest.raises(ValueError):
        load_jax_params(fresh, {**params, key: params[key].T})
