"""The port's MADE against the JAX package's on the CPU: degrees, masks,
outputs on carried weights, and the autoregressive property.

Tolerances. Degrees and masks are integers and 0/1 floats built by the same
numpy rule: exact. Outputs on carried weights 1e-5: a handful of fp32
GEMMs of width 32 summed in another order (measured about 1e-6). The
Jacobian's structural zeros are exact zeros: a masked weight is multiplied
by 0.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nflows_tpu.nn import made as jax_made
from nflows_tpu_torch import load_jax_params
from nflows_tpu_torch.nn import made as torch_made

torch.set_num_threads(1)

KINDS = {
    "residual": dict(use_residual_blocks=True, random_mask=False),
    "feedforward": dict(use_residual_blocks=False, random_mask=False),
    "random_mask": dict(use_residual_blocks=False, random_mask=True),
}


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(kind, features, seed=0, context_features=None, multiplier=3, hidden=32):
    """The same MADE in both packages: same numpy rng for the degrees,
    weights carried over from the JAX one (the port's own are seeded too, so
    that a test on them sees the same weights every run)."""
    kw = dict(features=features, hidden_features=hidden, num_blocks=2,
              output_multiplier=multiplier, context_features=context_features,
              **KINDS[kind])
    jnet = jax_made.MADE(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
    tnet = torch_made.MADE(rng=np.random.default_rng(seed), device="cpu",
                           generator=torch.Generator().manual_seed(seed), **kw)
    return jnet, tnet


def _masked_layers(net):
    yield net.initial_layer
    for blk in net.blocks:
        if hasattr(blk, "linear"):
            yield blk.linear
        else:
            yield blk.linear_0
            yield blk.linear_1
    yield net.final_layer


@pytest.mark.parametrize("features", [5, 6])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_masks_and_degrees_equal_the_jax_ones(kind, features):
    jnet, tnet = _pair(kind, features, seed=features)
    pairs = list(zip(_masked_layers(jnet), _masked_layers(tnet)))
    assert len(pairs) == (6 if kind == "residual" else 4)
    for jl, tl in pairs:
        assert tl.degrees == jl.degrees
        # the port's mask is [out, in] like its weight; the JAX one [in, out]
        np.testing.assert_array_equal(tl.mask.numpy(), np.asarray(jl.mask).T)
        assert tl.mask.shape == tl.weight.shape


@pytest.mark.parametrize("is_output", [False, True])
@pytest.mark.parametrize("random_mask", [False, True])
def test_mask_rule_matches_jax(is_output, random_mask):
    in_degrees = np.array([1, 2, 3, 1, 2, 3, 4])
    args = (in_degrees, 12, 4, random_mask, is_output)
    jm, jd = jax_made._mask_and_degrees(*args, rng=np.random.default_rng(3))
    tm, td = torch_made._mask_and_degrees(*args, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tm, jm.T)
    np.testing.assert_array_equal(torch_made._get_input_degrees(4),
                                  jax_made._get_input_degrees(4))


@pytest.mark.parametrize("context_features", [None, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_output_equals_jax_on_carried_weights(kind, context_features):
    jnet, tnet = _pair(kind, 5, seed=1, context_features=context_features)
    load_jax_params(tnet, _jax_params(jnet))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(17, 5)).astype(np.float32)
    ctx = (None if context_features is None
           else rng.normal(size=(17, context_features)).astype(np.float32))
    want = jnet(jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    assert got.shape == (17, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("features", [5, 6])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_autoregressive_property_by_jacobian(kind, features):
    """Parameter j of feature k (output column k * m + j) depends only on
    the inputs before k, and on every one of them in total."""
    m = 3
    _, tnet = _pair(kind, features, seed=4, multiplier=m)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(features,)).astype(np.float32))
    jac = torch.autograd.functional.jacobian(lambda v: tnet(v[None])[0], x)
    assert jac.shape == (features * m, features)
    for k in range(features):
        block = jac[k * m:(k + 1) * m]
        assert torch.equal(block[:, k:], torch.zeros_like(block[:, k:]))
    if kind != "random_mask":
        # the sequential degree rule connects the last feature to every earlier input
        assert (jac[(features - 1) * m:].abs().sum(dim=0)[:features - 1] > 0).all()


def test_a_mask_that_differs_is_refused():
    """A degree-rule mask that differs from the port's is refused, and
    nothing is written. Random masks differ by construction (each side
    draws its degrees from its own generator), so they are copied in once
    the chain is checked to be autoregressive: a MADE built from another
    generator then computes the JAX one's function."""
    kw = dict(features=6, hidden_features=32, num_blocks=1, use_residual_blocks=False)
    jnet = jax_made.MADE(key=jax.random.key(0), rng=np.random.default_rng(1),
                         random_mask=True, **kw)
    other = torch_made.MADE(rng=np.random.default_rng(2), random_mask=True, device="cpu",
                            **kw)
    load_jax_params(other, _jax_params(jnet))
    for layer, jlayer in ((other.initial_layer, jnet.initial_layer),
                          (other.blocks[0].linear, jnet.blocks[0].linear),
                          (other.final_layer, jnet.final_layer)):
        np.testing.assert_array_equal(layer.mask.numpy(), np.asarray(jlayer.mask).T)
    x = np.random.default_rng(3).normal(size=(16, 6)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(other(torch.from_numpy(x)).numpy(),
                                   np.asarray(jnet(jnp.asarray(x))), atol=1e-5, rtol=0)
    jrule = jax_made.MADE(key=jax.random.key(0), **kw)
    params = _jax_params(jrule)
    key = ".blocks[0].linear.mask"
    params[key] = 1.0 - params[key]
    target = torch_made.MADE(device="cpu", **kw)
    before = target.initial_layer.weight.detach().clone()
    with pytest.raises(ValueError, match="differs from the mask"):
        load_jax_params(target, params)
    assert torch.equal(target.initial_layer.weight.detach(), before)   # nothing was written


def test_construction_guards_match_jax():
    for mod, extra in ((jax_made, {}), (torch_made, dict(device="cpu"))):
        with pytest.raises(ValueError, match="random masks"):
            mod.MADE(5, 16, use_residual_blocks=True, random_mask=True, **extra)
        with pytest.raises(ValueError, match="random masks"):
            mod.MaskedResidualBlock(np.arange(1, 6), 5, random_mask=True, **extra)
    # degrees that would fall below the input's: the residual block refuses
    with pytest.raises(RuntimeError, match="output degrees"):
        torch_made.MaskedResidualBlock(np.array([4, 4, 4, 4]), 5, device="cpu")
    with pytest.raises(RuntimeError, match="output degrees"):
        jax_made.MaskedResidualBlock(np.array([4, 4, 4, 4]), 5)
    # batch norm inside both blocks builds and matches JAX on moved scales
    # and offsets, at an odd batch (tests/test_torch_normalization.py holds
    # the blocks' statistics and the autoregressive property)
    x = np.random.default_rng(3).normal(size=(33, 5)).astype(np.float32)
    for residual in (True, False):
        kw = dict(use_residual_blocks=residual, use_batch_norm=True)
        jnet = jax_made.MADE(5, 16, key=jax.random.key(0), **kw)
        params = _jax_params(jnet)
        rng = np.random.default_rng(4)
        for k in params:
            if "batch_norm" in k:
                params[k] = params[k] + 0.3 * rng.standard_normal(params[k].shape).astype(
                    np.float32)
        jnet = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jnet),
            [jnp.asarray(params[jax.tree_util.keystr(p)])
             for p, _ in jax.tree_util.tree_flatten_with_path(jnet)[0]])
        tnet = torch_made.MADE(5, 16, device="cpu", **kw)
        load_jax_params(tnet, params)
        with torch.no_grad():
            np.testing.assert_allclose(tnet(torch.from_numpy(x)).numpy(),
                                       np.asarray(jnet(jnp.asarray(x))), atol=1e-4, rtol=0)


def test_initialisation_and_dropout():
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    a = torch_made.MADE(5, 32, generator=gen(), dropout_probability=0.5, device="cpu")
    b = torch_made.MADE(5, 32, generator=gen(), dropout_probability=0.5, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)                       # one seed, one model
    for blk in a.blocks:                                 # near-identity blocks
        assert blk.linear_1.weight.abs().max() <= 1e-3
        assert blk.linear_0.weight.abs().max() <= 1.0 / np.sqrt(32) + 1e-6
    assert a.activation is F.relu
    x = torch.randn(9, 5, generator=gen())
    with torch.no_grad():
        quiet = a(x)
        assert torch.equal(a(x), quiet)                  # no generator: evaluation
        noisy = a(x, generator=torch.Generator().manual_seed(1))
        again = a(x, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(noisy, quiet) and torch.equal(noisy, again)
