"""The port's autoregressive transforms and prebuilt flows (MAF, NSF-AR,
IAF) against the JAX package's on the CPU, on carried weights and the same
numpy inputs.

Tolerances. A transform's forward and the flows' ``log_prob`` 1e-4, the
interop bar between the two packages in fp32 (measured a few 1e-6). The
inverse 2e-4 on outputs and logabsdet: it is a fixed point of as many MADE
passes as there are features, each feeding its fp32 rounding into the
next, through every layer (measured up to 3e-5). The round trip
forward(inverse(z)) 2e-4 of z. An IAF's ``log_prob`` runs the fixed point and
divides by the scales, so at random initialisation its values grow fast
with the inputs' size (to 7e3 at scale 1.5, where a fp32 ulp is 5e-4): the
IAF is fed inputs at scale 1, where its log_prob stays near 100 and the gap
measured 2.3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.flows import MaskedAutoregressiveFlow as JaxMAF
from nflows_tpu.models import InverseAutoregressiveFlow as JaxIAF
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.transforms import autoregressive as jax_ar
from nflows_tpu_torch import (
    InverseAutoregressiveFlow,
    MaskedAutoregressiveFlow,
    NeuralSplineFlowAR,
    load_jax_params,
)
from nflows_tpu_torch.transforms import autoregressive as torch_ar

torch.set_num_threads(1)


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _carry(jmodule, tmodule):
    load_jax_params(tmodule, _jax_params(jmodule))
    return jmodule, tmodule.eval()


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


TRANSFORMS = {
    "affine": ("MaskedAffineAutoregressiveTransform", {}),
    "rq_linear_tails": ("MaskedPiecewiseRationalQuadraticAutoregressiveTransform",
                        dict(num_bins=4, tails="linear", tail_bound=3.0)),
    "rq_no_tails": ("MaskedPiecewiseRationalQuadraticAutoregressiveTransform",
                    dict(num_bins=4, tails=None)),
}


def _transform_pair(kind, features, context_features, seed=0):
    name, extra = TRANSFORMS[kind]
    kw = dict(features=features, hidden_features=32, num_blocks=2,
              context_features=context_features, **extra)
    return _carry(getattr(jax_ar, name)(key=jax.random.key(seed), **kw),
                  getattr(torch_ar, name)(device="cpu", **kw))


@pytest.mark.parametrize("context_features", [None, 3])
@pytest.mark.parametrize("features", [5, 6])
@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_transform_matches_jax(kind, features, context_features):
    jt, tt = _transform_pair(kind, features, context_features, seed=features)
    if kind == "rq_no_tails":
        x = np.random.default_rng(1).uniform(0.02, 0.98, size=(33, features)).astype(np.float32)
    else:
        x = _normal(1, (33, features), scale=1.5)
    ctx = None if context_features is None else _normal(2, (33, context_features))
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    with torch.no_grad():
        y, lad = tt.forward(torch.from_numpy(x), tctx)
        jy, jlad = jt.forward(jnp.asarray(x), jctx)
        _close(y, jy, 1e-4)
        _close(lad, jlad, 1e-4)
        back, lad_back = tt.inverse(torch.from_numpy(x), tctx)
        jback, jlad_back = jt.inverse(jnp.asarray(x), jctx)
        _close(back, jback, 2e-4)
        _close(lad_back, jlad_back, 2e-4)
        again, _ = tt.forward(back, tctx)
        _close(again, x, 2e-4)


def test_output_multipliers():
    rq = torch_ar.MaskedPiecewiseRationalQuadraticAutoregressiveTransform
    assert rq(5, 16, num_bins=4, tails="linear", device="cpu")._output_dim_multiplier() == 11
    assert rq(5, 16, num_bins=4, tails=None, device="cpu")._output_dim_multiplier() == 13
    assert torch_ar.MaskedAffineAutoregressiveTransform(
        5, 16, device="cpu")._output_dim_multiplier() == 2
    with pytest.raises(ValueError):
        rq(5, 16, num_bins=4, tails="cubic", device="cpu")


def test_ar_rescales_widths_and_heights():
    """Unlike the quadratic variant, the RQ AR transform divides widths AND
    heights by sqrt(hidden): doubling both through the net's last bias
    equals what the JAX transform computes from the same weights, which
    ``test_transform_matches_jax`` pins; here the scale itself."""
    _, tt = _transform_pair("rq_linear_tails", 5, None)
    assert tt._hidden_scale() == pytest.approx(1.0 / np.sqrt(32.0))


@pytest.mark.parametrize("features", [5, 6])
def test_inverse_is_the_jax_iteration(features):
    """Start from zeros, as many MADE passes as features, the logabsdet of
    the last pass: counted here, compared with JAX above."""
    _, tt = _transform_pair("affine", features, None)
    calls = []
    handle = tt.autoregressive_net.register_forward_hook(
        lambda mod, args, out: calls.append(args[0].detach().clone()))
    with torch.no_grad():
        tt.inverse(torch.from_numpy(_normal(3, (4, features))))
    handle.remove()
    assert len(calls) == features
    assert not calls[0].any()


FLOWS = {
    "maf": (JaxMAF, MaskedAutoregressiveFlow,
            dict(num_layers=3, num_blocks_per_layer=2)),
    "maf_random_permutations": (JaxMAF, MaskedAutoregressiveFlow,
                                dict(num_layers=3, num_blocks_per_layer=1,
                                     use_random_permutations=True)),
    "maf_feedforward": (JaxMAF, MaskedAutoregressiveFlow,
                        dict(num_layers=2, num_blocks_per_layer=2,
                             use_residual_blocks=False)),
    "nsf_ar": (JaxNSFAR, NeuralSplineFlowAR,
               dict(num_layers=2, num_blocks_per_layer=2, num_bins=4, tail_bound=3.0)),
    "nsf_ar_context": (JaxNSFAR, NeuralSplineFlowAR,
                       dict(num_layers=2, num_blocks_per_layer=1, num_bins=4,
                            tail_bound=3.0, context_features=3)),
    "iaf": (JaxIAF, InverseAutoregressiveFlow,
            dict(num_layers=2, num_blocks_per_layer=2, use_random_permutations=True)),
}


def _flow_pair(kind, features, seed=0):
    jcls, tcls, kw = FLOWS[kind]
    kw = dict(features=features, hidden_features=32, **kw)
    # the JAX models draw their permutations from the key or the rng; the
    # port's own draw is overwritten by the carried permutation buffers
    jflow = jcls(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
    tflow = tcls(device="cpu", rng=np.random.default_rng(seed + 100), **kw)
    return _carry(jflow, tflow)


@pytest.mark.parametrize("features", [5, 6])
@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_flow_log_prob_and_inverse_match_jax(kind, features):
    jflow, tflow = _flow_pair(kind, features, seed=features)
    x = _normal(4, (40, features), scale=1.0 if kind == "iaf" else 1.5)
    z = _normal(5, (40, features))
    ctx = _normal(6, (40, 3)) if "context" in kind else None
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    with torch.no_grad():
        _close(tflow.log_prob(torch.from_numpy(x), tctx),
               jflow.log_prob(jnp.asarray(x), jctx), 1e-4)
        _close(tflow.transform_to_noise(torch.from_numpy(x), tctx),
               jflow.transform_to_noise(jnp.asarray(x), jctx), 1e-4)
        samples, lad = tflow.transform.inverse(torch.from_numpy(z), tctx)
        jsamples, jlad = jflow.transform.inverse(jnp.asarray(z), jctx)
        _close(samples, jsamples, 2e-4)
        _close(lad, jlad, 2e-4)


def test_carried_permutations_are_the_jax_ones():
    jflow, tflow = _flow_pair("iaf", 6, seed=3)
    for jt, tt in zip(jflow.transform.transforms[::2], list(tflow.transform.transforms)[::2]):
        np.testing.assert_array_equal(tt.permutation.numpy(), np.asarray(jt.permutation))


def test_sampling_endpoints_agree_with_log_prob():
    _, tflow = _flow_pair("nsf_ar", 5)
    with torch.no_grad():
        s, lp = tflow.sample_and_log_prob(torch.Generator().manual_seed(0), 50)
        assert s.shape == (50, 5) and lp.shape == (50,)
        _close(lp, tflow.log_prob(s), 2e-4)
        assert tflow.sample(torch.Generator().manual_seed(1), 7).shape == (7, 5)


def test_seeds_give_reproducible_models_and_permutations():
    build = lambda seed: NeuralSplineFlowAR(  # noqa: E731
        6, 16, num_layers=2, num_bins=4, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    a, b, c = build(1), build(1), build(2)
    for pa, pb in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(pa, pb)
    def perms(f):
        return [t.permutation.tolist() for t in list(f.transform.transforms)[::2]]

    assert perms(a) == perms(b) and perms(a) != perms(c)
    iaf = InverseAutoregressiveFlow(6, 16, 2, 1, device="cpu")
    assert perms(iaf) == [[5, 4, 3, 2, 1, 0]] * 2       # reversal unless asked otherwise


def test_options_that_wait_for_other_modules():
    with pytest.raises(NotImplementedError, match="transforms/normalization.py"):
        MaskedAutoregressiveFlow(5, 16, 2, 1, batch_norm_between_layers=True, device="cpu")
    with pytest.raises(NotImplementedError, match="transforms/lu.py"):
        NeuralSplineFlowAR(5, 16, num_layers=2, use_linear_layers=True, device="cpu")
    with pytest.raises(NotImplementedError, match="batch norm"):
        MaskedAutoregressiveFlow(5, 16, 2, 1, batch_norm_within_layers=True, device="cpu")


def test_random_mask_maf_carries_over():
    """Random-mask MADEs draw their hidden degrees from an unseeded numpy
    generator in both packages, so the incoming masks are copied in, after
    a check that they are autoregressive; log_prob then matches within the
    interop bar (measured 1.9e-6)."""
    kw = dict(features=5, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
              use_residual_blocks=False, use_random_masks=True)
    jflow = JaxMAF(key=jax.random.key(5), rng=np.random.default_rng(5), **kw)
    tflow = MaskedAutoregressiveFlow(device="cpu", rng=np.random.default_rng(5), **kw)
    params = _jax_params(jflow)
    load_jax_params(tflow, params)
    x = _normal(7, (64, 5), scale=1.5)
    with torch.no_grad():
        _close(tflow.log_prob(torch.from_numpy(x)), jflow.log_prob(jnp.asarray(x)), 1e-4)
    made = tflow.transform.transforms[1].autoregressive_net
    key = ".transform.transforms[1].autoregressive_net.initial_layer.mask"
    np.testing.assert_array_equal(made.initial_layer.mask.numpy(), params[key].T)
    # each random layer's degrees are now the smallest that give its mask
    degrees = np.arange(1, 6)
    for layer in [made.initial_layer] + [b.linear for b in made.blocks]:
        out = np.asarray(layer.degrees)
        np.testing.assert_array_equal(layer.mask.numpy(), out[:, None] >= degrees[None, :])
        degrees = out
    # masks that let an output see its own feature are refused
    bad = dict(params)
    final = ".transform.transforms[1].autoregressive_net.final_layer.mask"
    bad[final] = np.ones_like(params[final])
    with pytest.raises(ValueError, match="not autoregressive"):
        load_jax_params(MaskedAutoregressiveFlow(device="cpu", **kw), bad)
    # degree-rule masks are still compared, not copied
    jres = JaxMAF(key=jax.random.key(6), **dict(kw, use_random_masks=False))
    plain = _jax_params(jres)
    mask = ".transform.transforms[1].autoregressive_net.blocks[0].linear.mask"
    plain[mask] = np.zeros_like(plain[mask])
    with pytest.raises(ValueError, match="differs from the mask the port built"):
        load_jax_params(MaskedAutoregressiveFlow(
            device="cpu", **dict(kw, use_random_masks=False)), plain)
