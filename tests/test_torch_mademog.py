"""The port's MixtureOfGaussiansMADE and MADEMoG against the JAX package's on
the CPU: log_prob and the mixture parameters on carried weights, the custom
initialisation, sampling by its moments, and the refusals.

Tolerances. log_prob 1e-4, the interop bar (fp32 GEMMs and a logsumexp
summed over features, measured about 4e-6); the mixture parameters 1e-5 (one
MADE pass and a softmax). The two packages draw from different RNG streams,
so samples are compared by their moments: means within five standard
errors, standard deviations within 10%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.distributions import MADEMoG as JaxMADEMoG
from nflows_tpu.nn.nde.made import MixtureOfGaussiansMADE as JaxMoG
from nflows_tpu_torch import MADEMoG, MixtureOfGaussiansMADE, load_jax_params
from nflows_tpu_torch.ops.cuda.mademog_fused import can_fuse_mademog, fuse_mademog

torch.set_num_threads(1)

KINDS = {"residual": dict(use_residual_blocks=True),
         "feedforward": dict(use_residual_blocks=False)}


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(kind="residual", features=5, K=4, context_features=None, seed=0, hidden=32):
    """The same MixtureOfGaussiansMADE in both packages, weights carried
    over from the JAX one."""
    kw = dict(features=features, hidden_features=hidden, context_features=context_features,
              num_blocks=2, num_mixture_components=K, **KINDS[kind])
    jm = JaxMoG(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
    tm = MixtureOfGaussiansMADE(rng=np.random.default_rng(seed), device="cpu", **kw)
    load_jax_params(tm, _jax_params(jm))
    return jm, tm


def _inputs(n, features, context_features=None, seed=1, scale=1.5):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, features)) * scale).astype(np.float32)
    c = (None if context_features is None
         else rng.normal(size=(n, context_features)).astype(np.float32))
    return x, c


def _both(x, c):
    jx = (jnp.asarray(x), None if c is None else jnp.asarray(c))
    tx = (torch.from_numpy(x), None if c is None else torch.from_numpy(c))
    return jx, tx


@pytest.mark.parametrize("context_features", [None, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_log_prob_matches_jax(kind, context_features):
    jm, tm = _pair(kind, context_features=context_features, seed=2)
    (jx, jc), (tx, tc) = _both(*_inputs(128, 5, context_features))
    want = np.asarray(jm.log_prob(jx, jc))
    with torch.no_grad():
        got = tm.log_prob(tx, tc)
    assert got.shape == (128,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("context_features", [None, 3])
def test_mixture_params_match_jax(context_features):
    jm, tm = _pair(context_features=context_features, seed=3)
    (jx, jc), (tx, tc) = _both(*_inputs(64, 5, context_features, seed=4))
    want = jm._mixture_params(jm(jx, jc), jx.shape)
    with torch.no_grad():
        got = tm._mixture_params(tm(tx, tc), tx.shape)
    for g, w in zip(got, want):
        assert g.shape == (64, 5, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("context_features", [None, 3])
def test_mademog_distribution_matches_jax(context_features):
    kw = dict(features=4, hidden_features=16, context_features=context_features,
              num_blocks=2, num_mixture_components=3)
    jd = JaxMADEMoG(key=jax.random.key(5), rng=np.random.default_rng(5), **kw)
    td = MADEMoG(rng=np.random.default_rng(5), device="cpu", **kw)
    params = _jax_params(jd)
    assert all(k.startswith(".made.") for k in params)
    load_jax_params(td, params)
    (jx, jc), (tx, tc) = _both(*_inputs(64, 4, context_features, seed=6))
    with torch.no_grad():
        got = td.log_prob(tx, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(jd.log_prob(jx, jc)), atol=1e-4, rtol=0)


def test_the_defaults_are_the_jax_packages():
    m = MixtureOfGaussiansMADE(5, 16, device="cpu")
    assert m.num_mixture_components == 5 and m.epsilon == 1e-2
    assert m.use_residual_blocks and m.final_layer.weight.shape == (75, 16)
    d = MADEMoG(5, 16, None, device="cpu")
    assert d.made.num_mixture_components == 1 and d.made.epsilon == 1e-2


def test_custom_initialization_slot_statistics():
    """Logit and unconstrained-std slots (rows 0::3 and 2::3 of the [out, in]
    weight; columns of the JAX [in, out] one) get N(0, eps^2) weights, the std
    biases sit at softplus^-1(1 - eps); the mean slots keep the default
    U(-1/sqrt(H), 1/sqrt(H)). The JAX model's slots have the same statistics."""
    eps = 1e-2
    constant = float(np.log(np.exp(1 - eps) - 1))
    jm = JaxMoG(5, 64, num_mixture_components=10, key=jax.random.key(0),
                rng=np.random.default_rng(0))
    tm = MixtureOfGaussiansMADE(5, 64, num_mixture_components=10, device="cpu",
                                generator=torch.Generator().manual_seed(0),
                                rng=np.random.default_rng(0))
    jw = np.asarray(jm.final_layer.weight).T          # [out, in]
    jb = np.asarray(jm.final_layer.bias)
    tw = tm.final_layer.weight.detach().numpy()
    tb = tm.final_layer.bias.detach().numpy()
    for w, b in ((jw, jb), (tw, tb)):
        for slot in (0, 2):
            assert 0.8 * eps < w[slot::3].std() < 1.2 * eps
            assert abs(w[slot::3].mean()) < 0.2 * eps
        assert 0.5 * eps < b[0::3].std() < 1.5 * eps and abs(b[0::3].mean()) < 0.5 * eps
        assert abs(b[2::3].mean() - constant) < 0.5 * eps
        bound = 1 / np.sqrt(64)
        assert np.abs(w[1::3]).max() <= bound and w[1::3].std() > 0.5 * bound / np.sqrt(3)
    # stds near 1 and near-uniform coefficients at init
    x = torch.randn(256, 5, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        log_coef, _, stds = tm._mixture_params(tm(x), x.shape)
    assert float((stds - 1).abs().mean()) < 0.05
    assert float((log_coef + np.log(10)).abs().mean()) < 0.05
    plain = MixtureOfGaussiansMADE(5, 64, num_mixture_components=10, device="cpu",
                                   custom_initialization=False,
                                   generator=torch.Generator().manual_seed(0))
    assert plain.final_layer.weight[0::3].detach().std() > 5 * eps


@pytest.mark.parametrize("context_features", [None, 2])
def test_sampling_moments_match_jax(context_features):
    jm, tm = _pair(features=3, K=3, context_features=context_features, seed=7, hidden=16)
    n = 4000
    c = None if context_features is None else _inputs(2, 3, context_features, seed=8)[1]
    js = np.asarray(jm.sample(jax.random.key(9), n,
                              None if c is None else jnp.asarray(c)))
    ts = tm.sample(torch.Generator().manual_seed(9), n,
                   None if c is None else torch.from_numpy(c)).numpy()
    shape = (n, 3) if c is None else (2, n, 3)
    assert js.shape == ts.shape == shape and np.isfinite(ts).all()
    js, ts = js.reshape(-1, n, 3), ts.reshape(-1, n, 3)
    se = np.sqrt((js.var(axis=1) + ts.var(axis=1)) / n)
    np.testing.assert_array_less(np.abs(js.mean(axis=1) - ts.mean(axis=1)), 5 * se)
    np.testing.assert_allclose(ts.std(axis=1), js.std(axis=1), rtol=0.1)


def test_one_feature_one_component_samples_have_the_heads_moments():
    """At D = 1 and K = 1 the model is one Gaussian whose mean and std come
    from the biases alone (the feature has no inputs before it)."""
    tm = MixtureOfGaussiansMADE(1, 16, num_mixture_components=1, device="cpu",
                                generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        tm.final_layer.bias[1] = 0.7
        _, means, stds = tm._mixture_params(tm(torch.zeros(1, 1)), (1, 1))
    mu, s = float(means[0, 0, 0]), float(stds[0, 0, 0])
    n = 20000
    samples = tm.sample(torch.Generator().manual_seed(3), n)
    assert samples.shape == (n, 1) and not samples.requires_grad
    assert abs(float(samples.mean()) - mu) < 4 * s / np.sqrt(n)
    assert abs(float(samples.std()) / s - 1) < 0.03
    # and log_prob is that Gaussian's
    x = torch.tensor([[0.0], [1.5]])
    with torch.no_grad():
        want = -0.5 * np.log(2 * np.pi) - np.log(s) - 0.5 * ((x[:, 0] - mu) / s) ** 2
        torch.testing.assert_close(tm.log_prob(x), want, atol=1e-5, rtol=0)


def test_sample_and_log_prob_of_a_bare_model_and_of_the_distribution():
    for model in (MixtureOfGaussiansMADE(4, 16, context_features=2, device="cpu"),
                  MADEMoG(4, 16, 2, num_mixture_components=3, device="cpu")):
        c = torch.randn(3, 2)
        s, lp = model.sample_and_log_prob(torch.Generator().manual_seed(0), 5, c)
        assert s.shape == (3, 5, 4) and lp.shape == (3, 5)
        with torch.no_grad():
            want = model.log_prob(s.reshape(15, 4), c.repeat_interleave(5, dim=0))
        torch.testing.assert_close(lp.reshape(15), want)


def test_refusals():
    with pytest.raises(ValueError, match="random masks"):
        MixtureOfGaussiansMADE(5, 16, random_mask=True, device="cpu")
    with pytest.raises(NotImplementedError, match="batch norm"):
        MixtureOfGaussiansMADE(5, 16, use_batch_norm=True, device="cpu")
    with pytest.raises(NotImplementedError, match="batch norm"):
        MADEMoG(5, 16, None, use_batch_norm=True, device="cpu")
    with pytest.raises(TypeError):
        MADEMoG(5, 16, None, device="cpu").sample(None, 0)
    # the fused view's refusals (tests/ops/test_mademog_fused.py:62-75)
    made = MixtureOfGaussiansMADE(5, 16, num_mixture_components=4, device="cpu")
    fused = fuse_mademog(made)
    with pytest.raises(ValueError, match="expected"):
        fused.log_prob(torch.ones(4, 3))
    with pytest.raises(ValueError, match="context"):
        fused.log_prob(torch.ones(8, 5), torch.ones(8, 3))
    cfused = fuse_mademog(MixtureOfGaussiansMADE(5, 16, context_features=2, device="cpu"))
    with pytest.raises(ValueError, match="context"):
        cfused.log_prob(torch.ones(8, 5))
    with pytest.raises(ValueError, match="rows"):
        cfused.log_prob(torch.ones(8, 5), torch.ones(4, 2))
    assert can_fuse_mademog(made)
    assert not can_fuse_mademog(MixtureOfGaussiansMADE(5, 16, activation=torch.tanh,
                                                       device="cpu"))
    assert not can_fuse_mademog(MixtureOfGaussiansMADE(5, 16, use_residual_blocks=False,
                                                       device="cpu"))


def test_a_mask_that_differs_is_refused():
    """A degree-rule mask that differs is refused; random masks, which each
    package draws from its own generator, are copied in (after the
    autoregressive check), so a MoG-MADE built from another generator
    carries over and computes the JAX model's log_prob."""
    kw = dict(features=5, hidden_features=16, num_blocks=1, use_residual_blocks=False,
              num_mixture_components=2)
    jm = JaxMoG(key=jax.random.key(0), rng=np.random.default_rng(0), random_mask=True, **kw)
    tm = MixtureOfGaussiansMADE(rng=np.random.default_rng(1), random_mask=True, device="cpu",
                                **kw)
    load_jax_params(tm, _jax_params(jm))
    x = np.random.default_rng(2).normal(size=(16, 5)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(tm.log_prob(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm.log_prob(jnp.asarray(x))), atol=1e-4, rtol=0)
    params = _jax_params(JaxMoG(key=jax.random.key(0), **kw))
    params[".initial_layer.mask"] = 1.0 - params[".initial_layer.mask"]
    with pytest.raises(ValueError, match="differs from the mask"):
        load_jax_params(MixtureOfGaussiansMADE(device="cpu", **kw), params)
