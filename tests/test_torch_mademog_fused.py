"""The fused mixture-density log_prob on the CPU: the port's extraction
against the JAX package's, the plain version of kernel B11 against the JAX
kernel in interpret mode, and ``CompiledFlow`` selecting the fused view.

Tolerances. Extraction is a re-laying of the same fp32 values (and a
product with 0/1 masks): exact. B11's plain version against the Pallas
kernel in interpret mode 1e-5 (the same fp32 GEMMs and head, summed in
another order; measured about 2e-6). Served against the module 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.nn.nde.made import MixtureOfGaussiansMADE as JaxMoG
from nflows_tpu.ops.pallas import mademog_fused as jax_fused
from nflows_tpu_torch import (
    CompiledFlow,
    MADEMoG,
    MaskedAutoregressiveFlow,
    MixtureOfGaussiansMADE,
    load_jax_params,
)
from nflows_tpu_torch.ops.cuda import mademog_fused

torch.set_num_threads(1)


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(context_features=None, features=5, K=4, seed=0, hidden=32):
    kw = dict(features=features, hidden_features=hidden, context_features=context_features,
              num_blocks=2, num_mixture_components=K)
    jm = JaxMoG(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
    tm = MixtureOfGaussiansMADE(rng=np.random.default_rng(seed), device="cpu", **kw)
    load_jax_params(tm, _jax_params(jm))
    return jm, tm


def _inputs(n, features, context_features=None, seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, features)) * 1.5).astype(np.float32)
    c = (None if context_features is None
         else rng.normal(size=(n, context_features)).astype(np.float32))
    return x, c


@pytest.mark.parametrize("fold_masks", [True, False])
@pytest.mark.parametrize("context_features", [None, 3])
def test_extract_equals_the_jax_layout_key_by_key(context_features, fold_masks):
    jm, tm = _pair(context_features, seed=2)
    jw, jstatic, jcf, jmasks = jax_fused._extract(jm, jnp.float32, fold_masks=fold_masks,
                                                  return_masks=True)
    tw, tstatic, tcf, tmasks = mademog_fused._extract(tm, torch.float32,
                                                      fold_masks=fold_masks, return_masks=True)
    assert tstatic == jstatic and tcf == jcf
    assert sorted(tw) == sorted(jw)
    for k in jw:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]), err_msg=k)
    assert sorted(tmasks) == sorted(jmasks) == ["wb", "wf", "wi"]
    for k in jmasks:
        np.testing.assert_array_equal(tmasks[k].numpy(), np.asarray(jmasks[k]), err_msg=k)


def test_k_major_order_and_its_inverse():
    D, K = 3, 2
    order = mademog_fused.k_major_order(D, K)
    # kernel row (j K + k) D + d holds model column d 3K + k 3 + j
    for j in range(3):
        for k in range(K):
            for d in range(D):
                assert order[(j * K + k) * D + d] == d * 3 * K + k * 3 + j
    assert sorted(order) == list(range(3 * K * D))
    _, tm = _pair(features=D, K=K)
    w = mademog_fused._extract(tm, torch.float32)[0]
    # the logits of feature d sit in rows k D + d: the model's column d 3K + 3k
    folded = tm.final_layer.weight.detach() * tm.final_layer.mask
    for d in range(D):
        for k in range(K):
            torch.testing.assert_close(w["wf"][k * D + d], folded[d * 3 * K + 3 * k],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("context_features", [None, 3])
def test_b11_plain_matches_the_jax_kernel_in_interpret_mode(context_features):
    jm, tm = _pair(context_features, seed=4)
    x, c = _inputs(128, 5, context_features, seed=5)
    jw, jstatic, _ = jax_fused._extract(jm, jnp.float32)
    want = jax_fused.mademog_log_prob_call(
        jnp.asarray(x.T), jw, jstatic, lanes=128, interpret=True,
        ctx_t=None if c is None else jnp.asarray(c.T))
    tw, tstatic, _ = mademog_fused._extract(tm, torch.float32)
    before = mademog_fused.launch_count
    got = mademog_fused.mademog_log_prob_cuda(
        torch.from_numpy(x), tw, tstatic, None if c is None else torch.from_numpy(c))
    assert mademog_fused.launch_count == before       # a CPU tensor runs the plain version
    assert got.shape == (128,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], atol=1e-5, rtol=0)
    with torch.no_grad():
        np.testing.assert_allclose(
            got.numpy(), tm.log_prob(torch.from_numpy(x),
                                     None if c is None else torch.from_numpy(c)).numpy(),
            atol=1e-5, rtol=0)


def test_the_plain_head_keeps_peaked_mixtures_finite():
    """Logits 60 apart and a point far out in one component's tail: both
    max-subtractions keep the fp32 head finite and equal to float64."""
    _, tm = _pair(seed=6)
    w, static, _ = mademog_fused._extract(tm, torch.float32)
    x = torch.from_numpy(_inputs(32, 5, seed=7)[0]) * 20
    with torch.no_grad():
        w["bf"][:4 * 5] += 60.0 * torch.arange(4).repeat_interleave(5)[:, None]
    lp32 = mademog_fused.mademog_log_prob_plain(x, w, static)
    lp64 = mademog_fused.mademog_log_prob_plain(
        x.double(), {k: v.double() for k, v in w.items()}, static)
    assert torch.isfinite(lp32).all()
    torch.testing.assert_close(lp32.double(), lp64, atol=1e-3, rtol=1e-5)


def test_pack_weights_is_the_in_major_layout():
    _, tm = _pair(3, seed=8)
    w, static, _ = mademog_fused._extract(tm, torch.float32)
    packed = mademog_fused.pack_weights(w, static)
    H, nb, P = 32, 2, 60
    assert packed["wf"].shape == (H, 60) and packed["bf"].shape == (60,)
    torch.testing.assert_close(packed["wi"], w["wi"].T, rtol=0, atol=0)
    torch.testing.assert_close(packed["wf"][:, :P], w["wf"].T, rtol=0, atol=0)
    for j in range(2 * nb):
        torch.testing.assert_close(packed["wb"][j], w["wb"][j * H:(j + 1) * H].T, rtol=0, atol=0)
    for j in range(nb):
        torch.testing.assert_close(packed["wcb"][j], w["wcb"][j * H:(j + 1) * H].T,
                                   rtol=0, atol=0)
    torch.testing.assert_close(packed["wci"], w["wci"].T, rtol=0, atol=0)
    assert packed["bb"].shape == (2 * nb * H,) and packed["bcb"].shape == (nb * H,)
    again = mademog_fused.pack_weights(w, static, out=packed)
    assert again is packed
    # the full-width model's tile fits a block's shared memory, with the context
    assert mademog_fused.shared_memory_bytes(10, 10, 10, 256) <= 232448
    _, three = _pair(K=3, seed=8)                  # P = 45 outputs, padded to 48
    w3, static3, _ = mademog_fused._extract(three, torch.float32)
    packed3 = mademog_fused.pack_weights(w3, static3)
    assert packed3["wf"].shape == (H, 48) and not packed3["wf"][:, 45:].any()


@pytest.mark.parametrize("context_features", [None, 3])
def test_compiled_flow_selects_the_fused_view(context_features):
    _, tm = _pair(context_features, seed=9)
    dist = MADEMoG(5, 32, context_features, num_mixture_components=4, device="cpu")
    dist.made.load_state_dict(tm.state_dict())
    x, c = _inputs(64, 5, context_features, seed=10)
    tx, tc = torch.from_numpy(x), None if c is None else torch.from_numpy(c)
    for model in (tm, dist):
        served = CompiledFlow(model, batch_size=64, features=5,
                              context_features=context_features, device="cpu")
        assert served.is_fused and isinstance(served._fused, mademog_fused.FusedMADEMoG)
        with torch.no_grad():
            np.testing.assert_allclose(served.log_prob(tx, tc).numpy(),
                                       model.log_prob(tx, tc).numpy(), atol=1e-5, rtol=0)
        unfused = CompiledFlow(model, batch_size=64, features=5,
                               context_features=context_features, device="cpu",
                               use_fused=False)
        assert not unfused.is_fused
        g = torch.Generator().manual_seed(0)
        s, lp = served.sample_and_log_prob(g, tc)
        shape = (64, 5) if c is None else (64, 64, 5)
        assert s.shape == shape and lp.shape == shape[:-1]
        flat_c = None if tc is None else tc.repeat_interleave(64, dim=0)
        with torch.no_grad():
            np.testing.assert_allclose(
                lp.reshape(-1).numpy(), model.log_prob(s.reshape(-1, 5), flat_c).numpy(),
                atol=1e-5, rtol=0)
        assert served.sample(torch.Generator().manual_seed(1), tc).shape == shape


def test_serving_errors_name_every_prober():
    feedforward = MixtureOfGaussiansMADE(5, 16, use_residual_blocks=False, device="cpu")
    with pytest.raises(ValueError) as err:
        CompiledFlow(feedforward, 16, 5, device="cpu", use_fused=True)
    text = str(err.value)
    assert "fuse_nsf: " in text and "fuse_maf: " in text
    assert "fuse_mademog: fused path requires residual-block MADE" in text
    assert not CompiledFlow(feedforward, 16, 5, device="cpu").is_fused
    conditional = MixtureOfGaussiansMADE(5, 16, context_features=2, device="cpu")
    with pytest.raises(ValueError, match="conditionality"):
        CompiledFlow(conditional, 16, 5, device="cpu", use_fused=True)
    # bf16 is ported (tests/test_torch_bf16_serving.py); other dtypes are not
    assert mademog_fused.fuse_mademog(
        conditional, dtype=torch.bfloat16)._weights["wcb"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mademog_fused.fuse_mademog(conditional, dtype=torch.float16)
    # a MAF is still taken by fuse_maf, before fuse_mademog
    maf = MaskedAutoregressiveFlow(5, 16, 2, 1, device="cpu")
    assert type(CompiledFlow(maf, 16, 5, device="cpu")._fused).__name__ == "FusedMAF"
    assert not mademog_fused.can_fuse_mademog(maf)
