"""The fused autoregressive serving path on the CPU: the port's extraction
and the plain version of kernel B9 against the JAX package's extraction and
its Pallas kernel in interpret mode, on carried weights and the same numpy
inputs.

Tolerances. Extracted stacks are copies, transposes, permutations and one
multiplication by a 0/1 mask or by float32(1/sqrt(hidden)): exact. The plain
chain against the interpreted kernel: forward 1e-5 on outputs and
logabsdet, the inverse (a fixed point of D + 1 MADE passes a layer) 1e-4
(the JAX package holds its own kernel to 1e-5 and 1e-4 against its XLA
path, tests/ops/test_maf_fused.py) plus 1e-5 of the value: at random
initialisation the fixed point divides by scales below 1 feature after
feature, a few samples reach the hundreds, and a fp32 ulp there is 3e-5.
The unfolded chain with ``wh_scale`` against the folded one 2e-5, as for
B2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nflows_tpu.flows import MaskedAutoregressiveFlow as JaxMAF
from nflows_tpu.models import InverseAutoregressiveFlow as JaxIAF
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.ops.pallas import maf_fused as jax_fused
from nflows_tpu_torch import (
    CompiledFlow,
    InverseAutoregressiveFlow,
    MaskedAutoregressiveFlow,
    NeuralSplineFlow,
    NeuralSplineFlowAR,
    load_jax_params,
)
from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_fused
from nflows_tpu_torch.transforms.autoregressive import (
    MaskedPiecewiseRationalQuadraticAutoregressiveTransform,
)

torch.set_num_threads(1)

KINDS = {
    "maf": (JaxMAF, MaskedAutoregressiveFlow,
            dict(num_layers=3, num_blocks_per_layer=2)),
    "maf_random_permutations": (JaxMAF, MaskedAutoregressiveFlow,
                                dict(num_layers=3, num_blocks_per_layer=1,
                                     use_random_permutations=True)),
    "nsf_ar": (JaxNSFAR, NeuralSplineFlowAR,
               dict(num_layers=2, num_blocks_per_layer=2, num_bins=4, tail_bound=3.0)),
    "iaf": (JaxIAF, InverseAutoregressiveFlow,
            dict(num_layers=2, num_blocks_per_layer=2, use_random_permutations=True)),
}


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(kind, features=5, seed=0):
    jcls, tcls, kw = KINDS[kind]
    kw = dict(features=features, hidden_features=32, **kw)
    jflow = jcls(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
    tflow = tcls(device="cpu", rng=np.random.default_rng(seed + 100), **kw)
    load_jax_params(tflow, _jax_params(jflow))
    return jflow, tflow.eval()


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(a, b, atol, rtol=0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


@pytest.mark.parametrize("features", [5, 6])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_extract_matches_jax_array_for_array(kind, features):
    jflow, tflow = _pair(kind, features, seed=features)
    j = jax_fused._extract(jflow, jnp.float32)
    t = maf_fused._extract(tflow, torch.float32)
    assert [tuple(ls) for ls in t[0]] == [tuple(ls) for ls in j[0]]
    assert t[2:] == tuple(j[2:])        # num_blocks, features, transformer, spline_kw, context
    assert sorted(t[1]) == sorted(j[1])
    for name in j[1]:
        np.testing.assert_array_equal(t[1][name].numpy(), np.asarray(j[1][name]), err_msg=name)


@pytest.mark.parametrize("kind", ["maf_random_permutations", "nsf_ar"])
def test_unfolded_extract_and_masks_match_jax(kind):
    jflow, tflow = _pair(kind, 6, seed=2)
    kw = dict(fold_masks=False, fold_wh_scale=False, allow_wrapped=False, return_masks=True)
    j = jax_fused._extract(jflow, jnp.float32, **kw)
    t = maf_fused._extract(tflow, torch.float32, **kw)
    for got, want in ((t[1], j[1]), (t[7], j[7])):
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                          err_msg=name)
    # folding is the product with the mask, and for rq the rescaled final rows
    folded = maf_fused._extract(tflow, torch.float32, fold_wh_scale=False)[1]
    for name in ("wi", "wb", "wf"):
        assert torch.equal(folded[name], t[1][name] * t[7][name])
    # without the folds every row is a row of the model's own final layer
    made = list(tflow.transform.transforms)[1].autoregressive_net
    rows = t[1]["wf"][: made.final_layer.weight.shape[0]]
    assert torch.equal(rows.sort(dim=0).values, made.final_layer.weight.detach().sort(dim=0).values)


def test_pack_weights_relays_the_stacks():
    _, tflow = _pair("nsf_ar", 5)
    static, w, nb, D, _, _, _ = maf_fused._extract(tflow, torch.float32)
    packed = maf_flow_kernel.pack_weights(w, static, nb)
    L, H, P = 2, 32, 11 * 5
    assert packed["wi"].shape == (L, 8, H) and packed["wf"].shape == (L, H, 56)
    assert packed["wb"].shape == (L, 2 * nb, H, H) and packed["bf"].shape == (L, 56)
    assert torch.equal(packed["wi"][1, :D], w["wi"][H:2 * H].T)
    assert not packed["wi"][:, D:].any() and not packed["wf"][:, :, P:].any()
    assert torch.equal(packed["wb"][1, 2], w["wb"][(1 * 2 * nb + 2) * H:(1 * 2 * nb + 3) * H].T)
    assert torch.equal(packed["wf"][1, :, :P], w["wf"][P:2 * P].T)
    assert torch.equal(packed["bf"][0, :P], w["bf"][:P, 0])
    assert torch.equal(packed["bi"][1], w["bi"][H:2 * H, 0])
    assert packed["idx"].tolist() == [list(ls.perm_rows) + list(ls.inv_perm_rows) + [0]
                                      for ls in static]
    again = maf_flow_kernel.pack_weights({k: 2 * v for k, v in w.items()}, static, nb,
                                         out=packed)
    assert again is packed and torch.equal(packed["wi"][1, :D], 2 * w["wi"][H:2 * H].T)


@pytest.mark.parametrize("n", [100, 129, 1])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_chain_matches_jax_kernel(kind, n):
    """129 and 1 are ragged against the JAX kernel's lane tile of 128 (its
    view pads); the port's chain takes any batch."""
    jflow, tflow = _pair(kind, 5, seed=1)
    jfused = jax_fused.fuse_maf(jflow, dtype=jnp.float32, lanes=128, interpret=True)
    tfused = maf_fused.fuse_maf(tflow)
    x = _normal(n, (n, 5))
    before = maf_flow_kernel.launch_count
    with torch.no_grad():
        y, lad = tfused.forward(torch.from_numpy(x))
        jy, jlad = jfused.forward(jnp.asarray(x))
        # the IAF's forward is the fixed point, the others' inverse
        fwd = dict(atol=1e-4, rtol=1e-5) if kind == "iaf" else dict(atol=1e-5)
        inv = dict(atol=1e-5) if kind == "iaf" else dict(atol=1e-4, rtol=1e-5)
        _close(y, jy, **fwd)
        _close(lad, jlad, **fwd)
        back, lad_back = tfused.inverse(torch.from_numpy(x))
        jback, jlad_back = jfused.inverse(jnp.asarray(x))
        _close(back, jback, **inv)
        _close(lad_back, jlad_back, **inv)
        again, _ = tfused.forward(back)
        _close(again, x, 2e-4)
    assert maf_flow_kernel.launch_count == before      # the plain version launches nothing


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_view_matches_the_unfused_flow(kind):
    _, tflow = _pair(kind, 6, seed=3)
    fused = maf_fused.fuse_maf(tflow)
    assert fused.features == 6 and fused.context_features is None
    x, z = torch.from_numpy(_normal(7, (50, 6))), torch.from_numpy(_normal(8, (50, 6)))
    with torch.no_grad():
        _close(fused.log_prob(x), tflow.log_prob(x), 1e-4)
        xs, lad = tflow.transform.inverse(z)
        fs, flad = fused.inverse(z)
        _close(fs, xs, 1e-4)
        _close(flad, lad, 1e-4)
        s, lp = fused.sample_and_log_prob(torch.Generator().manual_seed(0), 64)
        assert s.shape == (64, 6) and lp.shape == (64,)
        _close(lp, fused.log_prob(s), 2e-4)
        assert fused.sample(torch.Generator().manual_seed(0), 9).shape == (9, 6)


@pytest.mark.parametrize("inverse", [False, True])
def test_wh_scale_equals_the_folded_weights(inverse):
    _, tflow = _pair("nsf_ar", 5)
    static, folded, nb, _, tr, skw, _ = maf_fused._extract(tflow, torch.float32)
    unfolded = maf_fused._extract(tflow, torch.float32, fold_wh_scale=False)[1]
    x = torch.from_numpy(_normal(1, (70, 5)))
    kw = dict(inverse=inverse, num_blocks=nb, transformer=tr, spline_kw=skw)
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(x, folded, static, **kw)
    y_s, lad_s = maf_flow_kernel.maf_flow_kernel_cuda(
        x, unfolded, static, wh_scale=1.0 / np.sqrt(32.0), **kw)
    _close(y_s, y, 2e-5)
    _close(lad_s, lad, 2e-5)
    assert not torch.equal(unfolded["wf"], folded["wf"])


def test_plain_chain_in_float64_is_a_reference():
    _, tflow = _pair("maf", 5)
    static, w, nb, _, tr, skw, _ = maf_fused._extract(tflow, torch.float32)
    x = torch.from_numpy(_normal(2, (30, 5)))
    kw = dict(inverse=True, num_blocks=nb, transformer=tr, spline_kw=skw)
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(x, w, static, **kw)
    y64, lad64 = maf_flow_kernel.maf_flow_kernel_plain(
        x.double(), {k: v.double() for k, v in w.items()}, static, **kw)
    assert y64.dtype == torch.float64
    _close(y, y64, 1e-4)
    _close(lad, lad64, 1e-4)


def _ar(**kw):
    return MaskedAutoregressiveFlow(5, 16, 2, 1, device="cpu", **kw)


def _set_layer(flow, i, layer):
    flow.transform.transforms[i] = layer
    return flow


REFUSALS = {
    "feedforward_made": (lambda: _ar(use_residual_blocks=False),
                         "fused path requires residual-block MADE"),
    "tanh": (lambda: _ar(activation=torch.tanh), "fused MADE requires relu activation"),
    "dropout": (lambda: _ar(dropout_probability=0.1), "dropout MADE not fused"),
    "context": (lambda: NeuralSplineFlowAR(5, 16, num_layers=2, num_bins=4,
                                           context_features=3, device="cpu"),
                "conditional flows are not fused in this port yet"),
    "coupling_flow": (lambda: NeuralSplineFlow(6, 16, num_layers=2, num_bins=4, device="cpu"),
                      "only affine / RQ-spline autoregressive layers are fused"),
    "no_tails": (lambda: _set_layer(
        NeuralSplineFlowAR(5, 16, num_layers=2, num_bins=4, device="cpu"), 3,
        MaskedPiecewiseRationalQuadraticAutoregressiveTransform(
            5, 16, num_bins=4, tails=None, device="cpu")),
        "fused NSF-AR requires tails='linear'"),
    "mixed_layers": (lambda: _set_layer(
        _ar(), 3, NeuralSplineFlowAR(5, 16, num_layers=1, num_bins=4,
                                     device="cpu").transform.transforms[1]),
        "layers must be homogeneous to fuse"),
    "odd_chain": (lambda: _set_layer(_ar(), 3, _ar().transform.transforms[0]),
                  "only affine / RQ-spline autoregressive layers are fused"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals(case):
    build, message = REFUSALS[case]
    flow = build()
    assert not maf_fused.can_fuse_maf(flow)
    with pytest.raises(ValueError, match=message):
        maf_fused.fuse_maf(flow)
    served = CompiledFlow(flow, 16, flow.transform.transforms[0].permutation.numel(),
                          context_features=3 if case == "context" else None, device="cpu")
    assert served.is_fused == (case == "coupling_flow")      # that one is B2's


def test_refusal_messages_are_the_jax_ones():
    """The same flow is refused for the same reason in both packages."""
    jflow = JaxMAF(features=5, hidden_features=16, num_layers=2, num_blocks_per_layer=1,
                   use_residual_blocks=False, key=jax.random.key(0))
    with pytest.raises(ValueError, match="fused path requires residual-block MADE"):
        jax_fused.fuse_maf(jflow, dtype=jnp.float32, interpret=True)
    wrapped = JaxIAF(features=5, hidden_features=16, num_layers=2, num_blocks_per_layer=1,
                     key=jax.random.key(0))
    for extract, flow, dtype in (
            (jax_fused._extract, wrapped, jnp.float32),
            (maf_fused._extract, InverseAutoregressiveFlow(5, 16, 2, 1, device="cpu"),
             torch.float32)):
        with pytest.raises(ValueError, match="InverseTransform-wrapped"):
            extract(flow, dtype, allow_wrapped=False)


def test_other_dtypes_and_widths_are_refused():
    flow = _ar()
    with pytest.raises(NotImplementedError, match="fp32 weights only"):
        maf_fused.fuse_maf(flow, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        maf_fused.fuse_maf(MaskedAutoregressiveFlow(5, 30, 2, 1, device="cpu"))
    assert maf_flow_kernel.shared_memory_bytes(64, 10, 256, 20) <= 232448
    assert maf_flow_kernel.shared_memory_bytes(64, 10, 256, 230) <= 232448
    assert maf_flow_kernel.tile_rows(4096, 10, 256, 20, sms=132) == 32   # 64 tiles would idle SMs
    assert maf_flow_kernel.tile_rows(16384, 10, 256, 20, sms=132) == 64
    assert maf_flow_kernel.tile_rows(16384, 10, 1024, 20, sms=132) == 0


def test_compiled_flow_selects_the_fused_maf_view():
    _, tflow = _pair("maf", 5)
    x = torch.from_numpy(_normal(9, (32, 5)))
    served = CompiledFlow(tflow, batch_size=32, features=5, device="cpu")
    unfused = CompiledFlow(tflow, batch_size=32, features=5, use_fused=False, device="cpu")
    assert served.is_fused and isinstance(served._fused, maf_fused.FusedMAF)
    assert not unfused.is_fused
    _close(served.log_prob(x), unfused.log_prob(x), 1e-4)
    s, lp = served.sample_and_log_prob(torch.Generator().manual_seed(1))
    assert s.shape == (32, 5) and not s.requires_grad
    _close(lp, unfused.log_prob(s), 2e-4)
    with pytest.raises(ValueError, match="context"):
        served.log_prob(x, context=torch.zeros(32, 3))


def test_use_fused_true_gives_both_probers_reasons():
    flow = _ar(use_residual_blocks=False)
    with pytest.raises(ValueError) as err:
        CompiledFlow(flow, 16, 5, use_fused=True, device="cpu")
    text = str(err.value)
    assert "fuse_nsf: " in text and "fuse_maf: fused path requires residual-block MADE" in text
    assert text.index("fuse_nsf") < text.index("fuse_maf")       # probed in that order
    assert flow.transform.transforms[1].autoregressive_net.activation is F.relu
