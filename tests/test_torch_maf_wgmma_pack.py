"""B9's one-pass direction on the wgmma route, on the CPU: the packed weight
image, the ring chunks, the route, and 3xTF32's numerics.

- ``pack_weights_wgmma``'s image, decoded through
  ``nsf_flow_kernel.wgmma_positions`` (the layout function the packer
  scatters through), gives back every mask-folded matrix bit for bit, fp32
  and bf16, affine and rq, with and without a context, unwrapped and
  wrapped layers, at hidden 64 and 128; every pad row and column is zero;
  the biases and index array are the stacks'.
- The producer's walk (``csrc/maf_flow_wgmma.cuh``: maf_produce, the layers
  in the direction's order, each layer's GEMMs as ``wgmma_gemms`` orders
  them, each cut by ``_chunk_steps``) covers the image once, in order,
  chunk by chunk within a ring slot; fp32 chunks are 2, 4 or 8 wgmma steps.
- ``gemm_route`` by shape and forced, and the wrapper's refusals; the
  trainers keep the SIMT route and never pack the image.
- 3xTF32 emulated with bit operations (``cvt.rna.tf32.f32``), its three
  products run through ``maf_flow_kernel_plain``'s chain in place of
  ``gemm``: held in the fp32 bands of chip_smoke.py (1e-3 against the fp32
  plain chain, or within twice its distance from float64) on the one-pass
  directions of a MAF, an NSF-AR and an IAF, with and without a context,
  and within 1e-4 of the JAX package's B9 (its Pallas kernel in interpret
  mode) on y, the logabsdet and log_prob; and within chip_smoke.py's
  ``ONE_PASS_LIMITS`` (each relative-error quantile against float64 within
  ten times the fp32 plain chain's), which one TF32 product a product
  misses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.distributions import StandardNormal as JaxStandardNormal
from nflows_tpu.flows import Flow as JaxFlow
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.ops.pallas import maf_fused as jax_fused
from nflows_tpu.ops.pallas.maf_flow_kernel import maf_flow_kernel_call
from nflows_tpu.transforms import CompositeTransform as JaxComposite
from nflows_tpu.transforms import InverseTransform as JaxInverse
from nflows_tpu.transforms import MaskedAffineAutoregressiveTransform as JaxAffineAR
from nflows_tpu.transforms import RandomPermutation as JaxRandomPermutation
from nflows_tpu_torch import Flow, NeuralSplineFlowAR, fused_trainer, load_jax_params
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.ops.cuda import maf_flow_kernel as k
from nflows_tpu_torch.ops.cuda import maf_fused
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import _WG_SLOT, _chunk_steps, wgmma_positions
from nflows_tpu_torch.transforms import (
    CompositeTransform,
    InverseTransform,
    MaskedAffineAutoregressiveTransform,
    MaskedPiecewiseRationalQuadraticAutoregressiveTransform,
    RandomPermutation,
)

torch.set_num_threads(1)

D = 5


def _chain(transformer, wrapped, hidden, context=None, layers=2, seed=0):
    """layers x [random permutation, residual MADE (2 blocks)] of D
    features: affine or rq (4 bins, linear tails at 3), each layer wrapped
    in InverseTransform where ``wrapped``; the blocks' second linears at
    the first's scale, so that no block is near the identity."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    chain = []
    for _ in range(layers):
        if transformer == "rq":
            layer = MaskedPiecewiseRationalQuadraticAutoregressiveTransform(
                D, hidden, context_features=context, num_bins=4, tails="linear",
                tail_bound=3.0, num_blocks=2, generator=g, device="cpu")
        else:
            layer = MaskedAffineAutoregressiveTransform(D, hidden, context_features=context,
                                                        num_blocks=2, generator=g, device="cpu")
        chain += [RandomPermutation(D, rng=rng, device="cpu"),
                  InverseTransform(layer) if wrapped else layer]
    flow = Flow(CompositeTransform(chain), StandardNormal([D]))
    with torch.no_grad():
        for t in flow.transform.transforms:
            net = getattr(getattr(t, "transform", t), "autoregressive_net", None)
            for blk in getattr(net, "blocks", ()):
                w = blk.linear_1.weight
                w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) / w.shape[1] ** 0.5)
    return flow.eval()


CASES = [(tr, wrapped, ctx) for tr in ("affine", "rq") for wrapped in (False, True)
         for ctx in (None, 3)]
CASE_IDS = [f"{tr}-{'wrapped' if w else 'unwrapped'}-{'ctx' if c else 'noctx'}"
            for tr, w, c in CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128])
@pytest.mark.parametrize("transformer,wrapped,context", CASES, ids=CASE_IDS)
def test_image_decodes_to_every_matrix_bit_for_bit(transformer, wrapped, context, hidden,
                                                   dtype):
    fused = maf_fused.fuse_maf(_chain(transformer, wrapped, hidden, context), dtype=dtype)
    w, static, nb = fused._weights, fused._static, fused._num_blocks
    wp = k.pack_weights_wgmma(w, static, nb)
    L, H = len(static), hidden
    P = w["wf"].shape[0] // L
    C = context or 0
    dims = k.wgmma_dims(D, P, C)
    assert {key: wp[key] for key in dims} == dims
    assert dims["Ip"] == 16 and dims["TMp"] == 64 and dims["Cp"] == (16 if C else 0)
    image = wp["image"]
    assert image.dtype == dtype and image.ndim == 1 and image.is_contiguous()
    layer = image.reshape(L, -1)
    assert wp["layer_bytes"] == layer.shape[1] * image.element_size()

    real = dict(wi=w["wi"].view(L, H, D), wb=w["wb"].view(L, 2 * nb, H, H),
                wf=w["wf"].view(L, P, H))
    if C:
        real.update(wci=w["wci"].view(L, H, C), wcb=w["wcb"].view(L, nb, H, C))
    start = 0
    for name, j in k.wgmma_gemms(nb, bool(C)):
        m = real[name] if j is None else real[name][:, j]
        O = dims["TMp"] if name == "wf" else H
        K = {"wi": dims["Ip"], "wci": dims["Cp"], "wcb": dims["Cp"]}.get(name, H)
        got = layer[:, start:start + O * K][:, wgmma_positions(O, K, dtype)]   # [L, O, K]
        start += O * K
        o, kk = m.shape[1], m.shape[2]
        assert torch.equal(got[:, :o, :kk], m), name
        assert not got[:, o:].any() and not got[:, :, kk:].any(), f"{name}: pads not zero"
    assert start == layer.shape[1]
    # a masked entry is a zero of the image: the masks are folded in
    assert int((layer == 0).sum()) > L * (H * (dims["Ip"] - D) + (dims["TMp"] - P) * H)

    assert torch.equal(wp["bi"], w["bi"].view(L, H))
    assert torch.equal(wp["bb"], w["bb"].view(L, 2 * nb, H))
    assert torch.equal(wp["bf"][:, :P], w["bf"].view(L, P)) and not wp["bf"][:, P:].any()
    assert torch.equal(wp["idx"], k.pack_weights(w, static, nb)["idx"])
    if C:
        assert torch.equal(wp["bci"], w["bci"].view(L, H))
        assert torch.equal(wp["bcb"], w["bcb"].view(L, nb, H))
    else:
        assert "bci" not in wp and "bcb" not in wp


def _producer_walk(L, H, Ip, Cp, TMp, nb, es, inverse):
    """(layer, offset in the layer, bytes, wgmma steps) of every chunk the
    producer warp sends, in order, as csrc/maf_flow_wgmma.cuh's maf_produce
    walks the image."""
    out = []
    for step in range(L):
        layer = L - 1 - step if inverse else step
        at = 0
        gemms = ([(Cp, H // 64)] if Cp else []) + [(Ip, H // 64)]
        for _ in range(nb):
            gemms += [(H, H // 64)] + ([(Cp, H // 64)] if Cp else []) + [(H, H // 64)]
        for K, ns in gemms + [(H, TMp // 64)]:
            nk = K * es // 32
            kc = _chunk_steps(nk, ns)
            for k0 in range(0, nk, kc):
                kn = min(kc, nk - k0)
                out.append((layer, at, ns * kn * 2048, kn))
                at += ns * kn * 2048
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,context,P", [(64, 0, 10), (128, 3, 55), (256, 10, 230),
                                              (256, 0, 20), (192, 40, 130)])
@pytest.mark.parametrize("inverse", [False, True])
def test_chunks_cover_the_image_once_in_kernel_order(hidden, context, P, dtype, inverse):
    es = torch.empty((), dtype=dtype).element_size()
    L, nb = 3, 2
    dims = k.wgmma_dims(10 if P in (20, 230) else D, P, context)
    walk = _producer_walk(L, hidden, dims["Ip"], dims["Cp"], dims["TMp"], nb, es, inverse)
    order = list(range(L - 1, -1, -1)) if inverse else list(range(L))
    assert [layer for layer, *_ in walk] == sorted(
        [layer for layer, *_ in walk], key=order.index)
    layer_elems = sum((dims["TMp"] if name == "wf" else hidden)
                      * {"wi": dims["Ip"], "wci": dims["Cp"], "wcb": dims["Cp"]}.get(name, hidden)
                      for name, _ in k.wgmma_gemms(nb, bool(context)))
    for layer in range(L):
        chunks = [(at, size, kn) for lay, at, size, kn in walk if lay == layer]
        ends = [at + size for at, size, _ in chunks]
        assert [at for at, *_ in chunks] == [0] + ends[:-1]        # contiguous, in order
        assert ends[-1] == layer_elems * es                        # the layer, once
        assert all(size <= _WG_SLOT for _, size, _ in chunks)
        if dtype == torch.float32:
            assert all(kn in (2, 4, 8) for *_, kn in chunks)       # chunk_tf32's sizes


def test_padded_depths_and_shared_memory():
    assert [k._pad_depth(n) for n in (1, 10, 16, 17, 32, 33, 64, 65, 200)] == [
        16, 16, 16, 32, 32, 64, 64, 128, 256]
    # the MAF and the conditional NSF-AR at full width: ring, operand hi (P
    # [32][260] fp32 outgrows the [32][256] fp32 operand), lo, context
    # planes, barriers, and the state, input and logabsdets
    state = 4 * 32 * (3 * 10 + 1)
    assert k.wgmma_shared_memory_bytes(10, 256, 20, 0, torch.float32) == (
        4 * 32768 + 2 * 32 * 256 * 4 + 64 + state)
    assert k.wgmma_shared_memory_bytes(10, 256, 230, 10, torch.float32) == (
        4 * 32768 + 32 * 260 * 4 + 32 * 256 * 4 + 2 * 32 * 16 * 4 + 64 + state)
    assert k.wgmma_shared_memory_bytes(10, 256, 230, 10, torch.bfloat16) == (
        4 * 32768 + 32 * 260 * 4 + 32 * 16 * 2 + 64 + state)
    for dtype in (torch.float32, torch.bfloat16):
        assert k.wgmma_shared_memory_bytes(10, 256, 256, 64, dtype) <= k.MAX_SHARED_MEMORY


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_shape(dtype):
    # the MAF, NSF-AR and their conditional twins at full width
    for P, C in ((20, 0), (230, 0), (20, 10), (230, 10)):
        assert k.gemm_route(256, 10, P, C, dtype) == "wgmma"
    assert k.gemm_route(64, 5, 10, 0, dtype) == "wgmma"
    assert k.gemm_route(128, 5, 55, 3, dtype) == "wgmma"
    # widths the tensor-core tile does not take stay on the SIMT kernel
    assert k.gemm_route(32, 5, 10, 0, dtype) == "simt"
    assert k.gemm_route(96, 5, 10, 0, dtype) == "simt"
    assert k.gemm_route(320, 10, 20, 0, dtype) == "simt"
    assert k.gemm_route(256, 20, 300, 0, dtype) == "simt"
    # forced
    assert k.gemm_route(256, 10, 20, 0, dtype, gemm="simt") == "simt"
    assert k.gemm_route(256, 10, 20, 0, dtype, gemm="wgmma") == "wgmma"
    with pytest.raises(ValueError, match="wgmma"):
        k.gemm_route(32, 5, 10, 0, dtype, gemm="wgmma")
    with pytest.raises(ValueError, match="gemm must be"):
        k.gemm_route(256, 10, 20, 0, dtype, gemm="tf32")


@pytest.mark.parametrize("wrapped", [False, True])
def test_wrapper_routes_and_refuses_a_forced_route_on_the_cpu(wrapped):
    """``gemm=`` is checked whatever the device; a CPU tensor then runs the
    plain version. wgmma takes the one-pass direction only (forward for
    unwrapped layers, inverse for wrapped ones), with schedule=None."""
    fused = maf_fused.fuse_maf(_chain("affine", wrapped, 64))
    narrow = maf_fused.fuse_maf(_chain("affine", wrapped, 32))
    x = torch.randn(7, D, generator=torch.Generator().manual_seed(0))
    one_pass = dict(inverse=wrapped, num_blocks=2, transformer="affine")
    fixed = dict(one_pass, inverse=not wrapped)
    assert k.one_pass(fused._static, wrapped) and not k.one_pass(fused._static, not wrapped)
    assert k.weights_route(fused._weights, fused._static, 2) == "wgmma"
    assert k.weights_route(narrow._weights, narrow._static, 2) == "simt"
    y, lad = k.maf_flow_kernel_cuda(x, fused._weights, fused._static, gemm="wgmma", **one_pass)
    p_y, p_lad = k.maf_flow_kernel_plain(x, fused._weights, fused._static, **one_pass)
    assert torch.equal(y, p_y) and torch.equal(lad, p_lad)
    y, _ = k.maf_flow_kernel_cuda(x, fused._weights, fused._static, gemm="simt", **fixed)
    assert torch.equal(y, k.maf_flow_kernel_plain(x, fused._weights, fused._static, **fixed)[0])
    with pytest.raises(ValueError, match="wgmma"):
        k.maf_flow_kernel_cuda(x, narrow._weights, narrow._static, gemm="wgmma", **one_pass)
    with pytest.raises(ValueError, match="one MADE pass"):
        k.maf_flow_kernel_cuda(x, fused._weights, fused._static, gemm="wgmma", **fixed)
    with pytest.raises(ValueError, match="one MADE pass"):
        k.maf_flow_kernel_cuda(x, fused._weights, fused._static, gemm="wgmma",
                               schedule="fixed_point", **one_pass)
    with pytest.raises(ValueError, match="gemm must be"):
        k.maf_flow_kernel_cuda(x, fused._weights, fused._static, gemm="tf32", **one_pass)
    mixed = [*fused._static[:1], fused._static[1]._replace(wrapped=not wrapped)]
    assert not k.one_pass(mixed, False) and not k.one_pass(mixed, True)


@pytest.mark.parametrize("kind", ["maf", "iaf"])
def test_trainers_keep_the_simt_route(kind, monkeypatch):
    """The fused MAF step and the IAF's reverse-KL step launch B9's SIMT
    kernel (``gemm="simt"``) and never pack the wgmma image."""
    calls = []
    cuda_call = k.maf_flow_kernel_cuda

    def spy(*args, **kwargs):
        calls.append(kwargs.get("gemm"))
        return cuda_call(*args, **kwargs)

    def no_image(*args, **kwargs):
        raise AssertionError("a trainer packed the wgmma image")

    monkeypatch.setattr(k, "maf_flow_kernel_cuda", spy)
    monkeypatch.setattr(k, "pack_weights_wgmma", no_image)
    flow = _chain("affine", kind == "iaf", 64, layers=2)
    tr = fused_trainer(flow, 128)
    opt = lambda params: torch.optim.Adam(params, lr=1e-3)  # noqa: E731
    x = torch.randn(128, D, generator=torch.Generator().manual_seed(1))
    if kind == "iaf":
        step = tr.make_vi_train_step(tr.init_opt(opt), lambda v: -0.5 * (v * v).sum(dim=1))
        loss = step(torch.Generator().manual_seed(2))
    else:
        loss = tr.make_train_step(tr.init_opt(opt))(x)
    assert torch.isfinite(torch.as_tensor(loss)).all()
    with torch.no_grad():
        tr._apply(tr.weights, x)
    assert calls and all(g == "simt" for g in calls), calls


# -- 3xTF32 ------------------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on fp32 values: round the magnitude to 10 mantissa
    bits, ties away from zero (csrc/wgmma_chain.cuh: tf32_rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def gemm_3xtf32(a, w):
    """``a @ w.T`` as the wgmma route's fp32 kernel forms it: the three
    TF32 products A_lo B_hi + A_hi B_lo + A_hi B_hi, each exact in fp32,
    summed in fp32."""
    a_hi, a_lo = _split(a)
    w_hi, w_lo = _split(w)
    return (w_lo @ a_hi.T + w_hi @ a_lo.T + w_hi @ a_hi.T).T


def gemm_tf32(a, w):
    """``a @ w.T`` with one TF32 product a product, summed in fp32: the
    precision chip_smoke.py's ONE_PASS_LIMITS must refuse."""
    return tf32_rna(a) @ tf32_rna(w).T


# chip_smoke.ONE_PASS_LIMITS: median, 90%, 99% and max
ONE_PASS_LIMITS = (10.0, 10.0, 10.0, 10.0)


def _quantiles(t, exact):
    """chip_smoke.hold_relative's quantiles: per-sample relative errors
    against float64, |a - f64| / (1 + |f64|), the largest over a sample's
    features; their median, 90th and 99th percentiles and maximum."""
    e = (t.double() - exact).abs() / (1.0 + exact.abs())
    e = e.reshape(e.shape[0], -1).max(dim=1).values
    q = torch.quantile(e, torch.tensor([0.5, 0.9, 0.99], dtype=e.dtype))
    return [*q.tolist(), float(e.max())]


@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("kind", ["affine", "rq", "iaf"])
def test_one_pass_limits_take_3xtf32_and_refuse_one_tf32_product(kind, context, monkeypatch):
    """The card's relative hold on B9's fp32 one pass tells 3xTF32 from a
    lower precision, which the absolute band (1e-3) does only at its edge:
    3xTF32 emulated through the chain lies within ONE_PASS_LIMITS of the
    fp32 plain chain's quantiles, one TF32 product a product outside them at
    every quantile (the distances from the plain chain printed beside)."""
    fused = maf_fused.fuse_maf(_chain("affine" if kind == "iaf" else kind, kind == "iaf", 64,
                                      context=context, seed=3))
    w, st = fused._weights, fused._static
    g = torch.Generator().manual_seed(4)
    x = 1.5 * torch.randn(512, D, generator=g)
    ctx = None if context is None else torch.randn(512, context, generator=g)
    kw = dict(inverse=kind == "iaf", num_blocks=fused._num_blocks,
              transformer=fused._transformer, spline_kw=fused._spline_kw)
    assert k.one_pass(st, kw["inverse"])
    with torch.no_grad():
        plain = k.maf_flow_kernel_plain(x, w, st, context=ctx, **kw)
        exact = k.maf_flow_kernel_plain(
            x.double(), {key: v.double() for key, v in w.items()}, st,
            context=None if ctx is None else ctx.double(), **kw)
        got = {}
        for name, fn in (("3xtf32", gemm_3xtf32), ("tf32", gemm_tf32)):
            monkeypatch.setattr(k, "gemm", fn)
            got[name] = k.maf_flow_kernel_cuda(x, w, st, gemm="wgmma", context=ctx, **kw)
    for i, what in enumerate(("out", "lad")):
        p = _quantiles(plain[i], exact[i])
        q3, q1 = _quantiles(got["3xtf32"][i], exact[i]), _quantiles(got["tf32"][i], exact[i])
        print(f"{kind} context={context} {what}: plain {p}, 3xTF32 {q3}, one TF32 {q1}; one "
              f"TF32 - plain {float((got['tf32'][i] - plain[i]).abs().max()):.3e}")
        assert all(a <= f * b for a, b, f in zip(q3, p, ONE_PASS_LIMITS))
        assert all(a > f * b for a, b, f in zip(q1, p, ONE_PASS_LIMITS))


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _jax_pair(kind, context, hidden=64, seed=0):
    """(JAX flow, port flow) of one model on the same weights: 2 x
    [permutation, residual MADE (2 blocks)], context 3 where given; affine
    (maf), RQ with 4 bins (nsf_ar) or affine layers wrapped in
    InverseTransform (iaf)."""
    if kind == "nsf_ar":
        kw = dict(features=D, hidden_features=hidden, num_layers=2, num_blocks_per_layer=2,
                  num_bins=4, tail_bound=3.0, context_features=context)
        jflow = JaxNSFAR(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
        tflow = NeuralSplineFlowAR(device="cpu", rng=np.random.default_rng(seed + 100), **kw)
    else:
        rng, keys = np.random.default_rng(seed), jax.random.split(jax.random.key(seed), 2)
        trng = np.random.default_rng(seed + 100)
        jchain, tchain = [], []
        for i in range(2):
            jlayer = JaxAffineAR(features=D, hidden_features=hidden, context_features=context,
                                 num_blocks=2, key=keys[i])
            tlayer = MaskedAffineAutoregressiveTransform(
                D, hidden, context_features=context, num_blocks=2, device="cpu")
            if kind == "iaf":
                jlayer, tlayer = JaxInverse(jlayer), InverseTransform(tlayer)
            jchain += [JaxRandomPermutation(D, rng=rng), jlayer]
            tchain += [RandomPermutation(D, rng=trng, device="cpu"), tlayer]
        jflow = JaxFlow(transform=JaxComposite(jchain), distribution=JaxStandardNormal([D]))
        tflow = Flow(CompositeTransform(tchain), StandardNormal([D]))
    # the blocks' second linears at the first's scale (as chip_smoke.py's lively_blocks)
    jflow = jax.tree_util.tree_map_with_path(
        lambda path, v: v * (1e3 / hidden ** 0.5)
        if "linear_1.weight" in jax.tree_util.keystr(path) else v, jflow)
    load_jax_params(tflow, _jax_params(jflow))
    return jflow, tflow.eval()


def _err(a, b):
    return float(np.abs(np.array(a, dtype=np.float64) - np.array(b, dtype=np.float64)).max())


@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("kind", ["maf", "nsf_ar", "iaf"])
def test_3xtf32_one_pass_chain_holds_the_fp32_bands_and_the_jax_kernel(kind, context,
                                                                       monkeypatch):
    jflow, tflow = _jax_pair(kind, context, seed=1)
    static, jw, nb, _, tr, skw, _ = jax_fused._extract(jflow, jnp.float32)
    fused = maf_fused.fuse_maf(tflow)
    w, st = fused._weights, fused._static
    inverse = kind == "iaf"                      # the one-pass direction
    rng = np.random.default_rng(2)
    x = (1.5 * rng.standard_normal((128, D))).astype(np.float32)
    c = rng.standard_normal((128, 3)).astype(np.float32) if context else None
    tc = None if c is None else torch.from_numpy(c)
    kw = dict(inverse=inverse, num_blocks=fused._num_blocks, transformer=fused._transformer,
              spline_kw=fused._spline_kw)
    assert k.one_pass(st, inverse)
    with torch.no_grad():
        p_y, p_lad = k.maf_flow_kernel_plain(torch.from_numpy(x), w, st, context=tc, **kw)
        d_y, d_lad = k.maf_flow_kernel_plain(
            torch.from_numpy(x).double(), {key: v.double() for key, v in w.items()}, st,
            context=None if tc is None else tc.double(), **kw)
        monkeypatch.setattr(k, "gemm", gemm_3xtf32)
        t_y, t_lad = k.maf_flow_kernel_cuda(torch.from_numpy(x), w, st, gemm="wgmma",
                                            context=tc, **kw)
    ctx_kw = {} if c is None else dict(ctx_t=jnp.asarray(c.T), wci=jw["wci"], bci=jw["bci"],
                                       wcb=jw["wcb"], bcb=jw["bcb"])
    jy, jlad = maf_flow_kernel_call(
        jnp.asarray(x.T), jw["wi"], jw["bi"], jw["wb"], jw["bb"], jw["wf"], jw["bf"], static,
        inverse=inverse, num_blocks=nb, transformer=tr, spline_kw=skw, lanes=128,
        interpret=True, **ctx_kw)
    jy, jlad = np.asarray(jy).T, np.asarray(jlad)[0]

    for what, got, plain, exact in (("out", t_y, p_y, d_y), ("lad", t_lad, p_lad, d_lad)):
        e_kp, e_k64, e_p64 = _err(got, plain), _err(got, exact), _err(plain, exact)
        print(f"{kind} context={context} {what}: 3xTF32 - fp32 plain {e_kp:.3e}, "
              f"3xTF32 - f64 {e_k64:.3e}, fp32 plain - f64 {e_p64:.3e}")
        assert torch.isfinite(got).all()
        assert e_kp <= 1e-3 or e_k64 <= 2.0 * e_p64
        assert e_k64 <= max(4.0 * e_p64, 1e-5)
    assert _err(t_y, jy) <= 1e-4 and _err(t_lad, jlad) <= 1e-4
    if not inverse:
        log_prob = lambda y, lad: -0.5 * (y * y).sum(1) - 0.5 * D * np.log(2 * np.pi) + lad  # noqa: E731
        assert _err(log_prob(t_y.double().numpy(), t_lad.double().numpy()),
                    log_prob(jy.astype(np.float64), jlad.astype(np.float64))) <= 1e-4
