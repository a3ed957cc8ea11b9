"""B11 on the wgmma route, on the CPU: the packed weight image, the ring
chunks, the route, and 3xTF32's numerics.

- ``pack_weights_wgmma``'s image, decoded through
  ``nsf_flow_kernel.wgmma_positions`` (the layout function the packer
  scatters through), gives back every mask-folded matrix bit for bit, fp32
  and bf16, with and without a context, at hidden 64 and 128, with a final
  layer of one pass (36 parameter rows, padded to 64) and of two (300
  rows, padded to 320: rows 0-255, then 256-319); every pad row and column
  is zero; the biases are the stacks'.
- The producer's walk (``csrc/mademog_wgmma.cuh``: mog_produce, the GEMMs
  as ``wgmma_gemms`` orders them, each cut by ``_chunk_steps``) covers the
  image once, in order, chunk by chunk within a ring slot; fp32 chunks are
  2, 4 or 8 wgmma steps.
- ``gemm_route`` by shape and forced, and the wrapper's refusals; the
  fused trainer keeps the SIMT route and never packs the image.
- 3xTF32 emulated with bit operations (``cvt.rna.tf32.f32``), its three
  products run through ``mademog_log_prob_plain``'s MADE in place of
  ``gemm``: within 1e-3 of the fp32 plain version (or twice its distance
  from float64), within 1e-4 of the JAX package's B11 (its Pallas kernel in
  interpret mode), and within chip_smoke.py's ``ONE_PASS_LIMITS`` (each
  relative-error quantile against float64 within ten times the fp32 plain
  version's), which one TF32 product a product misses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.nn.nde.made import MixtureOfGaussiansMADE as JaxMoG
from nflows_tpu.ops.pallas import mademog_fused as jax_fused
from nflows_tpu_torch import MixtureOfGaussiansMADE, fused_trainer, load_jax_params
from nflows_tpu_torch.ops.cuda import mademog_fused as k
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import _WG_SLOT, _chunk_steps, wgmma_positions

torch.set_num_threads(1)

# (features, components): 36 parameter rows (one pass of the final layer)
# and 300 (two passes, the benchmark's widths)
SHAPES = {"one_pass": (4, 3), "two_pass": (10, 10)}


def _model(shape, hidden, context=None, seed=0):
    """A residual MixtureOfGaussiansMADE (2 blocks) with its blocks' second
    linears redrawn at the first's scale, so that no block is near the
    identity (as initialised they are U(+-1e-3))."""
    D, K = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    model = MixtureOfGaussiansMADE(features=D, hidden_features=hidden, context_features=context,
                                   num_blocks=2, num_mixture_components=K, generator=g,
                                   rng=np.random.default_rng(seed), device="cpu")
    with torch.no_grad():
        for blk in model.blocks:
            w = blk.linear_1.weight
            w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) / w.shape[1] ** 0.5)
    return model.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128])
@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_image_decodes_to_every_matrix_bit_for_bit(shape, context, hidden, dtype):
    fused = k.fuse_mademog(_model(shape, hidden, context), dtype=dtype)
    w, static = fused._weights, fused._static
    wp = k.pack_weights_wgmma(w, static)
    D, K, H, nb = static["D"], static["K"], static["H"], static["num_blocks"]
    P, C = 3 * K * D, context or 0
    dims = k.wgmma_dims(D, K, C)
    assert {key: wp[key] for key in dims} == dims
    assert dims["Ip"] == 16 and dims["Cp"] == (16 if C else 0)
    assert dims["TMp"] == {"one_pass": 64, "two_pass": 320}[shape]
    passes = k.final_passes(dims["TMp"])
    assert len(passes) == {"one_pass": 1, "two_pass": 2}[shape]
    image = wp["image"]
    assert image.dtype == dtype and image.ndim == 1 and image.is_contiguous()

    real = dict(wi=w["wi"], wb=w["wb"].view(2 * nb, H, H), wf=w["wf"])
    if C:
        real.update(wci=w["wci"], wcb=w["wcb"].view(nb, H, C))
    start = 0
    for name, j in k.wgmma_gemms(nb, bool(C), dims["TMp"]):
        if name == "wf":
            r0, O = passes[j]
            m = real["wf"][r0:r0 + O]                  # rows past P are pads
        else:
            O = H
            m = real[name] if j is None else real[name][j]
        Kd = {"wi": dims["Ip"], "wci": dims["Cp"], "wcb": dims["Cp"]}.get(name, H)
        got = image[start:start + O * Kd][wgmma_positions(O, Kd, dtype)]       # [O, Kd]
        start += O * Kd
        o, kk = m.shape
        assert torch.equal(got[:o, :kk], m), (name, j)
        assert not got[o:].any() and not got[:, kk:].any(), f"{name}: pads not zero"
    assert start == image.numel() == k._image_elems(H, nb, dims)
    # a masked entry is a zero of the image: the masks are folded in
    assert int((image == 0).sum()) > H * (dims["Ip"] - D) + (dims["TMp"] - P) * H

    assert torch.equal(wp["bi"], w["bi"].view(H))
    assert torch.equal(wp["bb"], w["bb"].view(2 * nb, H))
    assert torch.equal(wp["bf"][:P], w["bf"].view(P)) and not wp["bf"][P:].any()
    if C:
        assert torch.equal(wp["bci"], w["bci"].view(H))
        assert torch.equal(wp["bcb"], w["bcb"].view(nb, H))
    else:
        assert "bci" not in wp and "bcb" not in wp


def _producer_walk(H, Ip, Cp, TMp, nb, es):
    """(offset, bytes, wgmma steps) of every chunk the producer warp sends,
    in order, as csrc/mademog_wgmma.cuh's mog_produce walks the image."""
    gemms = ([(Cp, H // 64)] if Cp else []) + [(Ip, H // 64)]
    for _ in range(nb):
        gemms += [(H, H // 64)] + ([(Cp, H // 64)] if Cp else []) + [(H, H // 64)]
    gemms += [(H, min(4, TMp // 64 - s0)) for s0 in range(0, TMp // 64, 4)]
    out, at = [], 0
    for K, ns in gemms:
        nk = K * es // 32
        kc = _chunk_steps(nk, ns)
        for k0 in range(0, nk, kc):
            kn = min(kc, nk - k0)
            out.append((at, ns * kn * 2048, kn))
            at += ns * kn * 2048
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,context,D,K", [(64, 0, 4, 3), (128, 3, 10, 10),
                                                (256, 10, 10, 10), (256, 0, 10, 10),
                                                (192, 40, 12, 12), (64, 0, 17, 10)])
def test_chunks_cover_the_image_once_in_kernel_order(hidden, context, D, K, dtype):
    es = torch.empty((), dtype=dtype).element_size()
    nb = 2
    dims = k.wgmma_dims(D, K, context)
    walk = _producer_walk(hidden, dims["Ip"], dims["Cp"], dims["TMp"], nb, es)
    ends = [at + size for at, size, _ in walk]
    assert [at for at, *_ in walk] == [0] + ends[:-1]              # contiguous, in order
    assert ends[-1] == k._image_elems(hidden, nb, dims) * es       # the image, once
    assert all(size <= _WG_SLOT for _, size, _ in walk)
    if dtype == torch.float32:
        assert all(kn in (2, 4, 8) for *_, kn in walk)             # chunk_tf32's sizes
    # the final layer's passes: at most four slabs each, rows in order
    passes = k.final_passes(dims["TMp"])
    assert [r0 for r0, _ in passes] == list(range(0, dims["TMp"], 256))
    assert sum(rows for _, rows in passes) == dims["TMp"]
    assert all(0 < rows <= 256 and rows % 64 == 0 for _, rows in passes)


def test_padded_widths_passes_and_shared_memory():
    assert k.wgmma_dims(10, 10, 10) == dict(Ip=16, Cp=16, TMp=320)
    assert k.wgmma_dims(4, 3) == dict(Ip=16, Cp=0, TMp=64)
    assert k.wgmma_dims(17, 10, 40) == dict(Ip=32, Cp=64, TMp=512)
    assert k.final_passes(64) == [(0, 64)]
    assert k.final_passes(256) == [(0, 256)]
    assert k.final_passes(320) == [(0, 256), (256, 64)]
    assert k.final_passes(512) == [(0, 256), (256, 256)]
    # the MoG-MADE and its conditional twin at full width: the ring, the
    # operand planes (P [32][324] fp32 lies over them), the context
    # planes, the barriers, x and the per-feature log-densities
    rest = 64 + 4 * 32 * 2 * 10
    assert k.wgmma_shared_memory_bytes(10, 10, 256, 10, torch.float32) == (
        4 * 32768 + 2 * 32 * 256 * 4 + 2 * 32 * 16 * 4 + rest)
    assert k.wgmma_shared_memory_bytes(10, 10, 256, 0, torch.float32) == (
        4 * 32768 + 2 * 32 * 256 * 4 + rest)
    # in bf16 P outgrows the one operand plane it lies over
    assert k.wgmma_shared_memory_bytes(10, 10, 256, 10, torch.bfloat16) == (
        4 * 32768 + 32 * 324 * 4 + 32 * 16 * 2 + rest)
    # P beside the fp32 planes would not fit: hence the overlay
    assert (k.wgmma_shared_memory_bytes(10, 10, 256, 10, torch.float32) + 32 * 324 * 4
            > k.MAX_SHARED_MEMORY)
    for dtype in (torch.float32, torch.bfloat16):
        assert k.wgmma_shared_memory_bytes(17, 10, 256, 64, dtype) <= k.MAX_SHARED_MEMORY


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_shape(dtype):
    # the MoG-MADE and the MADEMoG at full width, and narrower models
    for C in (0, 10):
        assert k.gemm_route(10, 10, 256, C, dtype) == "wgmma"
    assert k.gemm_route(4, 3, 64, 0, dtype) == "wgmma"
    assert k.gemm_route(10, 10, 128, 3, dtype) == "wgmma"
    assert k.gemm_route(17, 10, 192, 0, dtype) == "wgmma"           # 510 rows, two passes
    # widths the tensor-core tile does not take stay on the SIMT kernel
    assert k.gemm_route(5, 4, 32, 0, dtype) == "simt"
    assert k.gemm_route(5, 4, 96, 0, dtype) == "simt"
    assert k.gemm_route(10, 10, 320, 0, dtype) == "simt"
    assert k.gemm_route(20, 10, 256, 0, dtype) == "simt"            # 600 rows, three passes
    # forced
    assert k.gemm_route(10, 10, 256, 0, dtype, gemm="simt") == "simt"
    assert k.gemm_route(10, 10, 256, 0, dtype, gemm="wgmma") == "wgmma"
    with pytest.raises(ValueError, match="wgmma"):
        k.gemm_route(5, 4, 32, 0, dtype, gemm="wgmma")
    with pytest.raises(ValueError, match="gemm must be"):
        k.gemm_route(10, 10, 256, 0, dtype, gemm="tf32")


def test_wrapper_routes_and_refuses_a_forced_route_on_the_cpu():
    """``gemm=`` is checked whatever the device; a CPU tensor then runs the
    plain version and launches nothing."""
    fused = k.fuse_mademog(_model("one_pass", 64, 3))
    narrow = k.fuse_mademog(MixtureOfGaussiansMADE(
        features=4, hidden_features=32, context_features=3, num_blocks=2,
        num_mixture_components=3, rng=np.random.default_rng(1), device="cpu").eval())
    assert fused._packed is None                  # a CPU view packs nothing
    assert k.weights_route(fused._weights, fused._static) == "wgmma"
    assert k.weights_route(narrow._weights, narrow._static) == "simt"
    g = torch.Generator().manual_seed(0)
    x, c = torch.randn(7, 4, generator=g), torch.randn(7, 3, generator=g)
    before = (dict(k.route_launch_count), k.launch_count, k.bf16_launch_count)
    plain = k.mademog_log_prob_plain(x, fused._weights, fused._static, c)
    for gemm in (None, "wgmma", "simt"):
        got = k.mademog_log_prob_cuda(x, fused._weights, fused._static, c, gemm=gemm)
        assert torch.equal(got, plain)
    assert torch.equal(k.mademog_log_prob_cuda(x, narrow._weights, narrow._static, c, gemm="simt"),
                       k.mademog_log_prob_plain(x, narrow._weights, narrow._static, c))
    with pytest.raises(ValueError, match="wgmma"):
        k.mademog_log_prob_cuda(x, narrow._weights, narrow._static, c, gemm="wgmma")
    with pytest.raises(ValueError, match="gemm must be"):
        k.mademog_log_prob_cuda(x, fused._weights, fused._static, c, gemm="tf32")
    assert (dict(k.route_launch_count), k.launch_count, k.bf16_launch_count) == before


@pytest.mark.parametrize("context", [None, 3])
def test_trainer_keeps_the_simt_route(context, monkeypatch):
    """The fused MADEMoG step's forward runs B11 with ``gemm="simt"`` and
    never packs the wgmma image."""
    calls = []
    cuda_call = k.mademog_log_prob_cuda

    def spy(*args, **kwargs):
        calls.append(kwargs.get("gemm"))
        return cuda_call(*args, **kwargs)

    def no_image(*args, **kwargs):
        raise AssertionError("the trainer packed the wgmma image")

    monkeypatch.setattr(k, "mademog_log_prob_cuda", spy)
    monkeypatch.setattr(k, "pack_weights_wgmma", no_image)
    tr = fused_trainer(_model("one_pass", 64, context), 128)
    step = tr.make_train_step(tr.init_opt(lambda p: torch.optim.Adam(p, lr=1e-3)))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(128, 4, generator=g)
    c = None if context is None else torch.randn(128, context, generator=g)
    loss = step(x) if c is None else step(x, c)
    assert torch.isfinite(torch.as_tensor(loss)).all()
    assert calls and all(gm == "simt" for gm in calls), calls


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
    against float64, |a - f64| / (1 + |f64|); their median, 90th and 99th
    percentiles and maximum."""
    e = (t.double() - exact).abs() / (1.0 + exact.abs())
    q = torch.quantile(e, torch.tensor([0.5, 0.9, 0.99], dtype=e.dtype))
    return [*q.tolist(), float(e.max())]


@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_one_pass_limits_take_3xtf32_and_refuse_one_tf32_product(shape, context, monkeypatch):
    """The card's relative hold on B11 in fp32 tells 3xTF32 from a lower
    precision: 3xTF32 emulated through the MADE lies within ONE_PASS_LIMITS
    of the fp32 plain version's quantiles and within 1e-3 of it, one TF32
    product a product outside the limits at every quantile (the distances
    from the plain version printed beside)."""
    fused = k.fuse_mademog(_model(shape, 64, context, seed=3))
    w, st = fused._weights, fused._static
    g = torch.Generator().manual_seed(4)
    x = 1.5 * torch.randn(512, st["D"], generator=g)
    c = None if context is None else torch.randn(512, context, generator=g)
    with torch.no_grad():
        plain = k.mademog_log_prob_plain(x, w, st, c)
        exact = k.mademog_log_prob_plain(x.double(), {key: v.double() for key, v in w.items()},
                                         st, None if c is None else c.double())
        got = {}
        for name, fn in (("3xtf32", gemm_3xtf32), ("tf32", gemm_tf32)):
            monkeypatch.setattr(k, "gemm", fn)
            got[name] = k.mademog_log_prob_cuda(x, w, st, c, gemm="wgmma")
    p = _quantiles(plain, exact)
    q3, q1 = _quantiles(got["3xtf32"], exact), _quantiles(got["tf32"], exact)
    gap = float((got["3xtf32"] - plain).abs().max())
    print(f"{shape} context={context}: plain {p}, 3xTF32 {q3}, one TF32 {q1}; 3xTF32 - plain "
          f"{gap:.3e}, one TF32 - plain {float((got['tf32'] - plain).abs().max()):.3e}")
    assert torch.isfinite(got["3xtf32"]).all()
    assert gap <= 1e-3 or float((got["3xtf32"].double() - exact).abs().max()) <= 2.0 * float(
        (plain.double() - exact).abs().max())
    assert all(a <= f * b for a, b, f in zip(q3, p, ONE_PASS_LIMITS))
    assert all(a > f * b for a, b, f in zip(q1, p, ONE_PASS_LIMITS))


def _jax_params(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_3xtf32_holds_the_jax_kernel(shape, context, monkeypatch):
    """3xTF32 through the port's MADE against the JAX package's B11 (the
    Pallas kernel in interpret mode) on the same weights and inputs:
    within 1e-4 on lp, as the fp32 plain version is."""
    D, K = SHAPES[shape]
    kw = dict(features=D, hidden_features=64, context_features=context, num_blocks=2,
              num_mixture_components=K)
    jm = JaxMoG(key=jax.random.key(5), rng=np.random.default_rng(5), **kw)
    # the blocks' second linears at the first's scale (as initialised they
    # are near zero and every block is near the identity)
    jm = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 1e3 / 8.0 if "linear_1.weight" in jax.tree_util.keystr(path) else v,
        jm)
    tm = MixtureOfGaussiansMADE(rng=np.random.default_rng(5), device="cpu", **kw)
    load_jax_params(tm, _jax_params(jm))
    rng = np.random.default_rng(6)
    x = (1.5 * rng.standard_normal((128, D))).astype(np.float32)
    c = None if context is None else rng.standard_normal((128, context)).astype(np.float32)
    jw, jstatic, _ = jax_fused._extract(jm, jnp.float32)
    want = np.asarray(jax_fused.mademog_log_prob_call(
        jnp.asarray(x.T), jw, jstatic, lanes=128, interpret=True,
        ctx_t=None if c is None else jnp.asarray(c.T)))[0]
    fused = k.fuse_mademog(tm.eval())
    tc = None if c is None else torch.from_numpy(c)
    with torch.no_grad():
        plain = k.mademog_log_prob_plain(torch.from_numpy(x), fused._weights, fused._static, tc)
        monkeypatch.setattr(k, "gemm", gemm_3xtf32)
        got = k.mademog_log_prob_cuda(torch.from_numpy(x), fused._weights, fused._static, tc,
                                      gemm="wgmma")
    e_jax = float(np.abs(got.double().numpy() - want.astype(np.float64)).max())
    e_plain = float(np.abs(plain.double().numpy() - want.astype(np.float64)).max())
    print(f"{shape} context={context}: 3xTF32 - JAX {e_jax:.3e}, fp32 plain - JAX {e_plain:.3e}")
    assert np.isfinite(got.numpy()).all()
    assert e_jax <= 1e-4 and e_plain <= 1e-4
