"""B2's wgmma route on the CPU: the packed weight image, the route by
shape, and a prediction of 3xTF32's numerics.

- ``pack_weights_wgmma``'s image, decoded through ``wgmma_positions`` (the
  layout function the packer scatters through), gives back every extracted
  matrix bit for bit, fp32 and bf16, with and without a context, at the
  flagship's widths and at a narrow one; every pad row and column is zero;
  the biases and index lists are the extracted ones.
- ``gemm_route`` sends each shape where the kernel can take it, and a
  forced route is kept or refused.
- 3xTF32 emulated with bit operations (``cvt.rna.tf32.f32``: round to
  nearest, ties away from zero, to 10 mantissa bits), its three products
  run through ``nsf_flow_kernel_plain``'s chain in place of ``gemm``: held
  in the fp32 bands of ``chip_smoke.py`` (1e-3 against the fp32 plain
  chain, or within twice the fp32 plain chain's distance from float64),
  for rq and affine, forward and inverse. Single TF32's error is printed
  beside it, the price that 3xTF32 avoids.

JAX is not needed: these are the port's own layouts and its plain chain.
"""

import numpy as np
import pytest
import torch

from nflows_tpu_torch import Flow, NeuralSplineFlow, SimpleRealNVP
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel as k
from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf
from nflows_tpu_torch.transforms import CompositeTransform, PiecewiseQuadraticCouplingTransform
from nflows_tpu_torch.utils.masks import create_alternating_binary_mask

torch.set_num_threads(1)

FLAGSHIP = dict(features=6, hidden_features=256, num_layers=10, num_blocks_per_layer=2,
                num_bins=8, tail_bound=3.0)
NARROW = dict(features=5, hidden_features=64, num_layers=3, num_blocks_per_layer=1,
              num_bins=4, tail_bound=3.0)


def _nsf(widths, context=None, seed=0):
    return NeuralSplineFlow(generator=torch.Generator().manual_seed(seed),
                            rng=np.random.default_rng(seed), device="cpu",
                            context_features=context, **widths).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("context", [None, 10])
@pytest.mark.parametrize("widths", [FLAGSHIP, NARROW], ids=["flagship", "narrow"])
def test_image_decodes_to_every_matrix_bit_for_bit(widths, context, dtype):
    fused = fuse_nsf(_nsf(widths, context), dtype=dtype)
    w, indices = fused._weights, fused._indices
    wp = k.pack_weights_wgmma(w, indices)
    L, H, Tid = w["w0"].shape
    TM = w["wf"].shape[1]
    C = context or 0
    nb = w["wb"].shape[1] // 2
    dims = k.wgmma_dims(Tid, TM, C)
    assert {key: wp[key] for key in dims} == dims
    assert dims["Ip"] == 16 and dims["TMp"] % 64 == 0 and dims["TMp"] >= TM
    assert dims["Cp"] == (16 if context else 0)
    image = wp["image"]
    assert image.dtype == dtype and image.ndim == 1 and image.is_contiguous()
    layer = image.reshape(L, -1)
    assert wp["layer_bytes"] == layer.shape[1] * image.element_size()

    real = dict(w0=w["w0"], wb=w["wb"], wf=w["wf"], wc0=w.get("wc0"), wcb=w.get("wcb"))
    start = 0
    for name, j in k.wgmma_gemms(nb, bool(context)):
        m = real[name] if j is None else real[name][:, j]
        O = dims["TMp"] if name == "wf" else H
        K = {"w0": dims["Ip"], "wc0": dims["Cp"], "wcb": dims["Cp"]}.get(name, H)
        pos = k.wgmma_positions(O, K, dtype)
        got = layer[:, start:start + O * K][:, pos]        # [L, O, K]
        start += O * K
        o, kk = m.shape[1], m.shape[2]
        assert torch.equal(got[:, :o, :kk], m), name
        assert not got[:, o:].any() and not got[:, :, kk:].any(), f"{name}: pads not zero"
    assert start == layer.shape[1]

    assert torch.equal(wp["b0"], w["b0"][..., 0])
    assert torch.equal(wp["bb"], w["bb"][..., 0])
    assert torch.equal(wp["bf"][:, :TM], w["bf"][..., 0]) and not wp["bf"][:, TM:].any()
    assert torch.equal(wp["idx"], k.pack_weights(w, indices)["idx"])
    if context:
        assert torch.equal(wp["bcb"], w["bcb"][..., 0])
    else:
        assert "bcb" not in wp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("O,K", [(64, 16), (128, 256), (192, 256), (256, 256), (256, 16)])
def test_positions_are_a_layout_of_ring_slot_chunks(O, K, dtype):
    """Every element has its own place; each chunk is a contiguous run of
    whole wgmma steps over all slabs and fits a ring slot; within a step a
    slab's 64 x 32-byte tile is eight 128-byte core matrices per 16-byte
    column, rows 16 bytes apart (LBO 1024, SBO 128)."""
    es = torch.empty((), dtype=dtype).element_size()
    pos = k.wgmma_positions(O, K, dtype)
    assert pos.shape == (O, K)
    assert torch.equal(pos.flatten().sort().values, torch.arange(O * K))
    V, ns = 16 // es, O // 64
    step = 2 * V
    nk = K // step
    kc = k._chunk_steps(nk, ns)
    assert ns * kc * 2048 <= k._WG_SLOT and kc <= 8 and (kc & (kc - 1)) == 0
    if dtype == torch.float32:
        assert nk % kc == 0 and kc % 2 == 0   # the fp32 kernel's chunks of 2, 4 or 8 steps
    for c in range(-(-nk // kc)):
        cols = slice(c * kc * step, min(nk, (c + 1) * kc) * step)
        run = pos[:, cols].flatten()
        assert int(run.max()) - int(run.min()) + 1 == run.numel()
    # a core matrix: 8 rows 16 bytes apart, 16 contiguous bytes each
    assert int(pos[1, 0] - pos[0, 0]) * es == 16
    assert int(pos[0, V - 1] - pos[0, 0]) == V - 1
    assert int(pos[8, 0] - pos[0, 0]) * es == 128                  # SBO
    if K >= step:
        assert int(pos[0, V] - pos[0, 0]) * es == 1024             # LBO


def _quadratic_chain(hidden):
    """The narrow quadratic chain phase 20 of chip_smoke.py serves: width 16."""
    gen = torch.Generator().manual_seed(3)
    chain = []
    for i in range(3):
        chain.append(PiecewiseQuadraticCouplingTransform(
            mask=create_alternating_binary_mask(6, even=bool(i % 2)),
            transform_net_create_fn=lambda n_in, n_out: nets.ResidualNet(
                n_in, n_out, hidden_features=hidden, num_blocks=1, generator=gen,
                device="cpu"),
            num_bins=4, tails="linear", tail_bound=3.0, device="cpu"))
    return Flow(CompositeTransform(chain), StandardNormal([6])).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_shape(dtype):
    # the flagship, its conditional twin, RealNVP and the other families
    assert k.gemm_route(256, 6, 3, 3, 69, 0, dtype) == "wgmma"
    assert k.gemm_route(256, 6, 3, 3, 69, 10, dtype) == "wgmma"
    assert k.gemm_route(256, 6, 3, 3, 6, 0, dtype) == "wgmma"
    assert k.gemm_route(256, 6, 3, 3, 93, 0, dtype) == "wgmma"
    assert k.gemm_route(64, 5, 2, 3, 33, 0, dtype) == "wgmma"
    # widths the tensor-core tile does not take go to the SIMT kernel
    assert k.gemm_route(16, 6, 3, 3, 21, 0, dtype) == "simt"
    assert k.gemm_route(96, 6, 3, 3, 69, 0, dtype) == "simt"
    assert k.gemm_route(320, 6, 3, 3, 69, 0, dtype) == "simt"
    assert k.gemm_route(256, 20, 10, 10, 290, 0, dtype) == "simt"
    # the fp32 affine couplings keep the SIMT route unless forced
    affine = "simt" if dtype == torch.float32 else "wgmma"
    assert k.gemm_route(256, 6, 3, 3, 6, 0, dtype, spline="affine") == affine
    assert k.gemm_route(256, 6, 3, 3, 6, 0, dtype, gemm="wgmma", spline="affine") == "wgmma"
    assert k.gemm_route(256, 6, 3, 3, 3, 0, dtype, spline="additive") == "wgmma"
    assert k.gemm_route(256, 6, 3, 3, 69, 0, dtype, spline="rq") == "wgmma"
    # forced
    assert k.gemm_route(256, 6, 3, 3, 69, 0, dtype, gemm="simt") == "simt"
    assert k.gemm_route(256, 6, 3, 3, 69, 0, dtype, gemm="wgmma") == "wgmma"
    with pytest.raises(ValueError, match="wgmma"):
        k.gemm_route(16, 6, 3, 3, 21, 0, dtype, gemm="wgmma")
    with pytest.raises(ValueError, match="gemm must be"):
        k.gemm_route(256, 6, 3, 3, 69, 0, dtype, gemm="tf32")


def test_shared_memory_of_the_flagship_tile():
    """The wgmma tile's shared memory at the flagship's widths: the ring (4
    slots of 32 KB), the operand buffer (fp32: hi and lo planes), the
    context operand, the barriers and the state; within the 227 KB a block
    may use, up to 256 parameter rows."""
    floats = 4 * 32 * (2 * 6 + 2 * 3 + 1)
    assert k.wgmma_shared_memory_bytes(6, 256, 3, 3, 69, 0, torch.float32) == (
        4 * 32768 + 2 * 32 * 256 * 4 + 64 + floats)
    assert k.wgmma_shared_memory_bytes(6, 256, 3, 3, 69, 10, torch.float32) == (
        4 * 32768 + 2 * 32 * 256 * 4 + 2 * 32 * 16 * 4 + 64 + floats)
    # bf16: P [32][128 + 4] fp32 outgrows the [32][256] bf16 operand it overlays
    assert k.wgmma_shared_memory_bytes(6, 256, 3, 3, 69, 10, torch.bfloat16) == (
        4 * 32768 + 32 * 132 * 4 + 32 * 16 * 2 + 64 + floats)
    for dtype in (torch.float32, torch.bfloat16):
        assert k.wgmma_shared_memory_bytes(6, 256, 3, 3, 256, 10, dtype) <= k.MAX_SHARED_MEMORY


def test_wrapper_routes_and_refuses_a_forced_route_on_the_cpu():
    """The wrapper checks ``gemm=`` whatever the device; a CPU tensor then
    runs the plain version on either route."""
    narrow = fuse_nsf(_quadratic_chain(16))
    x = torch.randn(7, 6, generator=torch.Generator().manual_seed(0))
    kw = dict(inverse=False, **narrow._static)
    with pytest.raises(ValueError, match="wgmma"):
        k.nsf_flow_kernel_cuda(x, narrow._weights, narrow._indices, gemm="wgmma", **kw)
    y, lad = k.nsf_flow_kernel_cuda(x, narrow._weights, narrow._indices, gemm="simt", **kw)
    p_y, p_lad = k.nsf_flow_kernel_plain(x, narrow._weights, narrow._indices, **kw)
    assert torch.equal(y, p_y) and torch.equal(lad, p_lad)
    assert k.weights_route(narrow._weights, narrow._indices) == "simt"
    fused = fuse_nsf(_nsf(NARROW))
    assert k.weights_route(fused._weights, fused._indices) == "wgmma"
    xf = torch.randn(7, 5, generator=torch.Generator().manual_seed(1))
    kw = dict(inverse=True, **fused._static)
    y, _ = k.nsf_flow_kernel_cuda(xf, fused._weights, fused._indices, gemm="wgmma", **kw)
    assert torch.equal(y, k.nsf_flow_kernel_plain(xf, fused._weights, fused._indices, **kw)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_wgmma_on_the_cpu_is_its_plain_version(dtype):
    g = torch.Generator().manual_seed(2)
    a, w = torch.randn(9, 20, generator=g), torch.randn(70, 20, generator=g).to(dtype)
    assert torch.equal(k.gemm_wgmma(a, w), k.gemm(a, w))


# -- 3xTF32 ------------------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on fp32 values: round the magnitude to 10 mantissa
    bits, ties away from zero (add half of the dropped 13 bits' unit to the
    bit pattern, then clear them; a carry moves into the exponent)."""
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


def gemm_1xtf32(a, w):
    """A single TF32 product, which North-star fact (c) rules out."""
    return tf32_rna(a) @ tf32_rna(w).T


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.14159265], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0,
                         3.140625], dtype=torch.float32)
    assert torch.equal(got, want)
    hi, lo = _split(x)
    # hi + lo carries 21 bits of the 24: within 2^-21 relative
    assert float(((hi.double() + lo.double()) - x.double()).abs().max()) <= 2.0 ** -20


def _realnvp():
    flow = SimpleRealNVP(features=6, hidden_features=256, num_layers=10, num_blocks_per_layer=2,
                         generator=torch.Generator().manual_seed(4), device="cpu")
    with torch.no_grad():
        for t in flow.transform.transforms:
            t.transform_net.final_layer.weight.mul_(0.1)
    return flow.eval()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("family", ["rq", "affine"])
def test_3xtf32_chain_holds_the_fp32_bands(family, inverse, monkeypatch):
    flow = _nsf(FLAGSHIP) if family == "rq" else _realnvp()
    fused = fuse_nsf(flow)
    w, indices = fused._weights, fused._indices
    w64 = {key: v.double() for key, v in w.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 6)).astype(np.float32))
    kw = dict(inverse=inverse, **fused._static)
    p_y, p_lad = k.nsf_flow_kernel_plain(x, w, indices, **kw)
    d_y, d_lad = k.nsf_flow_kernel_plain(x.double(), w64, indices, **kw)
    monkeypatch.setattr(k, "gemm", gemm_3xtf32)
    t_y, t_lad = k.nsf_flow_kernel_plain(x, w, indices, **kw)
    monkeypatch.setattr(k, "gemm", gemm_1xtf32)
    s_y, s_lad = k.nsf_flow_kernel_plain(x, w, indices, **kw)

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    for what, got, plain, exact, single in (("out", t_y, p_y, d_y, s_y),
                                            ("lad", t_lad, p_lad, d_lad, s_lad)):
        e_kp, e_k64, e_p64 = err(got, plain), err(got, exact), err(plain, exact)
        print(f"{family} {'inverse' if inverse else 'forward'} {what}: 3xTF32 - fp32 plain "
              f"{e_kp:.3e}, 3xTF32 - f64 {e_k64:.3e}, fp32 plain - f64 {e_p64:.3e}; "
              f"single TF32 - f64 {err(single, exact):.3e}")
        assert torch.isfinite(got).all()
        assert e_kp <= 1e-3 or e_k64 <= 2.0 * e_p64
        # 3xTF32 keeps fp32's digits: no further from float64 than a few
        # times the fp32 chain, and far closer than one TF32 product
        assert e_k64 <= max(4.0 * e_p64, 1e-5)
        assert e_k64 < err(single, exact)
