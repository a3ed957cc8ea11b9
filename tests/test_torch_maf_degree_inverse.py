"""B9's fixed point in degree order on the CPU: the plain version of the
degree schedule (``maf_flow_kernel_plain(..., schedule="degrees")``), the
degree layout the kernel streams (``pack_degree_order``), the degree-form
check and the route ``maf_flow_kernel_cuda`` takes by shape. The kernel
itself (csrc/maf_degree_inverse.cuh) runs on the card only: the
``cuda``-marked cases of tests/test_torch_cuda.py and chip_smoke.py hold it
against both plain versions.

Tolerances. In float64 the two schedules are one function summed in
another order: 1e-10. In fp32 the degree schedule against the JAX package
after ``load_jax_params``: the 1e-4 interop bar plus 1e-5 of the value (the
fixed point divides by scales below 1 feature after feature, so a few
samples reach the hundreds, as in tests/test_torch_maf_fused.py). With bf16
weights the degree plain against the fixed-point plain, both bf16: the
bands of tests/test_torch_bf16_serving.py, 5e-4 on outputs and 1e-3 on the
logabsdet (an fp32 sum taken in another order can flip an operand's bf16
rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nflows_tpu.flows import MaskedAutoregressiveFlow as JaxMAF
from nflows_tpu.models import NeuralSplineFlowAR as JaxNSFAR
from nflows_tpu.ops.pallas import maf_fused as jax_fused
from nflows_tpu_torch import (
    Flow,
    MaskedAutoregressiveFlow,
    NeuralSplineFlowAR,
    load_jax_params,
)
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.ops.cuda import maf_flow_kernel, maf_fused
from nflows_tpu_torch.transforms import (
    CompositeTransform,
    InverseTransform,
    MaskedAffineAutoregressiveTransform,
    RandomPermutation,
)

torch.set_num_threads(1)

D, C = 5, 3
KINDS = ("affine", "rq", "iaf")


def _chain(kind, context=None, hidden=22, features=D, layers=2, seed=0):
    """``layers`` x [random permutation, 2-block residual MADE]: affine
    (MAF), RQ (NSF-AR, 4 bins) or wrapped affine (IAF), with or without a
    context."""
    gen, rng = torch.Generator().manual_seed(seed), np.random.default_rng(seed)
    if kind == "rq":
        return NeuralSplineFlowAR(features, hidden, num_layers=layers, num_blocks_per_layer=2,
                                  num_bins=4, tail_bound=3.0, context_features=context,
                                  generator=gen, rng=rng, device="cpu").eval()
    chain = []
    for _ in range(layers):
        layer = MaskedAffineAutoregressiveTransform(features, hidden, context_features=context,
                                                    num_blocks=2, generator=gen, device="cpu")
        chain += [RandomPermutation(features, rng=rng, device="cpu"),
                  InverseTransform(layer) if kind == "iaf" else layer]
    return Flow(CompositeTransform(chain), StandardNormal([features])).eval()


def _extract(flow, monkeypatch=None, dtype=torch.float32):
    """The stacks and masks; hidden 22 is below the kernels' alignment, so
    the width check is lifted where the plain versions alone run."""
    if monkeypatch is not None:
        monkeypatch.setattr(maf_flow_kernel, "_out_align", lambda dtype=torch.float32: 1)
    static, w, nb, _, tr, skw, _, masks = maf_fused._extract(flow, dtype, return_masks=True)
    return static, w, nb, tr, skw, masks


def _rows(seed, n, width, scale=1.0):
    return torch.from_numpy(
        (scale * np.random.default_rng(seed).standard_normal((n, width))).astype(np.float32))


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


@pytest.mark.parametrize("context", [None, C])
@pytest.mark.parametrize("kind", KINDS)
def test_the_schedules_agree_in_float64(monkeypatch, kind, context):
    """Features 5, hidden 22: degree groups of 6, 6, 5 and 5 units. The
    MAF's and NSF-AR's inverse, the IAF's forward."""
    static, w, nb, tr, skw, masks = _extract(_chain(kind, context), monkeypatch)
    order = maf_flow_kernel.degree_order(w, static, nb, masks)
    assert [o for _, o in order] == [[0, 0, 6, 12, 17, 22]] * 2
    w64 = {k: v.double() for k, v in w.items()}
    x = _rows(1, 41, D, 1.5).double()
    kw = dict(inverse=kind != "iaf", num_blocks=nb, transformer=tr, spline_kw=skw,
              context=None if context is None else _rows(2, 41, context).double())
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(x, w64, static, **kw)
    dy, dlad = maf_flow_kernel.maf_flow_kernel_plain(x, w64, static, schedule="degrees",
                                                     masks=masks, **kw)
    assert dy.dtype == torch.float64 and float(y.abs().max()) > 1.0
    _close(dy, y, 1e-10)
    _close(dlad, lad, 1e-10)
    # without masks the weights' nonzero entries give the same order
    ny, _ = maf_flow_kernel.maf_flow_kernel_plain(x, w64, static, schedule="degrees", **kw)
    assert torch.equal(ny, dy)


def test_the_degree_plain_is_differentiable(monkeypatch):
    static, w, nb, tr, skw, masks = _extract(_chain("affine"), monkeypatch)
    w64 = {k: v.double().requires_grad_() for k, v in w.items()}
    x = _rows(3, 9, D).double().requires_grad_()
    kw = dict(inverse=True, num_blocks=nb, transformer=tr, spline_kw=skw, masks=masks)
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(x, w64, static, schedule="degrees", **kw)
    (y.sum() + lad.sum()).backward()
    gx = x.grad.clone()
    x.grad = None
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(x, w64, static, **kw)
    (y.sum() + lad.sum()).backward()
    _close(gx, x.grad, 1e-9)


def _pair(kind, seed=0):
    kw = dict(features=D, hidden_features=32, num_layers=3, num_blocks_per_layer=2)
    if kind == "nsf_ar":
        kw.update(num_bins=4, tail_bound=3.0)
        jflow = JaxNSFAR(key=jax.random.key(seed), rng=np.random.default_rng(seed), **kw)
        tflow = NeuralSplineFlowAR(device="cpu", rng=np.random.default_rng(seed + 100), **kw)
    else:
        jflow = JaxMAF(key=jax.random.key(seed), rng=np.random.default_rng(seed),
                       use_random_permutations=True, **kw)
        tflow = MaskedAutoregressiveFlow(device="cpu", rng=np.random.default_rng(seed + 100),
                                         use_random_permutations=True, **kw)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jflow)
    load_jax_params(tflow, {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    return jflow, tflow.eval()


@pytest.mark.parametrize("kind", ["maf", "nsf_ar"])
def test_the_degree_plain_matches_jax_in_fp32(kind):
    """Against the JAX flow's ``transform.inverse`` and the JAX B9 kernel in
    interpret mode, on the same numpy noise."""
    jflow, tflow = _pair(kind, seed=4)
    static, w, nb, _, tr, skw, _, masks = maf_fused._extract(tflow, torch.float32,
                                                             return_masks=True)
    z = _rows(5, 100, D, 1.0)
    with torch.no_grad():
        y, lad = maf_flow_kernel.maf_flow_kernel_plain(
            z, w, static, inverse=True, num_blocks=nb, transformer=tr, spline_kw=skw,
            schedule="degrees", masks=masks)
    jy, jlad = jflow.transform.inverse(jnp.asarray(z.numpy()))
    _close(y, jy, 1e-4, 1e-5)
    _close(lad, jlad, 1e-4, 1e-5)
    ky, klad = jax_fused.fuse_maf(jflow, dtype=jnp.float32, lanes=128,
                                  interpret=True).inverse(jnp.asarray(z.numpy()))
    _close(y, ky, 1e-4, 1e-5)
    _close(lad, klad, 1e-4, 1e-5)


@pytest.mark.parametrize("context", [None, C])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_degree_plain_matches_the_bf16_fixed_point(kind, context):
    static, w, nb, tr, skw, masks = _extract(_chain(kind, context, hidden=32),
                                             dtype=torch.bfloat16)
    assert w["wb"].dtype == torch.bfloat16
    x = _rows(6, 64, D, 1.5)
    kw = dict(inverse=kind != "iaf", num_blocks=nb, transformer=tr, spline_kw=skw,
              context=None if context is None else _rows(7, 64, context))
    with torch.no_grad():
        y, lad = maf_flow_kernel.maf_flow_kernel_plain(x, w, static, **kw)
        dy, dlad = maf_flow_kernel.maf_flow_kernel_plain(x, w, static, schedule="degrees",
                                                         masks=masks, **kw)
        fy, _ = maf_flow_kernel.maf_flow_kernel_plain(
            x, {k: v.float() for k, v in w.items()}, static, **kw)
    _close(dy, y, 5e-4)
    _close(dlad, lad, 1e-3)
    # the bf16 rounding is there: the fp32 chain is further away
    assert float((dy - fy).abs().mean()) > float((dy - y).abs().mean())


def _unpack(dp, w, static, nb, masks):
    """The stacks again, from the degree layout's slabs: every slab written
    back to its place in unit-sorted matrices (L, [out, in]); checks that
    each slab's pad columns are zero."""
    L, H = len(static), dp["bi"].shape[1]
    P = w["wf"].shape[0] // L
    M, Cw = P // D, (w["wci"].shape[1] if "wci" in w else 0)
    order = maf_flow_kernel.degree_order(w, static, nb, masks)
    sw = dict(wi=torch.zeros(L, H, D, dtype=torch.float64),
              wb=torch.zeros(L, 2 * nb, H, H, dtype=torch.float64),
              wf=torch.zeros(L, P, H, dtype=torch.float64))
    if Cw:
        sw.update(wci=torch.zeros(L, H, Cw, dtype=torch.float64),
                  wcb=torch.zeros(L, nb, H, Cw, dtype=torch.float64))
    stream, at = dp["stream"].double(), 0
    layers = range(L) if static[0].wrapped else range(L - 1, -1, -1)
    for l in layers:
        for what, j, k, u0, live, depth, width in maf_flow_kernel._degree_slabs(
                D, M, Cw, nb, order[l][1], 4):
            slab = stream[at:at + depth * width].view(depth, width)
            at += depth * width
            assert not slab[:, live:].any()
            block = slab[:, :live].T
            if what == "f":
                sw["wf"][l, [(u0 + c) * D + k for c in range(live)], :depth] = block
            elif what == "i":
                sw["wi"][l, u0:u0 + live, :depth] = block
            elif what == "ci":
                sw["wci"][l, u0:u0 + live] = block
            elif what == "cb":
                sw["wcb"][l, j, u0:u0 + live] = block
            else:
                sw["wb"][l, 2 * j + (what == "b1"), u0:u0 + live, :depth] = block
    assert at == stream.numel()
    return sw


@pytest.mark.parametrize("context", [None, C])
@pytest.mark.parametrize("kind", KINDS)
def test_the_degree_layout_preserves_the_function(kind, context):
    """The fixed-point plain on the unit-sorted stacks that the slabs hold
    (pad columns exactly zero) equals it on the model's own stacks, in
    float64; every chunk is whole rows of one slab, at most one ring slot."""
    static, w, nb, tr, skw, masks = _extract(_chain(kind, context, hidden=24))
    dp = maf_flow_kernel.pack_degree_order(w, static, nb, masks)
    assert dp["stream"].dtype == torch.float32
    sw = _unpack(dp, w, static, nb, masks)
    L, H = len(static), 24
    chunks = dp["chunks"].tolist()
    assert chunks[0][0] == 0 and all(a + n == b for (a, n), (b, _) in zip(chunks, chunks[1:]))
    assert all(0 < n * 4 <= maf_flow_kernel.DEGREE_SLOT_BYTES and n % 4 == 0 for _, n in chunks)
    assert chunks[-1][0] + chunks[-1][1] == dp["stream"].numel()
    sorted_w = {"wi": sw["wi"].view(L * H, D), "wb": sw["wb"].view(-1, H),
                "wf": sw["wf"].view(-1, H), "bi": dp["bi"].double().view(-1, 1),
                "bb": dp["bb"].double().view(-1, 1), "bf": dp["bf"].double().view(-1, 1)}
    if context:
        sorted_w.update(wci=sw["wci"].view(L * H, -1), wcb=sw["wcb"].view(-1, context),
                        bci=dp["bci"].double().view(-1, 1), bcb=dp["bcb"].double().view(-1, 1))
    x = _rows(8, 30, D, 1.5).double()
    kw = dict(inverse=kind != "iaf", num_blocks=nb, transformer=tr, spline_kw=skw,
              context=None if context is None else _rows(9, 30, context).double())
    y, lad = maf_flow_kernel.maf_flow_kernel_plain(x, sorted_w, static, **kw)
    ry, rlad = maf_flow_kernel.maf_flow_kernel_plain(
        x, {k: v.double() for k, v in w.items()}, static, **kw)
    _close(y, ry, 1e-10)
    _close(lad, rlad, 1e-10)


def test_bf16_layout_keeps_bf16_slabs_and_8_wide_rows():
    static, w, nb, _, _, masks = _extract(_chain("rq", hidden=32), dtype=torch.bfloat16)
    dp = maf_flow_kernel.pack_degree_order(w, static, nb, masks)
    assert dp["stream"].dtype == torch.bfloat16 and dp["bi"].dtype == torch.float32
    assert all(n % 8 == 0 and n * 2 <= maf_flow_kernel.DEGREE_SLOT_BYTES
               for _, n in dp["chunks"].tolist())


EDITS = {
    # a hidden unit that reads a unit of a higher degree
    "hidden": ("wb", lambda m, H: (0, H - 1)),
    # feature 1's parameters reading a hidden unit
    "output": ("wf", lambda m, H: (0, 0)),
    # an initial-layer row that is not a prefix of the inputs
    "initial": ("wi", lambda m, H: (0, D - 1)),
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_a_mask_out_of_degree_form_raises(edit):
    flow = _chain("affine", hidden=24)
    static, w, nb, tr, skw, masks = _extract(flow)
    name, where = EDITS[edit]
    m = masks[name].clone()
    H = 24
    if name == "wb":   # the first hidden unit (degree 1) reading the last (degree 4)
        m[0, H - 1] = 1.0
    elif name == "wf":
        m[0, 0] = 1.0
    else:
        m[0, D - 1], m[0, 0] = 1.0, 0.0
    bad = {**masks, name: m}
    assert maf_flow_kernel.degree_order(w, static, nb, bad) is None
    with pytest.raises(ValueError, match="degree form"):
        maf_flow_kernel.pack_degree_order(w, static, nb, bad)
    kw = dict(inverse=True, num_blocks=nb, transformer=tr, spline_kw=skw)
    x = _rows(10, 8, D)
    with pytest.raises(ValueError, match="degree form"):
        maf_flow_kernel.maf_flow_kernel_plain(x, w, static, schedule="degrees", masks=bad, **kw)
    # the wrapper reads the degree form from the weights' nonzero entries:
    # weights whose nonzero entries follow the edited mask
    w_bad = {**w, name: w[name] * m + (m - masks[name]).clamp(min=0) * 0.5}
    assert maf_flow_kernel.degree_order(w_bad, static, nb) is None
    with pytest.raises(ValueError, match="degree form"):
        maf_flow_kernel.maf_flow_kernel_cuda(x, w_bad, static, schedule="degrees", **kw)
    # routed by shape: such a model takes the fixed-point schedule
    assert maf_flow_kernel._route(w_bad, static, True, nb, None, None, None) == (
        "fixed_point", None)


def test_the_route_follows_the_shape():
    flow = _chain("affine", hidden=24)
    static, w, nb, tr, skw, masks = _extract(flow)
    route = lambda inverse, **kw: maf_flow_kernel._route(  # noqa: E731
        w, static, inverse, nb, kw.get("schedule"), kw.get("rows"), kw.get("packed"))[0]
    assert route(True) == "degrees"          # every layer a fixed point
    assert route(False) == "fixed_point"     # one pass a layer
    assert route(True, rows=64) == "fixed_point"
    assert route(True, rows=16) == route(True, rows=32) == "degrees"
    assert route(True, schedule="fixed_point") == "fixed_point"
    assert route(True, packed={"degrees": None}) == "fixed_point"
    with pytest.raises(ValueError, match="one pass"):
        route(False, schedule="degrees")
    with pytest.raises(ValueError, match="schedule must be"):
        route(True, schedule="dense")
    mixed = (static[0], static[1]._replace(wrapped=True))
    assert maf_flow_kernel._route(w, mixed, True, nb, None, None, None)[0] == (
        "fixed_point")
    with pytest.raises(ValueError, match="all wrapped or all unwrapped"):
        maf_flow_kernel.pack_degree_order(w, mixed, nb, masks)


def test_the_tile_rule():
    """16-sample tiles where each then has an SM of its own, 32 beyond; 16
    where 32 no longer fit; the stage buffers of hidden 1,024 fit
    neither."""
    rows = maf_flow_kernel.degree_tile_rows
    assert rows(2048, 10, 256, 2, 2, sms=132) == 16
    assert rows(2112, 10, 256, 23, 2, sms=132, C=10) == 16
    assert rows(2113, 10, 256, 23, 2, sms=132, C=10) == 32
    assert rows(4096, 10, 256, 2, 2, sms=132) == 32
    assert rows(65536, 10, 512, 2, 2, sms=132) == 16     # 32 rows no longer fit
    assert rows(4096, 10, 1024, 2, 2, sms=132) == 0
    smem = maf_flow_kernel.degree_shared_memory_bytes
    assert smem(32, 10, 256, 23, 2, 10) <= maf_flow_kernel.MAX_SHARED_MEMORY
    assert 2 * (smem(16, 10, 256, 23, 2, 10) + 1024) <= 233472     # two blocks an SM
    assert smem(32, 10, 512, 2, 2) > maf_flow_kernel.MAX_SHARED_MEMORY


def test_the_shared_memory_count_is_the_sources():
    """``degree_shared_memory_bytes`` against ``degree_smem_bytes`` of
    csrc/maf_degree_inverse.cuh, evaluated in Python."""
    import re
    from pathlib import Path

    src = (Path(maf_flow_kernel.__file__).resolve().parents[2] / "csrc"
           / "maf_degree_inverse.cuh").read_text()
    body = re.search(r"size_t degree_smem_bytes\(int rows, const Args<WT>& a\) \{(.*?)\n\}",
                     src, re.S).group(1)
    big, small = map(int, re.search(r"ROWS == 32 \? (\d+) : (\d+)", src).groups())
    expr = " ".join(re.search(r"return (.*?);", body, re.S).group(1).split())
    expr = re.sub(r"\(size_t\)|sizeof\(float\)", lambda m: "4" if "sizeof" in m.group() else "",
                  expr).replace("kSlotBytes", "8192").replace("a.", "")
    for rows, H, M, nb, Cw in ((16, 256, 2, 2, 0), (32, 256, 23, 2, 10), (32, 64, 11, 1, 3)):
        n_slots = big if rows == 32 else small
        got = eval(expr, {}, dict(slots=n_slots, rows=rows, nb=nb, H=H, D=10, M=M, C=Cw))
        assert got == maf_flow_kernel.degree_shared_memory_bytes(rows, 10, H, M, nb, Cw)
    assert maf_flow_kernel.DEGREE_RING_SLOTS == {16: small, 32: big}


def test_the_fused_view_keeps_its_masks_and_serves_both_schedules_on_cpu():
    """On the CPU the view keeps no kernel layout; the wrapper runs the
    fixed-point plain unless the degree schedule is asked for, and both
    match the unfused transform."""
    flow = _chain("rq", hidden=24)
    view = maf_fused.fuse_maf(flow)
    assert view._packed is None and set(view._masks) == {"wi", "wb", "wf"}
    z = _rows(11, 20, D)
    kw = dict(inverse=True, num_blocks=view._num_blocks, transformer=view._transformer,
              spline_kw=view._spline_kw)
    before = (maf_flow_kernel.launch_count, maf_flow_kernel.degree_launch_count)
    with torch.no_grad():
        ry, rlad = flow.transform.inverse(z)
        y, lad = view.inverse(z)
        dy, dlad = maf_flow_kernel.maf_flow_kernel_cuda(z, view._weights, view._static,
                                                        schedule="degrees", **kw)
    assert torch.equal(y, maf_flow_kernel.maf_flow_kernel_plain(
        z, view._weights, view._static, **kw)[0])
    for got, want in ((y, ry), (lad, rlad), (dy, ry), (dlad, rlad)):
        _close(got, want, 1e-4)
    assert (maf_flow_kernel.launch_count, maf_flow_kernel.degree_launch_count) == before
