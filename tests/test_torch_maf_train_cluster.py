"""The cluster layout of kernel B10 on the CPU: how ``maf_train`` chooses
the cluster size, sizes the stash and the grid, and what it hands the two
launchers (caught by a stand-in library before the kernels, as
tests/test_torch_nsf_train_cluster.py does for B3 and B4); the shared
memory the wrapper counts against the CUDA sources' ``smem_bytes``. The
kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py). On a CPU tensor the wrapper runs its plain version,
whatever cluster it is asked for: that path is held against the JAX
package in tests/test_torch_maf_train.py, test_torch_maf_context.py and
test_torch_iaf_train.py.
"""

import contextlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nflows_tpu_torch import Flow, MaskedAutoregressiveFlow, NeuralSplineFlowAR
from nflows_tpu_torch.distributions import StandardNormal
from nflows_tpu_torch.ops.cuda import _build, _trainer_common, maf_train
from nflows_tpu_torch.transforms import (
    CompositeTransform,
    InverseTransform,
    MaskedAffineAutoregressiveTransform,
    ReversePermutation,
)

torch.set_num_threads(1)

# the clusters an H100 80GB HBM3 holds at once, for B3 and B4 at the
# flagship's widths (chip_smoke.py, PERF.md §6); B10's blocks take as much
# shared memory (one block an SM)
H100_ACTIVE = {2: 66, 4: 30, 8: 15}
SMS = 132
# B10 on chip_smoke.py's full-width MAF and NSF-AR: features 10, hidden 256,
# 5 layers of 2 residual blocks; affine (P = 2 D) or rq with 8 bins
MAF_DIMS = dict(D=10, L=5, H=256, P=20, nb2=4, C=0)
NSF_AR_DIMS = dict(MAF_DIMS, P=230)

# where the stand-in finds the arguments (csrc/maf_train.cuh: the entry
# points' parameter list)
N_AT, DIMS_AT, GRID_AT = 6, slice(7, 16), 43


@pytest.mark.parametrize("dims", [MAF_DIMS, NSF_AR_DIMS, dict(MAF_DIMS, C=10)])
@pytest.mark.parametrize("n,expected", [
    (1, 8), (31, 8), (33, 8), (480, 8), (481, 4), (512, 4), (960, 4), (961, 2),
    (2048, 2), (4096, 1)])
def test_cluster_size_on_the_h100(n, expected, dims):
    """B10's dims on the H100's occupancy: up to 15 tiles of 32 samples on
    clusters of 8, up to 30 on clusters of 4, up to 66 on pairs; at 4,096
    (128 tiles, more than 66 pairs) one block a tile, csrc/maf_train.cu.
    Every size here takes 32-sample tiles."""
    assert maf_train.tile_rows(n, dims, SMS) == 32
    assert _trainer_common.cluster_size(n, 32, SMS, H100_ACTIVE) == expected
    rows, cluster, grid = _layout(n, dims)
    assert (rows, cluster) == (32, expected)
    tiles = -(-n // 32)
    assert grid == (min(tiles, SMS) if expected == 1
                    else expected * min(tiles, H100_ACTIVE[expected]))


def test_the_rule_is_the_one_b3_and_b4_follow():
    from nflows_tpu_torch.ops.cuda import nsf_train

    assert nsf_train.cluster_size is _trainer_common.cluster_size
    assert nsf_train.CLUSTER_SIZES == maf_train.CLUSTER_SIZES == (2, 4, 8)


@pytest.mark.parametrize("C", [0, 10])
@pytest.mark.parametrize("cluster", [1, *maf_train.CLUSTER_SIZES])
def test_shared_memory_counts_match_the_cluster_source(cluster, C):
    """``shared_memory_bytes`` against ``smem_bytes`` of the source the
    cluster size runs, evaluated in Python as
    tests/test_torch_nsf_train_cluster.py does."""
    source = "maf_train.cu" if cluster == 1 else "maf_train_cluster.cu"
    text = (Path(maf_train.__file__).resolve().parents[2] / "csrc" / source).read_text()
    body = re.search(r"size_t smem_bytes\(int rows, const MafTrainArgs& a\) \{\s*return (.*?);"
                     r"\s*\}", text, re.S).group(1)
    expr = re.sub(r"\ba\.(\w+)", r"v['\1']", body.replace("(size_t)", "").replace(
        "sizeof(float)", "4"))
    for d in (MAF_DIMS, NSF_AR_DIMS):
        dims = dict(d, C=C)
        v = dict(dims, TB=256, C4=-(-C // 4) * 4)
        got = maf_train.shared_memory_bytes(32, *(dims[k] for k in ("D", "L", "H", "P", "C")),
                                            cluster=cluster)
        assert got == eval(expr, {"v": v, "rows": 32, "KC": 32, "OC": 256, "CW": 32,
                                  "KCL": 128, "NSTAGE": 2})
        # the cluster kernel fits wherever one block a tile does, one block an SM
        assert got == maf_train.shared_memory_bytes(32, *(dims[k] for k in (
            "D", "L", "H", "P", "C")))
        assert 2 * got > maf_train.MAX_SHARED_MEMORY >= got


def _library(active):
    """A stand-in for both B10 libraries: records each launch's arguments
    and answers the occupancy query from ``active``."""
    lib = types.SimpleNamespace(active=active, launches=[], queries=[])

    def launcher(name):
        def launch(*args):
            lib.launches.append((name, args))
            return 0
        return launch

    def occupancy(context, cluster, smem, found):
        lib.queries.append((context, cluster, smem))
        found._obj.value = lib.active.get(cluster, 0)
        return 0

    lib.maf_train_launch = launcher("maf_train_launch")
    lib.maf_train_cluster_launch = launcher("maf_train_cluster_launch")
    lib.maf_train_cluster_occupancy = occupancy
    maf_train._declare(lib)
    maf_train._declare_cluster(lib)
    return lib


def _patch_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(maf_train, "_ACTIVE_CLUSTERS", {})


@pytest.fixture
def library(monkeypatch):
    lib = _library(dict(H100_ACTIVE))
    monkeypatch.setattr(_build, "load_library", lambda stem, declare: lib)
    _patch_card(monkeypatch)
    return lib


def _layout(n, dims):
    with pytest.MonkeyPatch.context() as mp:
        lib = _library(dict(H100_ACTIVE))
        mp.setattr(_build, "load_library", lambda stem, declare: lib)
        _patch_card(mp)
        return maf_train.launch_layout(n, dims, torch.device("cpu"))


def _flow(kind, context=None):
    """A small autoregressive chain: features 5, hidden 32, 2 layers of 2
    residual blocks; affine (MAF), rq (NSF-AR) or wrapped affine (IAF), with
    a context of ``context`` features where given."""
    g = torch.Generator().manual_seed(3)
    if kind == "rq":
        return NeuralSplineFlowAR(5, 32, num_layers=2, num_blocks_per_layer=2, num_bins=4,
                                  context_features=context, generator=g,
                                  rng=np.random.default_rng(3), device="cpu").eval()
    if kind == "affine" and context is None:
        return MaskedAutoregressiveFlow(5, 32, 2, 2, generator=g, device="cpu").eval()
    chain = []
    for _ in range(2):
        layer = MaskedAffineAutoregressiveTransform(5, 32, context_features=context,
                                                    num_blocks=2, generator=g, device="cpu")
        chain += [ReversePermutation(5, device="cpu"),
                  InverseTransform(layer) if kind == "iaf" else layer]
    return Flow(CompositeTransform(chain), StandardNormal([5])).eval()


def _trainer(kind, context=None):
    cls = maf_train.FusedIAFTrainer if kind == "iaf" else maf_train.FusedMAFTrainer
    return cls(_flow(kind, context), 128)


def _launch(kind, n, context=None, cluster=None, rows=None):
    tr = _trainer(kind, context)
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 5, generator=g)
    c = torch.randn(n, context, generator=g) if context else None
    folded = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    maf_train._launch(x, x, x[:, 0].contiguous(), folded, tr._layers, wh_scale=tr._wh_scale,
                      context=c, direction=tr._direction, packed=None, grads=None, rows=rows,
                      cluster=cluster, **tr._static)
    return tr._dims


@pytest.mark.parametrize("kind,context", [
    ("affine", None), ("affine", 3), ("rq", None), ("rq", 3), ("iaf", None), ("iaf", 3)])
@pytest.mark.parametrize("n,entry,cluster,grid", [
    (1, "maf_train_cluster_launch", 8, 8),
    (509, "maf_train_cluster_launch", 4, 64),
    (512, "maf_train_cluster_launch", 4, 64),
    (2048, "maf_train_cluster_launch", 2, 128),
    (4096, "maf_train_launch", 1, 128),
])
def test_the_launchers_get_the_grid_the_cluster_size_and_the_direction(
        library, monkeypatch, kind, context, n, entry, cluster, grid):
    """The grid is the cluster size times min(tiles, active clusters), or
    min(tiles, SMs) with one block a tile; the stash holds one slot a
    cluster, grid / CS x L x ((nb2 + 1) H + Pp) x 36 floats; the direction,
    the transformer and the context's width reach the kernel as they are."""
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", empty)
    d = _launch(kind, n, context)
    ((name, args),) = library.launches
    assert name == entry and len(args) == len(maf_train._launch_argtypes())
    assert args[N_AT] == n
    D4, Pp, C4 = (-(-v // 4) * 4 for v in (d["D"], d["P"], d["C"]))
    assert args[DIMS_AT] == (d["D"], d["L"], d["H"], D4, d["P"], Pp, d["nb2"], d["C"], C4)
    got_grid, got_cluster, inverse, transformer = args[GRID_AT:GRID_AT + 4]
    assert (got_grid, got_cluster, args[-2]) == (grid, cluster, 32)
    assert inverse == (kind == "iaf") and transformer == (kind == "rq")
    assert (args[1] != 0) == (args[5] != 0) == bool(context)   # ctx, gctx
    slot = d["L"] * ((d["nb2"] + 1) * d["H"] + Pp) * 36
    assert grid // cluster * slot in sizes
    # the occupancy is asked once for each cluster size, with the context's
    # flag and the cluster kernel's shared memory, and only where a cluster
    # could help (4,096 is 128 tiles, fewer than the SMs)
    assert sorted(q[1] for q in library.queries) == list(maf_train.CLUSTER_SIZES)
    smem = maf_train.shared_memory_bytes(32, d["D"], d["L"], d["H"], d["P"], d["C"], 2)
    assert all(q[0] == int(bool(context)) and q[2] == smem for q in library.queries)


def test_the_occupancy_is_asked_once(library):
    _launch("affine", 512)
    _launch("affine", 512)
    assert len(library.queries) == len(maf_train.CLUSTER_SIZES)
    _launch("affine", 512, context=3)   # the conditional kernel has its own
    assert len(library.queries) == 2 * len(maf_train.CLUSTER_SIZES)


def test_64_sample_tiles_ask_for_no_occupancy(library):
    _launch("affine", 512, rows=64)
    ((name, args),) = library.launches
    assert name == "maf_train_launch" and args[GRID_AT:GRID_AT + 2] == (8, 1)
    assert args[-2] == 64 and not library.queries


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_a_forced_cluster_size_is_launched(library, cluster):
    before = dict(maf_train.cluster_launch_count)
    _launch("rq", 512, context=3, cluster=cluster)
    ((name, args),) = library.launches
    assert name == ("maf_train_launch" if cluster == 1 else "maf_train_cluster_launch")
    assert args[GRID_AT + 1] == cluster
    assert args[GRID_AT] == (16 if cluster == 1 else cluster * min(16, H100_ACTIVE[cluster]))
    assert {k: v - before[k] for k, v in maf_train.cluster_launch_count.items()} == {
        c: int(c == cluster) for c in (1, *maf_train.CLUSTER_SIZES)}


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_the_launch_count_is_the_sum_over_cluster_sizes(library, monkeypatch, cluster):
    """``bwd_launch_count`` is every B10 launch, whatever its layout: the
    sum of ``cluster_launch_count``, so that zeroing that dict resets it."""
    monkeypatch.setattr(maf_train, "cluster_launch_count",
                        dict.fromkeys(maf_train.cluster_launch_count, 0))
    assert maf_train.bwd_launch_count == 0
    _launch("iaf", 512, cluster=cluster)
    _launch("affine", 4096)          # one block a tile
    assert maf_train.bwd_launch_count == 2
    assert maf_train.cluster_launch_count == {c: int(c == cluster) + int(c == 1)
                                              for c in (1, *maf_train.CLUSTER_SIZES)}
    for cs in maf_train.cluster_launch_count:
        maf_train.cluster_launch_count[cs] = 0
    assert maf_train.bwd_launch_count == 0

def test_what_the_cluster_kernel_does_not_take_is_refused(library):
    with pytest.raises(ValueError, match="not built"):
        _launch("affine", 512, cluster=3)
    with pytest.raises(ValueError, match="not built"):
        _launch("affine", 512, cluster=8, rows=64)
    with pytest.raises(ValueError, match="not built"):
        _launch("affine", 512, cluster=16)
    assert not library.launches


def test_a_card_without_room_for_a_cluster_raises(library):
    """An occupancy of 0 is an error, not a quiet fall back to one block a
    tile."""
    library.active[8] = 0
    with pytest.raises(RuntimeError, match="no cluster of 8 blocks"):
        _launch("affine", 512)
    assert not library.launches


def test_a_refused_cluster_launch_raises(library):
    library.maf_train_cluster_launch = lambda *args: 2   # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="maf_train_cluster_launch"):
        _launch("iaf", 512, context=3)


@pytest.mark.parametrize("kind,context", [("affine", None), ("rq", 3), ("iaf", 3)])
@pytest.mark.parametrize("cluster", [None, 1, 4, 8])
def test_cpu_tensors_run_the_plain_version_whatever_the_cluster(kind, context, cluster):
    tr = _trainer(kind, context)
    g = torch.Generator().manual_seed(1)
    x = 1.5 * torch.randn(40, 5, generator=g)
    c = torch.randn(40, context, generator=g) if context else None
    gy, glad = torch.randn(40, 5, generator=g) / 40, torch.randn(40, generator=g) / 40
    folded = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    kw = dict(wh_scale=tr._wh_scale, context=c, direction=tr._direction, **tr._static)
    before = maf_train.bwd_launch_count
    gx, grads = maf_train.maf_train_bwd_cuda(x, gy, glad, folded, tr._layers, cluster=cluster,
                                             **kw)
    p_gx, p_grads = maf_train.maf_train_bwd_plain(x, gy, glad, folded, tr._layers, **kw)
    assert maf_train.bwd_launch_count == before
    assert torch.equal(gx, p_gx) and grads.keys() == p_grads.keys()
    assert all(torch.equal(grads[k], p_grads[k]) for k in p_grads)
