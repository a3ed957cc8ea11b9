"""The cluster layout of kernel B12 on the CPU: how ``mademog_train``
chooses the cluster size, sizes the stash and the grid, and what it hands
the two launchers (caught by a stand-in library before the kernels, as
tests/test_torch_maf_train_cluster.py does for B10); the shared memory the
wrapper counts against the CUDA sources' ``smem_bytes``. The kernels
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py). On a
CPU tensor the wrapper runs its plain version, whatever cluster it is asked
for: that path is held against autograd in float64 and ``jax.grad`` in
tests/test_torch_mademog_train.py.
"""

import contextlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nflows_tpu_torch import MixtureOfGaussiansMADE
from nflows_tpu_torch.ops.cuda import _build, _trainer_common, maf_train, mademog_train

torch.set_num_threads(1)

# the clusters an H100 80GB HBM3 holds at once at the shared memory of one
# block an SM (B3, B4 and B10: chip_smoke.py, PERF.md §6); B12's blocks take
# as much
H100_ACTIVE = {2: 66, 4: 30, 8: 15}
SMS = 132
# B12 on chip_smoke.py's full-width MoG-MADE (benchmarks/bench_fused_mademog.py):
# features 10, hidden 256, 10 components, 2 blocks; its twin has context 10
MOG_STATIC = dict(D=10, K=10, H=256, num_blocks=2, epsilon=1e-2)

# where the stand-in finds the arguments (csrc/mademog_train.cuh: the entry
# points' parameter list)
GX_AT, GCTX_AT, N_AT, DIMS_AT = 3, 4, 5, slice(6, 13)


@pytest.mark.parametrize("context", [None, 10])
@pytest.mark.parametrize("n,expected", [
    (1, 8), (31, 8), (33, 8), (480, 8), (481, 4), (512, 4), (960, 4), (961, 2),
    (2048, 2), (4096, 1)])
def test_cluster_size_on_the_h100(n, expected, context):
    """B12's dims on the H100's occupancy: up to 15 tiles of 32 samples on
    clusters of 8, up to 30 on clusters of 4, up to 66 on pairs; at 4,096
    (128 tiles, more than 66 pairs) one block a tile, csrc/mademog_train.cu."""
    assert _trainer_common.cluster_size(n, 32, SMS, H100_ACTIVE) == expected
    with pytest.MonkeyPatch.context() as mp:
        lib = _library(dict(H100_ACTIVE))
        mp.setattr(_build, "load_library", lambda stem, declare: lib)
        _patch_card(mp)
        cluster, grid = mademog_train.launch_layout(n, MOG_STATIC, context,
                                                    torch.device("cpu"))
    tiles = -(-n // 32)
    assert cluster == expected
    assert grid == (min(tiles, SMS) if expected == 1
                    else expected * min(tiles, H100_ACTIVE[expected]))


def test_the_rule_is_the_one_b3_b4_and_b10_follow():
    from nflows_tpu_torch.ops.cuda import nsf_train

    assert mademog_train.cluster_layout is maf_train.cluster_layout
    assert nsf_train.cluster_size is _trainer_common.cluster_size
    assert mademog_train.CLUSTER_SIZES == maf_train.CLUSTER_SIZES == (2, 4, 8)


def _smem_bytes_of(source):
    """``smem_bytes`` of a B12 source as a Python expression in ``v`` (the
    launch arguments) and the sources' constants."""
    text = (Path(mademog_train.__file__).resolve().parents[2] / "csrc" / source).read_text()
    body = re.search(r"size_t smem_bytes\(const MogTrainArgs& a\) \{\s*return (.*?);\s*\}",
                     text, re.S).group(1)
    return re.sub(r"\ba\.(?:d\.)?(\w+)", r"v['\1']",
                  body.replace("(size_t)", "").replace("sizeof(float)", "4"))


@pytest.mark.parametrize("C", [0, 10])
@pytest.mark.parametrize("cluster", [1, *mademog_train.CLUSTER_SIZES])
def test_shared_memory_counts_match_the_cluster_source(cluster, C):
    """``shared_memory_bytes`` against ``smem_bytes`` of the source the
    cluster size runs, evaluated in Python as
    tests/test_torch_maf_train_cluster.py does."""
    expr = _smem_bytes_of("mademog_train.cu" if cluster == 1 else "mademog_train_cluster.cu")
    D, K, H = MOG_STATIC["D"], MOG_STATIC["K"], MOG_STATIC["H"]
    v = dict(D=D, C=C, TB=max(H, 3 * K * D))
    got = mademog_train.shared_memory_bytes(D, C, K, H, cluster)
    assert got == eval(expr, {"v": v, "ROWS": 32, "RS": 36, "KC": 32, "OC": 256, "CW": 32,
                              "KCL": 128, "NSTAGE": 2})
    # the cluster kernel fits wherever one block a tile does, one block an SM:
    # 3 x 300 x 36 x 4 bytes of X, Y and Z, cl::WBUF's 64 KiB and the inputs
    assert got == mademog_train.shared_memory_bytes(D, C, K, H)
    assert got == 4 * (16384 + 36 * (900 + 20 + 2 * C) + 32)
    assert 2 * got > mademog_train.MAX_SHARED_MEMORY >= got


def _library(active):
    """A stand-in for both B12 libraries: records each launch's arguments
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

    lib.mademog_train_launch = launcher("mademog_train_launch")
    lib.mademog_train_cluster_launch = launcher("mademog_train_cluster_launch")
    lib.mademog_train_cluster_occupancy = occupancy
    mademog_train._declare(lib)
    mademog_train._declare_cluster(lib)
    return lib


def _patch_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(mademog_train, "_ACTIVE_CLUSTERS", {})


@pytest.fixture
def library(monkeypatch):
    lib = _library(dict(H100_ACTIVE))
    monkeypatch.setattr(_build, "load_library", lambda stem, declare: lib)
    _patch_card(monkeypatch)
    return lib


def _trainer(context=None):
    """A small MoG-MADE: features 5, hidden 32, 4 components, 2 blocks, with
    a context of ``context`` features where given."""
    dist = MixtureOfGaussiansMADE(5, 32, context_features=context, num_blocks=2,
                                  num_mixture_components=4,
                                  generator=torch.Generator().manual_seed(3),
                                  rng=np.random.default_rng(3), device="cpu").eval()
    return mademog_train.FusedMADEMoGTrainer(dist, 128)


def _inputs(tr, n, context):
    g = torch.Generator().manual_seed(n)
    x = 1.5 * torch.randn(n, 5, generator=g)
    c = torch.randn(n, context, generator=g) if context else None
    glp = torch.randn(n, generator=g) / n
    folded = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    return x, glp, folded, c


def _launch(n, context=None, cluster=None):
    tr = _trainer(context)
    x, glp, folded, c = _inputs(tr, n, context)
    return tr, mademog_train._launch(x, glp, folded, tr._static, c, None, None, cluster)


@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("n,entry,cluster,grid", [
    (1, "mademog_train_cluster_launch", 8, 8),
    (509, "mademog_train_cluster_launch", 4, 64),
    (512, "mademog_train_cluster_launch", 4, 64),
    (2048, "mademog_train_cluster_launch", 2, 128),
    (4096, "mademog_train_launch", 1, 128),
])
def test_the_launchers_get_the_grid_the_cluster_size_and_the_stash(
        library, monkeypatch, context, n, entry, cluster, grid):
    """The grid is the cluster size times min(tiles, active clusters), or
    min(tiles, SMs) with one block a tile; the stash holds one slot a
    cluster, grid / CS x (2 + 2 nb) x H x 36 floats; the dims and the
    context's width reach the kernel as they are; the cluster kernel adds
    into gctx, which it is handed zeroed."""
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", empty)
    tr, (gx, gctx, grads) = _launch(n, context)
    ((name, args),) = library.launches
    assert name == entry and len(args) == len(mademog_train._launch_argtypes())
    s = tr._static
    P = 3 * s["K"] * s["D"]
    assert args[N_AT] == n
    assert args[DIMS_AT] == (s["D"], context or 0, s["K"], s["H"], P, -(-P // 4) * 4,
                             s["num_blocks"])
    assert args[-3:-1] == (grid, cluster)
    assert args[GX_AT] == gx.data_ptr()
    # ctx and gctx, null (None) without a context
    assert (args[1] is not None) == (args[GCTX_AT] is not None) == bool(context)
    if context:
        assert args[GCTX_AT] == gctx.data_ptr()
        if cluster > 1:
            assert torch.equal(gctx, torch.zeros_like(gctx))
    slot = (2 + 2 * s["num_blocks"]) * s["H"] * 36
    assert grid // cluster * slot in sizes
    # the occupancy is asked once for each cluster size, with the context's
    # flag and the cluster kernel's shared memory, and only where a cluster
    # could help (4,096 is 128 tiles, fewer than the SMs)
    assert sorted(q[1] for q in library.queries) == list(mademog_train.CLUSTER_SIZES)
    smem = mademog_train.shared_memory_bytes(s["D"], context or 0, s["K"], s["H"], 2)
    assert all(q[0] == int(bool(context)) and q[2] == smem for q in library.queries)


def test_the_occupancy_is_asked_once(library):
    _launch(512)
    _launch(512)
    assert len(library.queries) == len(mademog_train.CLUSTER_SIZES)
    _launch(512, context=3)   # the conditional kernel has its own
    assert len(library.queries) == 2 * len(mademog_train.CLUSTER_SIZES)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_a_forced_cluster_size_is_launched(library, cluster):
    before = dict(mademog_train.cluster_launch_count)
    _launch(512, context=3, cluster=cluster)
    ((name, args),) = library.launches
    assert name == ("mademog_train_launch" if cluster == 1 else "mademog_train_cluster_launch")
    assert args[-2] == cluster
    assert args[-3] == (16 if cluster == 1 else cluster * min(16, H100_ACTIVE[cluster]))
    assert {k: v - before[k] for k, v in mademog_train.cluster_launch_count.items()} == {
        c: int(c == cluster) for c in (1, *mademog_train.CLUSTER_SIZES)}


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_the_launch_count_is_the_sum_over_cluster_sizes(library, monkeypatch, cluster):
    """``bwd_launch_count`` is every B12 launch, whatever its layout: the
    sum of ``cluster_launch_count``, so that zeroing that dict resets it."""
    monkeypatch.setattr(mademog_train, "cluster_launch_count",
                        dict.fromkeys(mademog_train.cluster_launch_count, 0))
    assert mademog_train.bwd_launch_count == 0
    _launch(512, cluster=cluster)
    _launch(4096)          # one block a tile
    assert mademog_train.bwd_launch_count == 2
    assert mademog_train.cluster_launch_count == {
        c: int(c == cluster) + int(c == 1) for c in (1, *mademog_train.CLUSTER_SIZES)}
    for cs in mademog_train.cluster_launch_count:
        mademog_train.cluster_launch_count[cs] = 0
    assert mademog_train.bwd_launch_count == 0


@pytest.mark.parametrize("cluster", [3, 16])
def test_what_the_cluster_kernel_does_not_take_is_refused(library, cluster):
    with pytest.raises(ValueError, match="not built"):
        _launch(512, cluster=cluster)
    assert not library.launches


def test_a_card_without_room_for_a_cluster_raises(library):
    """An occupancy of 0 is an error, not a quiet fall back to one block a
    tile."""
    library.active[8] = 0
    with pytest.raises(RuntimeError, match="no cluster of 8 blocks"):
        _launch(512)
    assert not library.launches


def test_a_refused_cluster_launch_raises(library):
    library.mademog_train_cluster_launch = lambda *args: 2   # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="mademog_train_cluster_launch"):
        _launch(512, context=3)


def test_a_width_past_shared_memory_is_refused(library):
    with pytest.raises(ValueError, match="does not fit"):
        mademog_train.launch_layout(512, dict(MOG_STATIC, H=1024), None, torch.device("cpu"))
    assert not library.queries


@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("cluster", [None, 1, 4, 8])
def test_cpu_tensors_run_the_plain_version_whatever_the_cluster(context, cluster):
    tr = _trainer(context)
    x, glp, folded, c = _inputs(tr, 40, context)
    before = mademog_train.bwd_launch_count
    gx, gctx, grads = mademog_train.mademog_train_bwd_cuda(x, glp, folded, tr._static, c,
                                                           cluster=cluster)
    p_gx, p_gctx, p_grads = mademog_train.mademog_train_bwd_plain(x, glp, folded, tr._static, c)
    assert mademog_train.bwd_launch_count == before
    assert torch.equal(gx, p_gx) and grads.keys() == p_grads.keys()
    assert (gctx is None) == (p_gctx is None) and (gctx is None or torch.equal(gctx, p_gctx))
    assert all(torch.equal(grads[k], p_grads[k]) for k in p_grads)
