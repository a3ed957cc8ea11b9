"""The cluster layout of the training kernels B3 and B4 on the CPU: how
``nsf_train`` chooses the cluster size, sizes the stash and the grid, and
what it hands the two launchers (caught by a stand-in library before the
kernels, as tests/test_torch_spline_train.py catches the stage settings);
the shared memory the wrapper counts against the CUDA source's
``smem_bytes``. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py). On a CPU tensor each wrapper
runs its plain version, whatever cluster it is asked for: that path is
held against the JAX package in tests/test_torch_nsf_train.py.
"""

import contextlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nflows_tpu_torch import NeuralSplineFlow
from nflows_tpu_torch.ops.cuda import _build, nsf_flow_kernel, nsf_train

torch.set_num_threads(1)

# the clusters an H100 80GB HBM3 holds at once, for B3 and B4 at the
# flagship's widths, with and without a context (chip_smoke.py, PERF.md §6)
H100_ACTIVE = {2: 66, 4: 30, 8: 15}
SMS = 132


def _flow(context=None):
    return NeuralSplineFlow(6, 32, num_layers=2, num_blocks_per_layer=2, num_bins=4,
                            context_features=context,
                            generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0), device="cpu").eval()


@pytest.mark.parametrize("n,expected", [
    (1, 8), (31, 8), (33, 8), (480, 8), (481, 4), (509, 4), (512, 4), (960, 4), (961, 2),
    (2048, 2), (2112, 2), (2113, 1), (4096, 1), (65536, 1)])
def test_cluster_size_on_the_h100(n, expected):
    """One wave of the largest cluster that holds every tile wins: up to 15
    tiles of 32 samples on clusters of 8, up to 30 on clusters of 4, up to
    66 on pairs; from 67 tiles one block a tile (4,096 is 128 tiles, and at
    65,536 the tiles are 64 samples)."""
    rows = 64 if n >= 64 * SMS else 32
    assert nsf_train.cluster_size(n, rows, SMS, H100_ACTIVE) == expected


def test_cluster_size_takes_one_block_where_no_sm_is_idle():
    assert nsf_train.cluster_size(4096, 32, 128, H100_ACTIVE) == 1
    assert nsf_train.cluster_size(100, 64, SMS, H100_ACTIVE) == 1
    assert nsf_train.cluster_size(512, 32, SMS, {}) == 1
    # with clusters of 8 alone, 16 tiles would take two waves of them
    assert nsf_train.cluster_size(512, 32, SMS, {8: 15}) == 1
    assert nsf_train.cluster_size(512, 32, SMS, {8: 16}) == 8
    assert nsf_train.cluster_size(512, 32, SMS, {8: 2}) == 1
    with pytest.raises(ValueError):
        nsf_train.cluster_size(512, 32, SMS, {8: 0})


@pytest.mark.parametrize("C", [0, 10])
@pytest.mark.parametrize("cluster", [1, *nsf_train.CLUSTER_SIZES])
def test_shared_memory_counts_match_the_cluster_source(cluster, C):
    """``shared_memory_bytes`` against ``smem_bytes`` of the source the
    cluster size runs, evaluated in Python as
    tests/test_torch_conditional_fused.py does."""
    source = "nsf_train.cu" if cluster == 1 else "nsf_train_cluster.cu"
    text = (Path(nsf_flow_kernel.__file__).resolve().parents[2] / "csrc" / source).read_text()
    body = re.search(r"size_t smem_bytes\(int rows, const \w+& a\) \{\s*return (.*?);\s*\}",
                     text, re.S).group(1)
    expr = re.sub(r"\ba\.(\w+)", r"v['\1']", body.replace("(size_t)", "").replace(
        "sizeof(float)", "4"))
    dims = dict(D=6, L=10, H=256, Tid=3, T=3, TM=69, C=C)
    v = dict(dims, TB=256)
    assert nsf_train.shared_memory_bytes(32, *(dims[k] for k in (
        "D", "L", "H", "Tid", "T", "TM", "C")), cluster=cluster) == eval(
        expr, {"v": v, "rows": 32, "KC": 32, "OC": 256, "CW": 32, "KCL": 128, "NSTAGE": 2})
    if cluster > 1:  # the cluster kernels fit wherever one block a tile does
        assert nsf_train.shared_memory_bytes(32, 6, 10, 256, 3, 3, 69, C, cluster) == \
            nsf_train.shared_memory_bytes(32, 6, 10, 256, 3, 3, 69, C)


def _library(active):
    """A stand-in for both training libraries: records each launch's
    arguments and answers the occupancy query from ``active``."""
    lib = types.SimpleNamespace(active=active, launches=[], queries=[])

    def launcher(name):
        def launch(*args):
            lib.launches.append((name, args))
            return 0
        return launch

    def occupancy(loss, context, cluster, smem, found):
        lib.queries.append((loss, context, cluster, smem))
        found._obj.value = lib.active.get(cluster, 0)
        return 0

    lib.nsf_train_launch = launcher("nsf_train_launch")
    lib.nsf_train_cluster_launch = launcher("nsf_train_cluster_launch")
    lib.nsf_train_cluster_occupancy = occupancy
    nsf_train._declare(lib)
    nsf_train._declare_cluster(lib)
    return lib


@pytest.fixture
def library(monkeypatch):
    lib = _library(dict(H100_ACTIVE))
    monkeypatch.setattr(_build, "load_library", lambda stem, declare: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(nsf_train, "_ACTIVE_CLUSTERS", {})
    return lib


def _launch(loss, n, context=None, cluster=None, rows=None, **flow_kw):
    ttr = nsf_train.FusedNSFTrainer(_flow(context), 128)
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 6, generator=g)
    c = torch.randn(n, context, generator=g) if context else None
    d = ttr._dims
    if rows is None:
        rows = nsf_train.tile_rows(n, d, SMS)
    nsf_train._launch(loss, x, x, x[:, 0].contiguous(), ttr.weights, ttr._indices, ttr._static,
                      ttr._wh_scale, None, None, rows, 1.0 / n, c, cluster)
    return d, rows


@pytest.mark.parametrize("loss", [True, False])
@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("n,entry,cluster,grid", [
    (1, "nsf_train_cluster_launch", 8, 8),
    (509, "nsf_train_cluster_launch", 4, 64),
    (512, "nsf_train_cluster_launch", 4, 64),
    (2048, "nsf_train_cluster_launch", 2, 128),
    (4096, "nsf_train_launch", 1, 128),
])
def test_the_launchers_get_the_grid_and_the_cluster_size(library, monkeypatch, loss, context,
                                                         n, entry, cluster, grid):
    """The grid is the cluster size times min(tiles, active clusters), or
    min(tiles, SMs) with one block a tile; the stash holds one slot a
    cluster, grid / CS x L x (kept H + TMp) x 36 floats."""
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", empty)
    d, rows = _launch(loss, n, context)
    ((name, args),) = library.launches
    assert name == entry and len(args) == len(nsf_train._launch_argtypes())
    got_grid, got_cluster = args[44:46]
    assert (got_grid, got_cluster, args[-2]) == (grid, cluster, rows)
    kept = d["nb2"] + 1 + (d["nb2"] // 2 if context else 0)
    slot = d["L"] * (kept * d["H"] + nsf_flow_kernel._round4(d["TM"])) * (rows + 4)
    assert grid // cluster * slot in sizes
    # the occupancy is asked once for each cluster size, and only where a
    # cluster could help
    assert sorted(q[2] for q in library.queries) == (
        list(nsf_train.CLUSTER_SIZES) if cluster > 1 or n < SMS * 32 else [])
    assert all(q[:2] == (int(loss), int(bool(context))) for q in library.queries)


def test_the_occupancy_is_asked_once(library):
    _launch(True, 512)
    _launch(True, 512)
    assert len(library.queries) == len(nsf_train.CLUSTER_SIZES)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_a_forced_cluster_size_is_launched(library, cluster):
    _launch(False, 512, cluster=cluster)
    ((name, args),) = library.launches
    assert name == ("nsf_train_launch" if cluster == 1 else "nsf_train_cluster_launch")
    assert args[45] == cluster
    assert args[44] == (16 if cluster == 1 else cluster * min(16, H100_ACTIVE[cluster]))


def test_what_the_cluster_kernels_do_not_take_is_refused(library):
    with pytest.raises(ValueError):
        _launch(True, 512, cluster=3)
    with pytest.raises(ValueError):
        _launch(True, 512, cluster=8, rows=64)
    assert not library.launches


def test_a_card_without_room_for_a_cluster_raises(library):
    """An occupancy of 0 is an error, not a quiet fall back to one block a
    tile."""
    library.active[8] = 0
    with pytest.raises(RuntimeError, match="no cluster of 8 blocks"):
        _launch(True, 512)
    assert not library.launches


def test_a_refused_cluster_launch_raises(library):
    library.nsf_train_cluster_launch = lambda *args: 2   # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="nsf_train_cluster_launch"):
        _launch(True, 512)


@pytest.mark.parametrize("cluster", [None, 1, 8])
def test_cpu_tensors_run_the_plain_version_whatever_the_cluster(cluster):
    ttr = nsf_train.FusedNSFTrainer(_flow(), 128)
    x = 1.5 * torch.randn(40, 6, generator=torch.Generator().manual_seed(1))
    kw = dict(wh_scale=ttr._wh_scale, **ttr._static)
    loss, lp, grads = nsf_train.nsf_loss_grad_cuda(x, ttr.weights, ttr._indices,
                                                    cluster=cluster, **kw)
    p_loss, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, ttr.weights, ttr._indices, **kw)
    assert torch.equal(lp, p_lp) and torch.equal(loss, p_loss)
    assert all(torch.equal(grads[k], p_grads[k]) for k in p_grads)
    gy, glad = x / 40, torch.full((40,), 0.025)
    gx, g4 = nsf_train.nsf_train_bwd_cuda(x, gy, glad, ttr.weights, ttr._indices,
                                          cluster=cluster, **kw)
    p_gx, p_g4 = nsf_train.nsf_train_bwd_plain(x, gy, glad, ttr.weights, ttr._indices, **kw)
    assert torch.equal(gx, p_gx) and all(torch.equal(g4[k], p_g4[k]) for k in p_g4)
