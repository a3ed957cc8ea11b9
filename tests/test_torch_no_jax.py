"""The port stands alone: no module of ``nflows_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, statically or at run
time (building, serving and training each family, a conditional NSF, a
conditional NSF-AR, an IAF's variational step, the two diagonal Normal
bases, serving in bf16, serving a coupling flow with a learned CDF on
its identity half, an autoregressive spline flow and the two UMNN flows,
and serving and training an NSF-AR with LU layers and a batch-normed MAF
included)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "nflows_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted((ROOT / "nflows_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_scan_covers_the_port():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"nflows_tpu_torch/nn/made.py", "nflows_tpu_torch/transforms/autoregressive.py",
            "nflows_tpu_torch/ops/cuda/maf_flow_kernel.py",
            "nflows_tpu_torch/ops/cuda/maf_train.py",
            "nflows_tpu_torch/nn/nde/made.py", "nflows_tpu_torch/distributions/mixture.py",
            "nflows_tpu_torch/ops/cuda/mademog_fused.py",
            "nflows_tpu_torch/ops/cuda/mademog_train.py",
            "nflows_tpu_torch/ops/splines/linear_rational.py",
            "nflows_tpu_torch/ops/splines/linear.py",
            "nflows_tpu_torch/ops/splines/quadratic.py",
            "nflows_tpu_torch/ops/splines/cubic.py",
            "nflows_tpu_torch/ops/cuda/_spline_common.py",
            "nflows_tpu_torch/ops/cuda/lrs_spline.py",
            "nflows_tpu_torch/ops/cuda/linear_spline.py",
            "nflows_tpu_torch/ops/cuda/quadratic_spline.py",
            "nflows_tpu_torch/ops/cuda/cubic_spline.py",
            "nflows_tpu_torch/flows/realnvp.py", "nflows_tpu_torch/nn/nets/mlp.py",
            "nflows_tpu_torch/distributions/normal.py",
            "nflows_tpu_torch/ops/cuda/_fused_view_common.py",
            "nflows_tpu_torch/ops/cuda/_trainer_common.py",
            "nflows_tpu_torch/ops/cuda/nsf_fused.py", "nflows_tpu_torch/ops/cuda/nsf_train.py",
            "nflows_tpu_torch/ops/cuda/nsf_flow_kernel.py", "nflows_tpu_torch/serving.py",
            "nflows_tpu_torch/transforms/nonlinearities.py",
            "nflows_tpu_torch/transforms/umnn.py",
            "nflows_tpu_torch/transforms/UMNN/__init__.py",
            "nflows_tpu_torch/transforms/UMNN/MonotonicNormalizer.py",
            "nflows_tpu_torch/transforms/linear.py", "nflows_tpu_torch/transforms/lu.py",
            "nflows_tpu_torch/transforms/qr.py", "nflows_tpu_torch/transforms/svd.py",
            "nflows_tpu_torch/transforms/orthogonal.py",
            "nflows_tpu_torch/transforms/normalization.py",
            "nflows_tpu_torch/utils/linalg.py"} <= names
    sources = {p.name for p in (ROOT / "nflows_tpu_torch" / "csrc").glob("*.cu*")}
    assert {"mademog_fused.cu", "mademog_train.cu", "mademog.cuh", "spline_common.cuh",
            "affine_coupling.cuh", "coupling_stage.cuh", "nsf_flow_kernel.cu", "nsf_train.cu",
            "tile_gemm.cuh", "nsf_flow_kernel.cuh", "nsf_flow_kernel_bf16.cu",
            "maf_flow_kernel.cuh", "maf_flow_kernel.cu", "maf_flow_kernel_bf16.cu",
            "nsf_train.cuh", "nsf_train_cluster.cu", "cluster_gemm.cuh"} <= sources
    for stem in ("lrs_spline", "linear_spline", "quadratic_spline", "cubic_spline"):
        assert {f"{stem}.cu", f"{stem}.cuh", f"{stem}_bwd.cuh"} <= sources


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("nflows_tpu.ops")
    assert _forbidden("nflows_tpu") and not _forbidden("nflows_tpu_torch.ops")


def test_runtime_loads_no_jax():
    code = (
        "import copy, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import nflows_tpu_torch as nt\n"
        "f = nt.NeuralSplineFlow(6, 8, num_layers=2, num_bins=4, device='cpu',\n"
        "                        generator=torch.Generator().manual_seed(0))\n"
        "x = torch.randn(16, 6)\n"
        "nt.CompiledFlow(f, 16, 6, device='cpu').log_prob(x)\n"
        "nt.CompiledFlow(f, 16, 6, device='cpu', use_fused=False).log_prob(x)\n"
        "adam = lambda p: torch.optim.Adam(p, lr=1e-3)\n"
        "tr = nt.fused_trainer(f, 128)\n"
        "tr.make_train_step(tr.init_opt(adam))(torch.randn(128, 6))\n"
        "nt.make_train_step()(nt.create_train_state(f, adam), x)\n"
        "for m in (nt.MaskedAutoregressiveFlow(5, 8, 2, 1, device='cpu'),\n"
        "          nt.NeuralSplineFlowAR(5, 8, num_layers=2, num_bins=4, device='cpu')):\n"
        "    y = torch.randn(16, 5)\n"
        "    assert nt.CompiledFlow(m, 16, 5, device='cpu').is_fused\n"
        "    nt.CompiledFlow(m, 16, 5, device='cpu').sample(torch.Generator().manual_seed(0))\n"
        "    nt.CompiledFlow(m, 16, 5, device='cpu', use_fused=False).log_prob(y)\n"
        "    tr = nt.fused_trainer(m, 128)\n"
        "    tr.make_train_step(tr.init_opt(adam))(torch.randn(128, 5))\n"
        "    tr.to_flow()\n"
        "    nt.make_train_step()(nt.create_train_state(m, adam), y)\n"
        "nt.InverseAutoregressiveFlow(5, 8, 2, 1, device='cpu').log_prob(torch.randn(4, 5))\n"
        "lrs = nt.NeuralSplineFlow(6, 8, num_layers=2, num_bins=4, spline='lrs', device='cpu')\n"
        "nt.CompiledFlow(lrs, 16, 6, device='cpu').sample_and_log_prob(torch.Generator())\n"
        "nt.make_train_step()(nt.create_train_state(lrs, adam), x)\n"
        "tr = nt.fused_trainer(lrs, 128)\n"
        "tr.make_train_step(tr.init_opt(adam))(torch.randn(128, 6))\n"
        "from nflows_tpu_torch.transforms import (PiecewiseLinearCouplingTransform,\n"
        "    PiecewiseQuadraticCouplingTransform, PiecewiseCubicCouplingTransform)\n"
        "from nflows_tpu_torch.nn.nets import ResidualNet\n"
        "for cls in (PiecewiseLinearCouplingTransform, PiecewiseQuadraticCouplingTransform,\n"
        "            PiecewiseCubicCouplingTransform):\n"
        "    c = cls([1, -1, 1, -1, 1, -1], lambda i, o: ResidualNet(i, o, 8, device='cpu'),\n"
        "            num_bins=4, tails='linear', tail_bound=3.0, device='cpu')\n"
        "    c.inverse(c.forward(x)[0])\n"
        "    nt.CompiledFlow(nt.Flow(nt.transforms.CompositeTransform([c]),\n"
        "                            nt.distributions.StandardNormal([6])), 16, 6,\n"
        "                    use_fused=True, device='cpu').log_prob(x)\n"
        "for vp in (False, True):\n"
        "    r = nt.SimpleRealNVP(6, 8, 2, 1, use_volume_preserving=vp, device='cpu')\n"
        "    assert nt.CompiledFlow(r, 16, 6, device='cpu').is_fused\n"
        "    nt.CompiledFlow(r, 16, 6, device='cpu').sample_and_log_prob(torch.Generator())\n"
        "    tr = nt.fused_trainer(r, 128)\n"
        "    tr.make_train_step(tr.init_opt(adam))(torch.randn(128, 6))\n"
        "    tr.to_flow()\n"
        "nt.nn.nets.MLP((6,), (2,), [8])(x)\n"
        "for m, cf in ((nt.MixtureOfGaussiansMADE(5, 8, device='cpu'), None),\n"
        "              (nt.MADEMoG(5, 8, 3, num_mixture_components=2, device='cpu'), 3)):\n"
        "    y = torch.randn(16, 5)\n"
        "    c = None if cf is None else torch.randn(16, cf)\n"
        "    served = nt.CompiledFlow(m, 16, 5, context_features=cf, device='cpu')\n"
        "    assert served.is_fused\n"
        "    served.log_prob(y, c)\n"
        "    served.sample_and_log_prob(torch.Generator().manual_seed(0), c)\n"
        "    tr = nt.fused_trainer(m, 128)\n"
        "    c = None if cf is None else torch.randn(128, cf)\n"
        "    tr.make_train_step(tr.init_opt(adam))(torch.randn(128, 5), c)\n"
        "    tr.to_dist()\n"
        "    nt.make_train_step()(nt.create_train_state(m, adam), torch.randn(128, 5), c)\n"
        "cnsf = nt.NeuralSplineFlow(6, 8, num_layers=2, num_bins=4, context_features=3,\n"
        "                           device='cpu')\n"
        "c = torch.randn(16, 3)\n"
        "served = nt.CompiledFlow(cnsf, 16, 6, context_features=3, device='cpu')\n"
        "assert served.is_fused\n"
        "served.log_prob(x, c)\n"
        "served.sample_and_log_prob(torch.Generator().manual_seed(0), c)\n"
        "tr = nt.fused_trainer(cnsf, 128)\n"
        "tr.make_train_step(tr.init_opt(adam))(torch.randn(128, 6), torch.randn(128, 3))\n"
        "tr.to_flow()\n"
        "car = nt.NeuralSplineFlowAR(5, 8, num_layers=2, num_bins=4, context_features=3,\n"
        "                            device='cpu')\n"
        "served = nt.CompiledFlow(car, 16, 5, context_features=3, device='cpu')\n"
        "assert served.is_fused\n"
        "served.log_prob(torch.randn(16, 5), c)\n"
        "tr = nt.fused_trainer(car, 128)\n"
        "tr.make_train_step(tr.init_opt(adam))(torch.randn(128, 5), torch.randn(128, 3))\n"
        "tr.to_flow()\n"
        "tr = nt.fused_trainer(nt.InverseAutoregressiveFlow(5, 8, 2, 1, device='cpu'), 128)\n"
        "tr.make_vi_train_step(tr.init_opt(adam), lambda v: -(v * v).sum(dim=1))(\n"
        "    torch.Generator().manual_seed(0))\n"
        "base = nt.ConditionalDiagonalNormal([6], context_encoder=torch.nn.Linear(3, 12))\n"
        "nt.Flow(cnsf.transform, base).log_prob(x, c)\n"
        "nt.DiagonalNormal([6]).log_prob(x)\n"
        "bf16 = torch.bfloat16\n"
        "for m, d in ((f, 6), (nt.MaskedAutoregressiveFlow(5, 8, 2, 1, device='cpu'), 5),\n"
        "             (nt.MixtureOfGaussiansMADE(5, 8, device='cpu'), 5)):\n"
        "    served = nt.CompiledFlow(m, 16, d, dtype=bf16, device='cpu')\n"
        "    assert served.is_fused\n"
        "    served.log_prob(torch.randn(16, d).to(bf16))\n"
        "    nt.CompiledFlow(m, 16, d, dtype=bf16, use_fused=False,\n"
        "                    device='cpu').log_prob(torch.randn(16, d).to(bf16))\n"
        "f.fused(bf16).sample(torch.Generator(), 4)\n"
        "T = nt.transforms\n"
        "def chain(layers):\n"
        "    return nt.Flow(T.CompositeTransform([m for l in layers for m in\n"
        "                                         (T.ReversePermutation(6, device='cpu'), l)]),\n"
        "                   nt.distributions.StandardNormal([6]))\n"
        "net = lambda i, o: ResidualNet(i, o, 8, device='cpu')\n"
        "mask = [1, -1, 1, -1, 1, -1]\n"
        "for m in (chain([T.PiecewiseRationalQuadraticCouplingTransform(\n"
        "              mask, net, num_bins=4, tails='linear', tail_bound=3.0,\n"
        "              apply_unconditional_transform=True, device='cpu')]),\n"
        "          chain([T.MaskedPiecewiseQuadraticAutoregressiveTransform(\n"
        "              6, 8, num_bins=4, tails='linear', tail_bound=3.0, device='cpu')]),\n"
        "          chain([T.MaskedUMNNAutoregressiveTransform(\n"
        "              6, 8, integrand_net_layers=[8], cond_size=2, nb_steps=4, device='cpu')]),\n"
        "          chain([T.UMNNCouplingTransform(\n"
        "              mask, net, integrand_net_layers=[8], cond_size=2, nb_steps=4,\n"
        "              apply_unconditional_transform=True, device='cpu')])):\n"
        "    served = nt.CompiledFlow(m, 16, 6, device='cpu')\n"
        "    assert not served.is_fused\n"
        "    served.log_prob(x)\n"
        "    served.sample_and_log_prob(torch.Generator().manual_seed(0))\n"
        "    nt.make_train_step()(nt.create_train_state(m, adam), x)\n"
        "lu = nt.NeuralSplineFlowAR(5, 8, num_layers=2, num_bins=4, use_linear_layers=True,\n"
        "                           device='cpu')\n"
        "bn = nt.MaskedAutoregressiveFlow(5, 8, 2, 1, batch_norm_between_layers=True,\n"
        "                                 batch_norm_within_layers=True, device='cpu')\n"
        "bn.transform.initialize_with_data(torch.randn(64, 5))\n"
        "for m in (lu, T.precompute_linear_caches(copy.deepcopy(lu)), bn.eval()):\n"
        "    served = nt.CompiledFlow(m, 16, 5, device='cpu')\n"
        "    assert not served.is_fused\n"
        "    served.log_prob(torch.randn(16, 5))\n"
        "    served.sample_and_log_prob(torch.Generator().manual_seed(0))\n"
        "    assert nt.fused_trainer(m, 128, required=False) is None\n"
        "for m in (lu, bn.train()):\n"
        "    nt.make_train_step()(nt.create_train_state(m, adam), torch.randn(128, 5))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'nflows_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
