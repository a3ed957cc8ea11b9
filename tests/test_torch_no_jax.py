"""The port stands alone: no module of ``nflows_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, statically or at run
time."""

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
            "nflows_tpu_torch/ops/cuda/mademog_train.py"} <= names
    sources = {p.name for p in (ROOT / "nflows_tpu_torch" / "csrc").glob("*.cu*")}
    assert {"mademog_fused.cu", "mademog_train.cu", "mademog.cuh"} <= sources


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("nflows_tpu.ops")
    assert _forbidden("nflows_tpu") and not _forbidden("nflows_tpu_torch.ops")


def test_runtime_loads_no_jax():
    code = (
        "import sys, torch\n"
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
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'nflows_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
