"""Import hygiene: the port and chip_smoke.py import neither JAX nor the
JAX package (the machine with the card has no JAX)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cuda_fortran_mc_simulation_spin_tpu_torch"
JAX_PKG = "cuda_fortran_mc_simulation_spin_tpu"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_and_smoke_import_with_jax_poisoned():
    """With None in sys.modules for jax and the JAX package, every port
    module and chip_smoke import cleanly in a fresh interpreter."""
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', %r):" % JAX_PKG,
        "    sys.modules[name] = None",
        "for m in %r:" % (_port_modules() + ["chip_smoke"]),
        "    importlib.import_module(m)",
        "assert 'jax' not in {k.split('.')[0] for k, v in "
        "sys.modules.items() if v is not None}",
        "print('ok')",
    ])
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.module:
                yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib"), (path, name)
        assert top != JAX_PKG, (path, name)


def test_the_slices_modules_are_checked():
    """The hygiene tests above walk the whole package: every ported
    slice's modules are among what they import."""
    mods = set(_port_modules())
    for name in ("ops.ising2d_multispin", "ops.helical_multispin",
                 "ops.ising3d_multispin", "ops.helical3d_multispin",
                 "models.ising2d_helical", "models.ising3d",
                 "models.ising3d_helical", "ops.clock_planes",
                 "ops.clock_multispin", "ops.clock4_multispin",
                 "ops.clock3_multispin", "ops.clock_helical_multispin",
                 "models.clock", "models.clock_helical", "ops.trig",
                 "ops.xy2d_pallas", "models.xy2d", "models.xy2d_helical",
                 "ops.xy2d_helical_dense", "ops.xy2d_helical_dense_angle",
                 "ops.clock_pallas", "ops.clock_measure_pallas",
                 "ops.clock_multisweep"):
        assert f"cuda_fortran_mc_simulation_spin_tpu_torch.{name}" in mods
