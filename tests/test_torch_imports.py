"""The port runs without JAX: no module of it imports ``jax``.

The machine with the GPU has no JAX, so every module of
``continuous_clustering_tpu_torch`` (and ``chip_smoke.py``) must import in a
process where ``jax`` never enters ``sys.modules``.
"""

from __future__ import annotations

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import continuous_clustering_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "continuous_clustering_tpu_torch"


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(continuous_clustering_tpu_torch.__path__,
                                              prefix="continuous_clustering_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = port_modules()
    assert "continuous_clustering_tpu_torch.ops.cc_cuda" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_port_source_names_jax():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(p.relative_to(ROOT)) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders
