"""What the benchmark's sources import, checked on their text and in a
fresh process: nothing of JAX or the JAX package anywhere, and nothing of
the program in the reference."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "continuous_clustering_tpu"}
PROGRAM = "continuous_clustering_tpu_torch"


def imported_top_levels(path: Path) -> set:
    """Top-level names of every module the file imports (whole names; a
    relative import is the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(str(arg.value).split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(str(arg.values[0].value).split(".")[0])
    return names


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        assert not imported_top_levels(path) & JAX_SIDE, path


def test_the_reference_imports_neither_jax_nor_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert not imported_top_levels(path) & (JAX_SIDE | {PROGRAM}), path


def test_names_compare_whole():
    # the program's name begins with the JAX package's, and is not it
    assert PROGRAM.split(".")[0] not in JAX_SIDE


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; import ccbench.reference.steady, ccbench.reference.velodyne, "
            "ccbench.check; bad = {m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(JAX_SIDE | {PROGRAM})!r}); print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; from ccbench.tests.small import run_small; "
            "run_small('kitti_hdl64.standard.host', seconds=0.5); "
            "from ccbench.harness import forbidden_modules; bad = forbidden_modules(); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
