"""The port stands alone: no module of it imports ``jax`` or anything of the
JAX package ``continuous_clustering_tpu``, and none reads a path inside it.

The machine with the GPU has no JAX, and the port keeps its own copies of
what it shares with the JAX package (configuration, constants, point-cloud
schemas, synthetic scenes, the oracle, the C++ host sources).  So every
module of ``continuous_clustering_tpu_torch``, ``chip_smoke.py`` and the card's
timing script ``scripts/kernel_times.py`` must import in a process where
neither ``jax`` nor ``continuous_clustering_tpu`` (or any of its submodules)
enters ``sys.modules``, and no source of the port names the JAX package in
an import or a path.
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
JAX_PKG = "continuous_clustering_tpu"


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(continuous_clustering_tpu_torch.__path__,
                                              prefix="continuous_clustering_tpu_torch."))


def port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "scripts" / "kernel_times.py"]
    assert len(files) > 20
    return files


def test_every_port_module_imports_without_jax():
    mods = port_modules()
    for m in ("ops.cc_cuda", "ops.insertion", "ops.oracle", "models.checkpoint",
              "models.throughput", "tools.bench_setup", "config", "evaluation.synthetic",
              "parallel.multi_sensor", "utils.cli", "tools.multi_sensor_demo",
              "sensors.sensor_input", "sensors.velodyne", "sensors.velodyne_calibration",
              "sensors.ouster", "io.node", "io.transform_synchronizer", "io.publish_utils",
              "io.rosbag", "launch", "tools.rosbag_replay", "tools.make_minimal_rosbag",
              "tools.latency_bench", "tools.sensor_packets", "utils.stats", "utils.platform",
              "utils.profiling", "tools.make_synthetic_dataset", "evaluation.kitti_loader",
              "evaluation.euclidean_clustering", "evaluation.kitti_evaluation",
              "tools.gt_label_generator", "tools.kitti_demo", "io.evaluation_cloud",
              "tools.visualize", "tools.html_viewer", "tools.plot_workload",
              "parallel.halo", "parallel.mesh", "io.ros_bridge"):
        assert f"continuous_clustering_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import kernel_times\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', {JAX_PKG!r}))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_port_source_names_jax():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)
    offenders = [str(p.relative_to(ROOT)) for p in port_sources() if pat.search(p.read_text())]
    assert not offenders, offenders


def test_no_port_source_imports_or_reads_the_jax_package():
    """No import of ``continuous_clustering_tpu`` or a submodule, and no
    string that names its directory as a path segment (``"continuous_
    clustering_tpu"`` on its own, or ``continuous_clustering_tpu/`` outside
    a docstring reference to the reference's file and line, which the
    kernel table in ``chip_smoke.py`` reports)."""
    imp = re.compile(rf"^\s*(import|from)\s+{JAX_PKG}(\.|\s|$)", re.MULTILINE)
    seg = re.compile(rf"""["']{JAX_PKG}["']""")
    path_use = re.compile(rf"""(Path|open|join|glob)\([^)]*{JAX_PKG}[/"']""")
    offenders = []
    for p in port_sources():
        text = p.read_text()
        for what, pat in (("import", imp), ("path segment", seg), ("path", path_use)):
            if pat.search(text):
                offenders.append(f"{p.relative_to(ROOT)}: {what}")
    assert not offenders, offenders
    native = (PORT / "native.py").read_text()
    assert 'SRC_DIR = Path(__file__).resolve().parent / "csrc" / "host"' in native
    assert sorted(p.name for p in (PORT / "csrc" / "host").iterdir()) == [
        "decode_offload.cpp", "insertion.cpp", "kitti.cpp", "ouster.cpp", "readout.cpp",
        "runtime.hpp", "velodyne.cpp"]


# JAX package modules the port replaces under another name: the native
# library's ctypes declarations and build by ``native.py`` and the C++
# sources under ``csrc/host/``, the Pallas kernels by ``ops/cc_cuda.py``
REPLACED = {"native/__init__.py": "native.py", "native/build.py": "native.py",
            "ops/cc_pallas.py": "ops/cc_cuda.py"}


def test_every_jax_module_has_a_port_counterpart():
    """Every module of the JAX package has a port module under the same
    relative path, or is one of the declared replacements."""
    jax_root = ROOT / JAX_PKG
    missing = []
    for p in sorted(jax_root.rglob("*.py")):
        rel = p.relative_to(jax_root).as_posix()
        target = REPLACED.get(rel, rel)
        if not (PORT / target).is_file():
            missing.append(rel)
    assert not missing, missing
    assert all((ROOT / JAX_PKG / rel).is_file() for rel in REPLACED)
    assert (PORT / "csrc" / "host").is_dir()


def test_package_surface_matches_the_jax_package():
    """The port exports the names the JAX package exports, and its version."""
    import continuous_clustering_tpu as jax_pkg

    assert continuous_clustering_tpu_torch.__all__ == jax_pkg.__all__
    assert continuous_clustering_tpu_torch.__version__ == jax_pkg.__version__
    for name in jax_pkg.__all__:
        port_obj = getattr(continuous_clustering_tpu_torch, name)
        assert port_obj.__module__ == "continuous_clustering_tpu_torch.config", name
        assert port_obj.__name__ == getattr(jax_pkg, name).__name__
