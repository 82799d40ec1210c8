"""Build and load the native host library (insertion engine, packet
decoders, slab readout) from the port's C++ sources in ``csrc/host``.

The library is compiled at first use with plain ``g++`` (no cmake or ninja)
into ``continuous_clustering_tpu_torch/build/``.  The file name carries a
hash of the sources, so an edited source builds a new library, and the
output is written under a temporary name and renamed into place so that
concurrent test workers never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None


def sources_digest(paths) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def compile_atomic(cmd_prefix, out: Path, cmd_suffix=()) -> None:
    """Run ``cmd_prefix + ['-o', tmp] + cmd_suffix`` and rename tmp to ``out``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run(
        list(cmd_prefix) + ["-o", str(tmp)] + list(cmd_suffix),
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build of {out.name} failed:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)


def library_path() -> Path:
    srcs = sorted(SRC_DIR.glob("*.cpp"))
    return BUILD_DIR / f"libcct_native-{sources_digest(srcs + sorted(SRC_DIR.glob('*.hpp')))}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("native library cannot be built: g++ not found")
        srcs = [str(p) for p in sorted(SRC_DIR.glob("*.cpp"))]
        compile_atomic([cxx] + _CXX_FLAGS + srcs, out, ["-lpthread"])
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first call.  Raises RuntimeError when it
    cannot be built: the port has no pure-Python insertion fallback."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _LIB = lib
    return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.cct_insertion_create.restype = c.c_void_p
    lib.cct_insertion_create.argtypes = [c.c_int, c.c_int, c.c_int, c.c_int]
    lib.cct_insertion_destroy.argtypes = [c.c_void_p]
    lib.cct_insertion_add_firings.restype = c.c_int64
    lib.cct_insertion_add_firings.argtypes = [
        c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.c_int32),
    ]
    lib.cct_insertion_fetch_columns.argtypes = [c.c_void_p, c.c_int64, c.c_int64] + [c.c_void_p] * 11
    lib.cct_insertion_clear_before.argtypes = [c.c_void_p, c.c_int64]
    lib.cct_insertion_reset.argtypes = [c.c_void_p]

    lib.cct_generate_range_image.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_void_p
    ]
    lib.cct_recover_laser_indices.restype = c.c_int32
    lib.cct_recover_laser_indices.argtypes = [c.c_int64, c.c_void_p, c.c_int, c.c_void_p]

    lib.cct_velodyne_create.restype = c.c_void_p
    lib.cct_velodyne_create.argtypes = [
        c.c_int, c.c_float, c.c_void_p, c.c_void_p, c.c_void_p, c.c_double
    ]
    lib.cct_velodyne_set_corrections.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p,
    ]
    lib.cct_velodyne_destroy.argtypes = [c.c_void_p]
    lib.cct_velodyne_decode.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_uint64]
    lib.cct_velodyne_poll.restype = c.c_int
    lib.cct_velodyne_poll.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p]

    lib.cct_ouster_create.restype = c.c_void_p
    lib.cct_ouster_create.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_double,
        c.c_void_p, c.c_void_p,
    ]
    lib.cct_ouster_destroy.argtypes = [c.c_void_p]
    lib.cct_ouster_decode.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_uint64]
    lib.cct_ouster_poll.restype = c.c_int
    lib.cct_ouster_poll.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p]

    lib.cct_offload_create.restype = c.c_void_p
    lib.cct_offload_create.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.cct_offload_destroy.argtypes = [c.c_void_p]
    lib.cct_offload_enqueue.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_uint64]
    lib.cct_offload_pending.restype = c.c_int64
    lib.cct_offload_pending.argtypes = [c.c_void_p]
    lib.cct_offload_drain.argtypes = [c.c_void_p]
    lib.cct_offload_poll.restype = c.c_int
    lib.cct_offload_poll.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p]

    lib.cct_readout_record_size.restype = c.c_int64
    lib.cct_readout_record_size.argtypes = []
    if hasattr(lib, "cct_readout_layout_version"):
        lib.cct_readout_layout_version.restype = c.c_int64
        lib.cct_readout_layout_version.argtypes = []
    lib.cct_assemble_cloud.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_void_p, c.c_int64,
        c.c_int64, c.c_int64, c.c_int64, c.c_int64, c.c_double, c.c_void_p,
    ]
    lib.cct_emit_clusters.restype = c.c_int64
    lib.cct_emit_clusters.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_void_p, c.c_int64,
        c.c_int64, c.c_int64, c.c_int64, c.c_int64, c.c_double, c.c_int64,
        c.c_int64, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.POINTER(c.c_int32),
    ]
