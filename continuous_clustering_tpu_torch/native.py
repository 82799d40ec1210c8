"""Build and load the shared native host library (insertion engine, packet
decoders, slab readout) from ``continuous_clustering_tpu/native/src``.

The library is compiled at first use with plain ``g++`` (no cmake or ninja)
into ``continuous_clustering_tpu_torch/build/``.  The file name carries a
hash of the sources, so an edited source builds a new library, and the
output is written under a temporary name and renamed into place so that
concurrent test workers never load a half-written file.  The JAX package's
own ``native/lib`` is left alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from continuous_clustering_tpu.native import _declare

SRC_DIR = Path(__file__).resolve().parent.parent / "continuous_clustering_tpu" / "native" / "src"
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
