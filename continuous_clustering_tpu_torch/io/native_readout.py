"""Native publish-path assembly: packed slab -> structured cloud in C++
(port of ``continuous_clustering_tpu/io/native_readout.py`` on the port's
library loader).

The layout check runs after the library is built, and only a passing check
is remembered: a failed probe is never cached.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from .point_cloud import POINT_DTYPE

from .. import native
from ..ops.readout import FETCH_ORDER, N_SLAB_ROWS, slab_rows

# slab row order compiled into readout.cpp (enum SlabRow, v3 layout); the
# nbr_stats row is optional and trails
_EXPECTED_ORDER = (
    "x", "y", "z", "distance", "azimuth", "inclination", "cont_az",
    "finish_az", "stamp_lo", "stamp_hi", "uidx_lo", "uidx_hi", "pk8",
    "firing_index", "slot",
)
LAYOUT_VERSION = 3
_CHECKED = False


def _lib() -> ctypes.CDLL:
    """The native library, with its slab layout checked against this port's."""
    global _CHECKED
    lib = native.load()
    if not _CHECKED:
        version = int(lib.cct_readout_layout_version()) if hasattr(
            lib, "cct_readout_layout_version") else -1
        if (version != LAYOUT_VERSION or FETCH_ORDER != _EXPECTED_ORDER
                or N_SLAB_ROWS != len(_EXPECTED_ORDER)
                or int(lib.cct_readout_record_size()) != POINT_DTYPE.itemsize):
            raise RuntimeError(
                f"native readout layout mismatch: library version {version}, "
                f"expected {LAYOUT_VERSION} with rows {_EXPECTED_ORDER}")
        _CHECKED = True
    return lib


def _prep(slab: np.ndarray, tabs: np.ndarray):
    if (slab.dtype != np.int32 or slab.ndim != 3
            or slab.shape[0] not in (slab_rows(False), slab_rows(True))):
        raise ValueError(f"slab must be ({N_SLAB_ROWS} or {slab_rows(True)}, R, W) int32, "
                         f"got {slab.dtype} {slab.shape}")
    tabs = np.ascontiguousarray(tabs, dtype=np.int32)
    if tabs.ndim != 2 or tabs.shape[0] != 2:
        raise ValueError(f"join tables must be (2, K), got {tabs.shape}")
    return np.ascontiguousarray(slab), tabs


def assemble_cloud(slab: np.ndarray, tabs: np.ndarray, off: int, n: int,
                   from_gcol: int, rc: int, origin_az: float) -> np.ndarray:
    """All cells of slab columns [off, off + n) as a CONTINUOUS_CLUSTERING
    stage cloud, flattened column-major."""
    lib = _lib()
    slab, tabs = _prep(slab, tabs)
    n_rows, R, W = slab.shape
    if off < 0 or off + n > W:
        raise ValueError(f"columns [{off}, {off + n}) outside the slab's {W}")
    out = np.empty(R * n, dtype=POINT_DTYPE)
    lib.cct_assemble_cloud(
        slab.ctypes.data_as(ctypes.c_void_p), n_rows, R, W,
        tabs.ctypes.data_as(ctypes.c_void_p), tabs.shape[1], off, n,
        from_gcol, rc, float(origin_az), out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def emit_clusters(
    slab: np.ndarray, tabs: np.ndarray, off: int, n: int, from_gcol: int,
    rc: int, origin_az: float, counter_old: int, counter_new: int,
    use_last_stamp: bool,
) -> Tuple[List[Tuple[np.ndarray, int]], Optional[np.ndarray]]:
    """New finished clusters with ids in [counter_old, counter_new) and more
    than 20 points, id-ascending as (records, stamp ns); plus the whole
    window as a cloud when the C++ assembled it anyway, else None."""
    lib = _lib()
    slab, tabs = _prep(slab, tabs)
    n_rows, R, W = slab.shape
    if off < 0 or off + n > W:
        raise ValueError(f"columns [{off}, {off + n}) outside the slab's {W}")
    max_groups = R * n // 21 + 2
    records = np.empty(R * n, dtype=POINT_DTYPE)
    full = np.empty(R * n, dtype=POINT_DTYPE)
    group_off = np.empty(max_groups, dtype=np.int64)
    group_stamp = np.empty(max_groups, dtype=np.uint64)
    was_dense = ctypes.c_int32(0)
    n_groups = lib.cct_emit_clusters(
        slab.ctypes.data_as(ctypes.c_void_p), n_rows, R, W,
        tabs.ctypes.data_as(ctypes.c_void_p), tabs.shape[1], off, n,
        from_gcol, rc, float(origin_az), counter_old, counter_new,
        1 if use_last_stamp else 0,
        records.ctypes.data_as(ctypes.c_void_p),
        group_off.ctypes.data_as(ctypes.c_void_p),
        group_stamp.ctypes.data_as(ctypes.c_void_p),
        full.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(was_dense),
    )
    groups = [(records[group_off[g]:group_off[g + 1]], int(group_stamp[g]))
              for g in range(n_groups)]
    return groups, (full if was_dense.value else None)
