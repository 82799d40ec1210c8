"""Host-side insertion (port of ``continuous_clustering_tpu/models/host_insertion.py``).

The native C++ engine (``native/src/insertion.cpp``) builds the continuous
range image on the host and hands the device dense finished column blocks.
This wrapper returns numpy staging buffers; the facade uploads them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config

from .. import native
from ..ops.ingest import N_BLOCK_FIELDS, N_BLOCK_SCALARS

TWO_PI = 2.0 * math.pi
# np.float32 NaN bit pattern (padding of the packed fetch)
_NAN_BITS = np.float32(np.nan).view(np.int32)


class HostInsertion:
    """ctypes wrapper owning a native insertion engine."""

    def __init__(self, config: Config, num_rows: int):
        self.lib = native.load()
        self.config = config
        self.R = num_rows
        self.handle = self.lib.cct_insertion_create(
            num_rows,
            config.range_image.num_columns,
            config.range_image.ring_buffer_revolutions,
            1 if config.range_image.sensor_is_clockwise else 0,
        )
        self.prev_foremost = -1
        self.fu_init = -1
        self._poses = np.zeros((0, 3, 4), np.float64)

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.cct_insertion_destroy(self.handle)
            self.handle = None

    def __del__(self):
        self.close()

    def add_firings(
        self, firings: List[Dict[str, np.ndarray]], poses: List[np.ndarray]
    ) -> Tuple[int, int, bool]:
        """Returns (first_finished, end_finished, reset_required)."""
        F, R = len(firings), self.R
        xyz = np.full((F, R, 3), np.nan, np.float32)
        stamps = np.zeros((F, R), np.uint64)
        uidx = np.full((F, R), np.iinfo(np.uint64).max, np.uint64)
        inten = np.zeros((F, R), np.uint8)
        pose_arr = np.zeros((F, 3, 4), np.float64)
        for i, (f, p) in enumerate(zip(firings, poses)):
            xyz[i] = f["xyz"]
            if "stamp" in f:
                stamps[i] = f["stamp"]
            if "uidx" in f:
                uidx[i] = f["uidx"]
            if "intensity" in f:
                inten[i] = f["intensity"]
            pose_arr[i] = p[:3, :]
        self._poses = pose_arr
        first = ctypes.c_int64()
        reset = ctypes.c_int32()
        end = self.lib.cct_insertion_add_firings(
            self.handle, F,
            xyz.ctypes.data_as(ctypes.c_void_p),
            pose_arr.ctypes.data_as(ctypes.c_void_p),
            stamps.ctypes.data_as(ctypes.c_void_p),
            uidx.ctypes.data_as(ctypes.c_void_p),
            inten.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(first), ctypes.byref(reset),
        )
        return int(first.value), int(end), bool(reset.value)

    def fetch_block_packed(
        self, first: int, end: int, B: int, origin_rot: int, reset: bool,
        out: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fetch columns [first, min(end, first + B)) into the leading
        N_BLOCK_FIELDS (B, R) i32 planes of ``out``; returns (fields,
        scalars (N_BLOCK_SCALARS,) i32, trigger poses (n, 3, 4))."""
        R = self.R
        n = min(end - first, B) if end > first else 0
        fields = out[:N_BLOCK_FIELDS]
        if fields.shape != (N_BLOCK_FIELDS, B, R) or fields.dtype != np.int32:
            raise ValueError(f"staging buffer must be ({N_BLOCK_FIELDS}, {B}, {R}) int32")
        # the native fetch writes the six f32 fields in place into planes 0..5
        caz = np.full((B, R), np.nan, np.float64)
        stamp = np.zeros((B, R), np.uint64)
        uidxv = np.full((B, R), np.iinfo(np.uint64).max, np.uint64)
        inten = np.zeros((B, R), np.uint8)
        pose_idx = np.zeros(B, np.int32)
        if n > 0:
            self.lib.cct_insertion_fetch_columns(
                self.handle, first, first + n,
                *[fields[k].ctypes.data_as(ctypes.c_void_p) for k in range(6)],
                caz.ctypes.data_as(ctypes.c_void_p),
                stamp.ctypes.data_as(ctypes.c_void_p),
                uidxv.ctypes.data_as(ctypes.c_void_p),
                inten.ctypes.data_as(ctypes.c_void_p),
                pose_idx.ctypes.data_as(ctypes.c_void_p),
            )
        fields[0:6, n:] = _NAN_BITS
        fields[6] = (caz - TWO_PI * origin_rot).astype(np.float32).view(np.int32)
        fields[7] = (stamp & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        fields[8] = (stamp >> np.uint64(32)).astype(np.uint32).view(np.int32)
        fields[9] = (uidxv & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        fields[10] = (uidxv >> np.uint64(32)).astype(np.uint32).view(np.int32)
        fields[11] = inten
        fields[12] = np.maximum(pose_idx, 0)[:, None]
        scalars = np.zeros(N_BLOCK_SCALARS, np.int32)
        scalars[0] = first
        scalars[1] = n
        scalars[2] = max(end, 0)
        scalars[3] = max(end, self.prev_foremost)
        scalars[4] = first + n
        scalars[5] = self.fu_init if self.fu_init >= 0 else first
        scalars[6] = int(reset)
        poses = self._poses[np.clip(pose_idx[:n], 0, max(len(self._poses) - 1, 0))]
        if self.fu_init < 0 and n > 0:
            self.fu_init = first
        return fields, scalars, poses

    def clear_before(self, keep_from: int) -> None:
        if keep_from > 0:
            self.lib.cct_insertion_clear_before(self.handle, keep_from)
