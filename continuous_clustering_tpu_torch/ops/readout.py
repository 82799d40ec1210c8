"""Packed per-cell readout (port of ``continuous_clustering_tpu/ops/readout.py``).

All publish fields of a column range ride ONE (n_rows, R, W) i32 slab, in
the v3 layout that ``native/src/readout.cpp`` reads: f32 and u32 planes
reinterpreted as i32, the four byte-range fields packed into one ``pk8``
row, ``gcol`` derived on the host.  The ``nbr_stats`` row trails only when
``record_neighbor_stats`` is on: consumers key on the row count.  The
cluster-id join uses the (2, K) ``join_tables``.
"""

from __future__ import annotations

import numpy as np
import torch

from .state import RingState, ring_index

FETCH_F32 = ("x", "y", "z", "distance", "azimuth", "inclination",
             "cont_az", "finish_az")
FETCH_U32 = ("stamp_lo", "stamp_hi", "uidx_lo", "uidx_hi")
FETCH_ORDER = FETCH_F32 + FETCH_U32 + ("pk8", "firing_index", "slot")
N_SLAB_ROWS = len(FETCH_ORDER)            # without the optional nbr_stats row


def slab_rows(with_nbr: bool) -> int:
    return N_SLAB_ROWS + 1 if with_nbr else N_SLAB_ROWS


def join_tables(state: RingState) -> torch.Tensor:
    """(2, K) i32: cluster id and representative glid per resolved slot."""
    parent = state.slot_parent.long()
    return torch.stack([state.slot_cid[parent], state.slot_rep[parent]])


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int32)


def packed_readout(state: RingState, lc0, width: int, with_nbr: bool = False) -> torch.Tensor:
    """``width`` ring columns from local column ``lc0`` as a packed
    (slab_rows(with_nbr), R, width) i32 slab (a copy, never a view of the
    ring)."""
    idx = ring_index(lc0, width, state.ring_cols, state.device)

    def col(name):
        return _as_i32(getattr(state, name).index_select(1, idx))

    raw = torch.stack([col(f) for f in FETCH_F32 + FETCH_U32])
    pk8 = (torch.clamp(col("intensity"), 0, 255)
           | ((col("ground_label") & 0xFF) << 8)
           | ((col("debug_label") & 0xFF) << 16)
           | (col("is_ignored") << 24))
    rows = [raw, pk8[None], col("firing_index")[None], col("slot")[None]]
    if with_nbr:
        rows.append(col("nbr_stats")[None])
    return torch.cat(rows)


def unpack_slab(slab: np.ndarray, off: int, n: int, from_gcol: int, tabs: np.ndarray):
    """Host-side per-field views of slab columns [off, off + n) with the
    component-slot join applied through ``tabs`` ((2, K) numpy)."""
    out = {}
    for i, f in enumerate(FETCH_F32 + FETCH_U32):
        a = np.ascontiguousarray(slab[i, :, off:off + n])
        out[f] = a.view(np.float32) if f in FETCH_F32 else a.view(np.uint32)
    base = len(FETCH_F32) + len(FETCH_U32)
    pk8 = slab[base, :, off:off + n]
    out["intensity"] = pk8 & 0xFF
    out["ground_label"] = (pk8 >> 8) & 0xFF
    out["debug_label"] = (pk8 >> 16) & 0xFF
    out["is_ignored"] = (pk8 >> 24) & 0xFF
    out["firing_index"] = np.ascontiguousarray(slab[base + 1, :, off:off + n])
    slot = slab[base + 2, :, off:off + n]
    has = slot >= 0
    slot0 = np.maximum(slot, 0)
    out["slot"] = slot
    out["cell_cid"] = np.where(has, tabs[0][slot0], 0)
    out["cell_rep"] = np.where(has, tabs[1][slot0], -1)
    out["nbr_stats"] = (np.ascontiguousarray(slab[base + 3, :, off:off + n])
                        if slab.shape[0] > N_SLAB_ROWS else np.zeros_like(pk8))
    # gcol is not transmitted: ingest writes the column index for every cell
    # holding data and -1 for NaN-distance cells
    gcols = from_gcol + np.arange(n, dtype=np.int64)[None, :]
    out["gcol"] = np.where(np.isnan(out["distance"]), np.int64(-1), gcols).astype(np.int64)
    return out
