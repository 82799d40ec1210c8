"""Device-resident ring-buffer state (port of ``continuous_clustering_tpu/ops/state.py``).

One ``(num_rows, ring_columns)`` tensor per cell field, the K-slot component
table and the pipeline scalars, with the same names and meanings as the JAX
``RingState``.  Differences:

* the u32 fields (``stamp_*``, ``uidx_*``) are stored as int32 bit patterns
  (torch has few uint32 ops); ``convert.py`` reinterprets them;
* the ring and table tensors are updated IN PLACE (``ring_write`` uses
  ``index_copy_``), which saves a whole-ring copy per field per step.  The
  scalars are replaced, never mutated.  Anything a caller keeps across
  steps must therefore be a copy (gathers are), never a view of the state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..config import Config

I32_MAX = 2**31 - 1
# 0xFFFFFFFF as an int32 bit pattern
U32_ALL_ONES = -1


@dataclasses.dataclass
class RingState:
    # geometry
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    distance: torch.Tensor       # f32, NaN = empty cell
    azimuth: torch.Tensor
    inclination: torch.Tensor
    cont_az: torch.Tensor        # f32, relative to origin_rot rotations
    gcol: torch.Tensor           # i32 global column index, -1 = empty
    stamp_lo: torch.Tensor       # u32 bits in i32
    stamp_hi: torch.Tensor
    uidx_lo: torch.Tensor
    uidx_hi: torch.Tensor
    intensity: torch.Tensor      # i32
    firing_index: torch.Tensor   # i32
    # ground segmentation outputs
    ground_label: torch.Tensor   # i32
    debug_label: torch.Tensor    # i32
    is_ignored: torch.Tensor     # bool
    # association
    slot: torch.Tensor           # i32 component-table index, -1 = none
    finish_az: torch.Tensor      # f32
    # profiling counters, written when clustering.record_neighbor_stats:
    # low 16 bits the visited-neighbour count (reference …cpp:725), high 16
    # the edges found (ops/association.py::neighbor_stats)
    nbr_stats: torch.Tensor      # i32
    # component table, shape (K,)
    slot_parent: torch.Tensor
    slot_live: torch.Tensor
    slot_valid: torch.Tensor
    slot_finished: torch.Tensor
    slot_cid: torch.Tensor
    slot_finish: torch.Tensor
    slot_gmin: torch.Tensor
    slot_gmax: torch.Tensor
    slot_count: torch.Tensor
    slot_rep: torch.Tensor
    # scalars, shape ()
    prev_rearmost: torch.Tensor
    prev_foremost: torch.Tensor
    first_unfinished: torch.Tensor
    ring_start: torch.Tensor
    ring_end: torch.Tensor
    first_unpublished: torch.Tensor
    clear_bound: torch.Tensor
    clear_target: torch.Tensor
    cluster_counter: torch.Tensor
    origin_rot: torch.Tensor
    reset_required: torch.Tensor
    overflow: torch.Tensor
    cc_failed: torch.Tensor
    # ground segmentation cross-column carry, (R,) f32
    incl_diffs: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.x.shape[0]

    @property
    def ring_cols(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device


CLEAR_VALUES = {
    "x": float("nan"), "y": float("nan"), "z": float("nan"),
    "distance": float("nan"), "azimuth": float("nan"),
    "inclination": float("nan"), "cont_az": float("nan"),
    "gcol": -1, "stamp_lo": 0, "stamp_hi": 0,
    "uidx_lo": U32_ALL_ONES, "uidx_hi": U32_ALL_ONES,
    "intensity": 0, "firing_index": 0,
    "ground_label": 0, "debug_label": 0, "is_ignored": False,
    "slot": -1, "finish_az": 0.0, "nbr_stats": 0,
}
CELL_FIELDS = tuple(CLEAR_VALUES)
U32_FIELDS = ("stamp_lo", "stamp_hi", "uidx_lo", "uidx_hi")
F32_CELL_FIELDS = ("x", "y", "z", "distance", "azimuth", "inclination",
                   "cont_az", "finish_az")


def _cell_dtype(name: str) -> torch.dtype:
    if name in F32_CELL_FIELDS:
        return torch.float32
    if name == "is_ignored":
        return torch.bool
    return torch.int32


def init_state(config: Config, num_rows: int, device) -> RingState:
    """Allocate and clear the ring buffer on ``device``."""
    rc = config.ring_buffer_max_columns
    K = config.clustering.max_active_components
    shape = (num_rows, rc)

    def full(v, dtype, shp=shape):
        return torch.full(shp, v, dtype=dtype, device=device)

    def scalar(v, dtype=torch.int32):
        return torch.tensor(v, dtype=dtype, device=device)

    cells = {n: full(v, _cell_dtype(n)) for n, v in CLEAR_VALUES.items()}
    return RingState(
        **cells,
        slot_parent=torch.arange(K, dtype=torch.int32, device=device),
        slot_live=full(False, torch.bool, (K,)),
        slot_valid=full(False, torch.bool, (K,)),
        slot_finished=full(False, torch.bool, (K,)),
        slot_cid=full(0, torch.int32, (K,)),
        slot_finish=full(-math.inf, torch.float32, (K,)),
        slot_gmin=full(I32_MAX, torch.int32, (K,)),
        slot_gmax=full(-1, torch.int32, (K,)),
        slot_count=full(0, torch.int32, (K,)),
        slot_rep=full(-1, torch.int32, (K,)),
        prev_rearmost=scalar(0),
        prev_foremost=scalar(-1),
        first_unfinished=scalar(-1),
        ring_start=scalar(-1),
        ring_end=scalar(-1),
        first_unpublished=scalar(-1),
        clear_bound=scalar(-1),
        clear_target=scalar(-1),
        cluster_counter=scalar(1),
        origin_rot=scalar(0),
        reset_required=scalar(False, torch.bool),
        overflow=scalar(False, torch.bool),
        cc_failed=scalar(False, torch.bool),
        incl_diffs=full(float("nan"), torch.float32, (num_rows,)),
    )


def copy_state(state: RingState) -> RingState:
    """A copy of every tensor of ``state`` (the ops update states in place)."""
    return RingState(**{f.name: getattr(state, f.name).clone()
                        for f in dataclasses.fields(state)})


def ring_index(lcol0, width: int, rc: int, device) -> torch.Tensor:
    """Ring positions ``(lcol0 + arange(width)) % rc``; ``lcol0`` may be an
    int or a 0-d device tensor (no host sync either way)."""
    return (lcol0 + torch.arange(width, dtype=torch.int64, device=device)) % rc


def ring_read(arr: torch.Tensor, lcol0, width: int) -> torch.Tensor:
    """Copy of ``width`` consecutive ring columns starting at ``lcol0`` (mod rc)."""
    return arr[:, ring_index(lcol0, width, arr.shape[1], arr.device)]


def ring_write(arr: torch.Tensor, lcol0, vals: torch.Tensor) -> torch.Tensor:
    """Overwrite ``vals.shape[1]`` consecutive ring columns starting at
    ``lcol0`` (mod rc), IN PLACE; returns ``arr``."""
    idx = ring_index(lcol0, vals.shape[1], arr.shape[1], arr.device)
    return arr.index_copy_(1, idx, vals.to(arr.dtype))


def ring_put(arr: torch.Tensor, lcol0, mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Masked in-place write: cells where ``mask`` holds take ``vals``."""
    cur = ring_read(arr, lcol0, vals.shape[1])
    return ring_write(arr, lcol0, torch.where(mask, vals.to(arr.dtype), cur))


def clear_columns_chunk(
    state: RingState, cleared_to: torch.Tensor, target: torch.Tensor, width: int
) -> Tuple[RingState, torch.Tensor]:
    """Clear at most ``width`` ring columns in [cleared_to, target), gated on
    each cell's stored gcol (see the JAX docstring), IN PLACE; returns
    (state, new cleared_to)."""
    dev = state.device
    n = torch.clamp(target - cleared_to, 0, width)
    lc0 = torch.clamp_min(cleared_to, 0) % state.ring_cols
    ar = torch.arange(width, dtype=torch.int32, device=dev)
    expected = cleared_to + ar
    gcol_cur = ring_read(state.gcol, lc0, width)
    mask = (ar < n)[None, :] & (gcol_cur <= expected[None, :])
    for name, value in CLEAR_VALUES.items():
        arr = getattr(state, name)
        ring_put(arr, lc0, mask, torch.full_like(mask, value, dtype=arr.dtype))
    return state, (cleared_to + n).to(torch.int32)


def rebase_azimuth(state: RingState, rotations: int) -> Tuple[RingState, int]:
    """Shift all stored continuous azimuths down by ``rotations`` full turns
    (in place for the ring and table); returns (state, rotations)."""
    shift = float(np.float32(2.0 * math.pi) * np.float32(rotations))
    state.cont_az.sub_(shift)
    state.finish_az.sub_(shift)
    state.slot_finish.copy_(
        torch.where(state.slot_valid, state.slot_finish - shift, state.slot_finish)
    )
    state.origin_rot = (state.origin_rot + rotations).to(torch.int32)
    return state, rotations
