"""Dense column-block ingest (port of ``continuous_clustering_tpu/ops/ingest.py``).

The native host insertion engine hands the device dense finished column
blocks; this op only places them in the ring.  With R >= 15 rows the host
ships one merged ``(N_MERGED_PLANES, B, R)`` i32 buffer per step (fields,
per-column segmentation poses and frontier scalars), so a step costs ONE
host-to-device copy; ``split_merged`` and ``unpack_block`` take it apart on
the device.  Below 15 rows a (B, R) plane cannot carry the (B, 15) pose
rows: the host ships an ``(N_SPLIT_PLANES, B, R)`` buffer of fields and
scalars (``split_fields``) and the poses as a second (B, 15) f32 buffer,
as the JAX facade's packed staging does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config

from .state import RingState, ring_put


class ColumnBlock(NamedTuple):
    """Host-inserted dense columns [gcol0, gcol0 + n_cols), planes (R, B)."""

    gcol0: torch.Tensor        # () i32
    n_cols: torch.Tensor       # () i32
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    distance: torch.Tensor
    azimuth: torch.Tensor
    inclination: torch.Tensor
    cont_az: torch.Tensor      # f32, origin-relative
    stamp_lo: torch.Tensor     # u32 bits in i32
    stamp_hi: torch.Tensor
    uidx_lo: torch.Tensor
    uidx_hi: torch.Tensor
    intensity: torch.Tensor    # i32
    firing_index: torch.Tensor  # i32
    prev_rearmost: torch.Tensor
    prev_foremost: torch.Tensor
    first_unfinished: torch.Tensor
    first_unpublished_init: torch.Tensor  # -1 if the frontier is initialized
    reset_required: torch.Tensor          # () bool


BLOCK_F32_FIELDS = ("x", "y", "z", "distance", "azimuth", "inclination",
                    "cont_az")
BLOCK_U32_FIELDS = ("stamp_lo", "stamp_hi", "uidx_lo", "uidx_hi")
BLOCK_I32_FIELDS = ("intensity", "firing_index")
N_BLOCK_FIELDS = len(BLOCK_F32_FIELDS) + len(BLOCK_U32_FIELDS) + len(BLOCK_I32_FIELDS)
# scalar order: gcol0, n_cols, prev_rearmost, prev_foremost,
# first_unfinished, first_unpublished_init, reset_required, (pad)
N_BLOCK_SCALARS = 8
# plane N_BLOCK_FIELDS lanes 0:15 carry the (B, 15) seg-pose matrix (f32
# bits), plane N_BLOCK_FIELDS + 1 column 0 lanes 0:8 the scalars; needs R >= 15
N_MERGED_PLANES = N_BLOCK_FIELDS + 2
MERGED_MIN_ROWS = 15
# any R: plane N_BLOCK_FIELDS, flattened, carries the scalars in lanes 0:8
# (B * R >= 8 for every step width the facade uses)
N_SPLIT_PLANES = N_BLOCK_FIELDS + 1


def split_merged(buf: torch.Tensor):
    """(fields (N_BLOCK_FIELDS, B, R), scalars (8,), seg poses (B, 15) f32)."""
    fields = buf[:N_BLOCK_FIELDS]
    segp = buf[N_BLOCK_FIELDS, :, :15].contiguous().view(torch.float32)
    scalars = buf[N_BLOCK_FIELDS + 1, 0, :N_BLOCK_SCALARS]
    return fields, scalars, segp


def split_fields(buf: torch.Tensor):
    """(fields (N_BLOCK_FIELDS, B, R), scalars (8,)) of an
    ``(N_SPLIT_PLANES, B, R)`` buffer."""
    return buf[:N_BLOCK_FIELDS], buf[N_BLOCK_FIELDS].reshape(-1)[:N_BLOCK_SCALARS]


def unpack_block(fields: torch.Tensor, scalars: torch.Tensor) -> ColumnBlock:
    """Rebuild a ColumnBlock from the packed planes (one transpose to (R, B))."""
    planes = fields.transpose(1, 2).contiguous()
    kw = {}
    for i, name in enumerate(BLOCK_F32_FIELDS):
        kw[name] = planes[i].view(torch.float32)
    off = len(BLOCK_F32_FIELDS)
    for i, name in enumerate(BLOCK_U32_FIELDS + BLOCK_I32_FIELDS):
        kw[name] = planes[off + i]
    return ColumnBlock(
        gcol0=scalars[0], n_cols=scalars[1],
        prev_rearmost=scalars[2], prev_foremost=scalars[3],
        first_unfinished=scalars[4], first_unpublished_init=scalars[5],
        reset_required=scalars[6] != 0,
        **kw,
    )


def ingest_columns(config: Config, state: RingState, block: ColumnBlock,
                   batch_size: int) -> RingState:
    """Write the block's valid columns into the ring (in place) and advance
    the frontier scalars."""
    R, rc, B = state.num_rows, state.ring_cols, batch_size
    dev = state.device
    ar = torch.arange(B, dtype=torch.int32, device=dev)
    cols = block.gcol0 + ar
    wmask = (ar < block.n_cols)[None, :].expand(R, B)
    gcol_vals = torch.where(
        torch.isnan(block.distance), -1, cols[None, :].expand(R, B)
    ).to(torch.int32)
    lc0 = block.gcol0 % rc

    for name in BLOCK_F32_FIELDS + BLOCK_U32_FIELDS + BLOCK_I32_FIELDS:
        ring_put(getattr(state, name), lc0, wmask, getattr(block, name))
    ring_put(state.gcol, lc0, wmask, gcol_vals)

    fu_init = block.first_unpublished_init
    state.first_unpublished = torch.where(
        state.first_unpublished == -1, fu_init, state.first_unpublished)
    state.ring_start = torch.where(state.ring_start == -1, fu_init, state.ring_start)
    state.prev_rearmost = torch.maximum(state.prev_rearmost, block.prev_rearmost)
    state.prev_foremost = torch.maximum(state.prev_foremost, block.prev_foremost)
    state.first_unfinished = torch.maximum(state.first_unfinished, block.first_unfinished)
    state.ring_end = torch.maximum(state.ring_end, block.prev_foremost)
    state.reset_required = state.reset_required | block.reset_required
    return state
