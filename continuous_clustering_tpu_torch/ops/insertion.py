"""Device insertion: continuous range image construction from firings (port
of ``continuous_clustering_tpu/ops/insertion.py``).

Re-derives the reference's per-firing insertion
(``src/clustering/continuous_clustering.cpp:105-292``) over a batch of
firings.  Each firing is vectorized over the laser rows (azimuth/column
unwrap, collision shift, nearer-point priority); only the rotation-unwrap
recurrence (rearmost/foremost laser tracking) and the cell occupancy are
sequential, exactly as in the reference:

* azimuth is computed in the sensor frame (…cpp:142), distance and
  inclination from the odom-relative vector (…cpp:189,232);
* a point landing on an occupied cell first tries the next column
  (…cpp:190-202) and is dropped if the cell holds a nearer point (…cpp:205);
  dropped points do not update the rearmost/foremost tracking;
* points behind the already-finished frontier are counted for unwrap
  purposes but not written (…cpp:208-238);
* a first firing spanning more than half a rotation flags a reset
  (…cpp:252-260) and later firings of the batch are ignored.

Layout: everything that does not depend on the carry (the pose transform,
distance, azimuth, inclination, the column within the rotation) is computed
for all F firings at once.  The firing loop (``claim_firings``) carries the
frontier scalars as 0-d tensors and commits each firing's accepted claims
into a distance plane in place (free cell = NaN); it never reads a value
back to the host, and it reads and writes no other ring field.  Then one
batched write (``apply_claims``) puts the other fields of each cell's
winner, the accepted write with the final distance (every accepted
overwrite is strictly nearer than its predecessor, …cpp:205).
``insert_firings`` runs both on one state; the column-sharded step
(``parallel/halo.py``) runs the loop on a distance plane gathered from the
shards and routes each winner to the shard that owns its column.  The JAX
version's groups of 8 firings per scan iteration are a TPU lowering device
and change nothing in the result.

Rounding, so that the CPU and the card agree bit for bit and the port
equals the JAX package's CPU build wherever it can:

* ``arctan2``, ``arcsin`` and ``sqrt`` are evaluated in f64 and rounded once
  to f32; XLA's f32 arctan2 and arcsin are up to 1 and 2 ulp from that;
* the pose transform, the distance and the continuous azimuth are the JAX
  expressions elementwise (no matmul, so no TF32), with each multiply-add
  that XLA's CPU compiler fuses into one fused multiply-add evaluated by
  ``fma32``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..utils.stats import to_device
from .state import I32_MAX, RingState

I32_MIN = -(2**31)


class FiringBatch(NamedTuple):
    """A batch of F firings with R rows each (host-assembled)."""

    xyz: torch.Tensor           # (F, R, 3) f32 sensor frame, NaN = missing
    pose: torch.Tensor          # (F, 3, 4) f32 odom_from_sensor
    stamp_lo: torch.Tensor      # (F, R) u32 bits in i32
    stamp_hi: torch.Tensor
    uidx_lo: torch.Tensor
    uidx_hi: torch.Tensor
    intensity: torch.Tensor     # (F, R) i32
    firing_index: torch.Tensor  # (F,) i32
    valid: torch.Tensor         # (F,) bool, padding mask


def make_firing_batch(firings, poses, size: int, num_rows: int, device) -> FiringBatch:
    """The firing batch of ``firings`` (point-cloud dicts: ``xyz`` and, where
    present, ``stamp``, ``uidx``, ``intensity``, ``firing_index``) with their
    ``odom_from_sensor`` ``poses`` (4, 4), on ``device``, padded to ``size``
    firings; padding firings are invalid and carry the identity pose."""
    F, R = size, num_rows
    xyz = np.full((F, R, 3), np.nan, np.float32)
    stamp = np.zeros((F, R), np.uint64)
    uidx = np.full((F, R), np.iinfo(np.uint64).max, np.uint64)
    inten = np.zeros((F, R), np.int32)
    fidx = np.zeros((F,), np.int32)
    pose_arr = np.tile(np.eye(4)[:3], (F, 1, 1)).astype(np.float32)
    for i, (f, pose) in enumerate(zip(firings, poses)):
        xyz[i] = f["xyz"]
        if "stamp" in f:
            stamp[i] = f["stamp"]
        if "uidx" in f:
            uidx[i] = f["uidx"]
        if "intensity" in f:
            inten[i] = f["intensity"]
        fidx[i] = f.get("firing_index", 0)
        pose_arr[i] = pose[:3, :]

    def u32(a):
        return (a & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)

    def put(a):
        return to_device(np.ascontiguousarray(a), device)

    return FiringBatch(
        xyz=put(xyz), pose=put(pose_arr),
        stamp_lo=put(u32(stamp)), stamp_hi=put(u32(stamp >> np.uint64(32))),
        uidx_lo=put(u32(uidx)), uidx_hi=put(u32(uidx >> np.uint64(32))),
        intensity=put(inten), firing_index=put(fidx),
        valid=put(np.arange(F) < len(firings)),
    )


class InsertResult(NamedTuple):
    state: RingState
    rearmost_per_firing: torch.Tensor  # (F,) i32: prev_rearmost after each firing


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the f64
    product of two f32 values is exact and the f64 sum is rounded to f32 (a
    double rounding differs from the true FMA about once in 2**29 inputs).
    Elementwise on both devices, so the CPU and the card agree."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def f64_round(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn`` of f32 tensors evaluated in f64 and rounded once to f32."""
    return fn(*[a.to(torch.float64) for a in args]).to(torch.float32)


CARRIED = ("prev_rearmost", "prev_foremost", "first_unfinished", "ring_start", "ring_end",
           "first_unpublished", "reset_required")


class Claims(NamedTuple):
    """What the firing loop decided for a batch of F firings of R rows: each
    point's claimed cell, whether its values go there, the values, and the
    carried scalars after the batch."""

    row: torch.Tensor      # (F * R,) i64 laser row of each point
    lcol: torch.Tensor     # (F * R,) i64 ring column it claimed (0 if it claimed none)
    winner: torch.Tensor   # (F * R,) bool: its values are its cell's final ones
    values: Dict[str, torch.Tensor]   # cell field -> (F * R,) value of each point
    scalars: Dict[str, torch.Tensor]  # ``CARRIED`` -> the scalar after the batch
    rearmost_per_firing: torch.Tensor  # (F,) i32: prev_rearmost after each firing


def insert_firings(config: Config, state: RingState, batch: FiringBatch) -> InsertResult:
    """Insert a batch of firings into the ring (in place); returns the state
    and ``prev_rearmost`` after each firing (-1 before the first data).
    ``claim_firings`` on the state's own ``distance``, then ``apply_claims``."""
    claims = claim_firings(config, state, state.distance, batch)
    apply_claims(state, claims)
    for name, t in claims.scalars.items():
        setattr(state, name, t)
    return InsertResult(state=state, rearmost_per_firing=claims.rearmost_per_firing)


def claim_firings(config: Config, state: RingState, dist: torch.Tensor,
                  batch: FiringBatch) -> Claims:
    """The sequential firing loop and the winner selection.  ``dist`` is the
    whole ring's (R, rc) distance plane, NaN = free; the loop commits each
    firing's accepted claims into it in place.  Reads the carried scalars
    and ``origin_rot`` of ``state`` and nothing else of it; writes no other
    field."""
    num_cols = config.range_image.num_columns
    rc = config.ring_buffer_max_columns
    half = num_cols // 2
    R = dist.shape[0]
    F = batch.xyz.shape[0]
    dev = dist.device
    az_width = to_device(2.0 * math.pi / num_cols, dev, torch.float32)
    pi32 = to_device(math.pi, dev, torch.float32)
    inf = float("inf")
    rows = torch.arange(R, device=dev)

    # ---- carry-independent per-point values, all firings at once ----------
    pose = batch.pose
    px, py, pz = batch.xyz[..., 0], batch.xyz[..., 1], batch.xyz[..., 2]  # (F, R)
    sensor_pos = pose[:, :, 3]                                           # (F, 3)
    # pose[i, 0] * px + pose[i, 1] * py + pose[i, 2] * pz + pose[i, 3], as
    # XLA's CPU build fuses it
    p_odom = [fma32(pose[:, i, 2:3], pz, fma32(pose[:, i, 0:1], px, pose[:, i, 1:2] * py))
              + pose[:, i, 3:4] for i in range(3)]
    p_rel = [p_odom[i] - sensor_pos[:, i:i + 1] for i in range(3)]
    point_ok = ~torch.isnan(px) & batch.valid[:, None]
    azimuth = f64_round(torch.atan2, py, px)        # sensor frame (…cpp:142)
    if config.range_image.sensor_is_clockwise:
        inc_az = -azimuth + pi32
    else:
        inc_az = azimuth + pi32
    col_pre = (inc_az / az_width).to(torch.int32)
    # f64 sqrt rounded once: torch's f32 sqrt on the CPU is not correctly
    # rounded (about 1 input in 10,000 lands 1 ulp low), the card's is
    dist_all = f64_round(torch.sqrt, fma32(p_rel[2], p_rel[2],
                                            fma32(p_rel[1], p_rel[1], p_rel[0] * p_rel[0])))
    dist_all = torch.where(point_ok, dist_all, float("nan"))
    inclination = f64_round(torch.asin, p_rel[2] / dist_all)

    # ---- the sequential firing loop ------------------------------------------
    (prev_rearmost, prev_foremost, first_unfinished, ring_start, ring_end, first_unpublished,
     reset_required) = [getattr(state, n).to(dev) for n in CARRIED]
    lcols, gcols, writes, rots, finished = [], [], [], [], []
    for f in range(F):
        valid = point_ok[f] & ~reset_required
        col_in_rot = torch.where(valid, col_pre[f], 0)
        prev_rot = prev_rearmost // num_cols
        gcol = prev_rot * num_cols + col_in_rot
        diff = col_in_rot - prev_rearmost % num_cols
        wrap_fwd = diff < -half                                  # …cpp:161
        wrap_back = (prev_rearmost > 0) & (diff > half)          # …cpp:166
        rot_off = torch.where(wrap_fwd, 1, torch.where(wrap_back, -1, 0))
        gcol = gcol + rot_off * num_cols
        distance = torch.where(valid, dist_all[f], float("nan"))

        lcol = torch.where(valid, gcol % rc, 0)
        old_enc = torch.nan_to_num(dist[rows, lcol], nan=inf)
        next_lcol = (lcol + 1) % rc
        next_enc = torch.nan_to_num(dist[rows, next_lcol], nan=inf)
        shift = (old_enc < inf) & valid & (next_enc == inf)
        lcol = torch.where(shift, next_lcol, lcol)
        gcol = gcol + shift.to(torch.int32)
        old2 = torch.where(shift, next_enc, old_enc)

        refused = (old2 < inf) & (~valid | (distance >= old2))
        tracked = valid & ~refused
        behind = (first_unfinished >= 0) & (gcol < first_unfinished)
        write = tracked & ~behind
        # the claim: an accepted write is nearer than the cell's occupant
        dist[rows, lcol] = torch.where(write, distance, dist[rows, lcol])

        rearmost = torch.where(tracked, gcol, I32_MAX).amin()
        foremost = torch.where(tracked, gcol, -1).amax()
        any_tracked = tracked.any()
        invalid_span = any_tracked & ((foremost - rearmost) > half)   # …cpp:252
        ok = any_tracked & ~invalid_span
        prev_rearmost = torch.where(ok & (rearmost > prev_rearmost), rearmost, prev_rearmost)
        prev_foremost = torch.where(ok & (foremost > prev_foremost), foremost, prev_foremost)
        have_data = prev_foremost >= 0
        ring_start = torch.where(have_data & (ring_start == -1), prev_rearmost, ring_start)
        first_unpublished = torch.where(
            have_data & (first_unpublished == -1), prev_rearmost, first_unpublished)
        ring_end = torch.where(have_data & (prev_foremost > ring_end), prev_foremost, ring_end)
        first_unfinished = torch.where(
            have_data & (first_unfinished == -1), prev_rearmost, first_unfinished)
        # reference while loop (…cpp:289-291): columns [first_unfinished,
        # prev_rearmost) are handed to segmentation
        first_unfinished = torch.where(
            have_data & (first_unfinished < prev_rearmost), prev_rearmost, first_unfinished)
        reset_required = reset_required | invalid_span

        lcols.append(lcol)
        gcols.append(gcol)
        writes.append(write)
        rots.append(prev_rot + rot_off)
        finished.append(torch.where(have_data, prev_rearmost, -1))

    # ---- each cell's winner: the accepted write with the final distance --------
    row_idx = rows.repeat(F)
    if F:
        lcol = torch.stack(lcols).reshape(-1).to(torch.int64)
        gcol = torch.stack(gcols).to(torch.int32)
        write = torch.stack(writes).reshape(-1)
        winner = write & (dist_all.reshape(-1) == dist[row_idx, lcol])
        two_pi = to_device(2.0 * math.pi, dev, torch.float32)
        cont_az = fma32(two_pi, (torch.stack(rots) - state.origin_rot.to(dev)).to(torch.float32),
                        inc_az)
        values = {
            "x": p_odom[0], "y": p_odom[1], "z": p_odom[2],
            "azimuth": azimuth, "inclination": inclination, "cont_az": cont_az,
            "gcol": gcol,
            "stamp_lo": batch.stamp_lo, "stamp_hi": batch.stamp_hi,
            "uidx_lo": batch.uidx_lo, "uidx_hi": batch.uidx_hi,
            "intensity": batch.intensity,
            "firing_index": batch.firing_index[:, None].expand(F, R),
        }
        values = {name: v.reshape(-1) for name, v in values.items()}
        rearmost_per_firing = torch.stack(finished).to(torch.int32)
    else:
        lcol = torch.zeros((0,), dtype=torch.int64, device=dev)
        winner = torch.zeros((0,), dtype=torch.bool, device=dev)
        values = {}
        rearmost_per_firing = torch.zeros((0,), dtype=torch.int32, device=dev)
    carried = (prev_rearmost, prev_foremost, first_unfinished, ring_start, ring_end,
               first_unpublished)
    scalars = {n: t.to(torch.int32) for n, t in zip(CARRIED, carried)}
    scalars["reset_required"] = reset_required
    return Claims(row_idx, lcol, winner, values, scalars, rearmost_per_firing)


def apply_claims(state: RingState, claims: Claims, col0: int = 0) -> None:
    """Write, in place, the values of every winner of ``claims`` whose ring
    column lies in ``state``'s columns [col0, col0 + ring_cols): the whole
    ring (``col0`` 0) or the column shard that owns them.  ``distance`` is
    not written: the firing loop claimed it.

    Every point is routed to local column ``lcol mod ring_cols`` (of the
    shard that owns ``lcol``); the cell's winner among the points this
    state owns decides what all points routed there write, so points that
    meet at one cell write one value, and a point another shard owns writes
    the cell's own value back."""
    if not claims.values:
        return
    w = state.ring_cols
    li = claims.lcol % w
    mine = (claims.lcol - li) == col0
    flat = claims.row * w + li
    # cell -> winning entry (at most one per cell; losers contribute -1)
    owner = torch.full((state.num_rows * w,), -1, dtype=torch.int64, device=state.device)
    entry = torch.arange(flat.shape[0], device=state.device)
    owner.scatter_reduce_(0, flat, torch.where(claims.winner & mine, entry, -1), "amax")
    src = owner[flat]
    has = src >= 0
    src = src.clamp_min(0)
    for name, v in claims.values.items():
        arr = getattr(state, name)
        cur = arr[claims.row, li]
        arr[claims.row, li] = torch.where(has, v.to(arr.dtype)[src], cur)
