"""Ground point segmentation over a batch of columns (port of
``continuous_clustering_tpu/ops/ground_segmentation.py``).

``ground_segment_columns`` launches one hand-written CUDA kernel a step on
the card (``csrc/ground_segment.cu``: one thread per column walks the rows,
the cross-column forward fill of the inclination diffs in the same launch)
and takes the plain twin, ``ground_segment_columns_reference``, on the CPU.
The twin is the JAX module's algorithm written with PyTorch: its two
``lax.scan`` passes over rows become Python loops over the R rows,
vectorized across the B columns of the batch, and the forward fill a
``cummax`` of valid positions.  The kernel equals the twin bit for bit.

Exact against the JAX package's CPU build, on the CPU and on the card: XLA's
CPU compiler fuses two f32 multiply-adds that feed comparisons, and the
port evaluates exactly those as fused multiply-adds (``fma32``):

* the xy distance ``d`` (slope tests, backtrack threshold) is
  ``sqrt(fma(xr, xr, yr * yr))``, the ``sqrt`` in f64 rounded once (torch's
  f32 ``sqrt`` on the CPU is not correctly rounded);
* the ego-frame point ``pe`` (ego-vehicle box) is
  ``fma(r2, z, fma(r0, x, r1 * y)) + t`` per row of the rotation.

Every other f32 expression here (the inclination diffs and their fill, the
slopes, the height and distance differences, the supplied inclination, the
NaN-cell azimuth ``(g + 0.5) * w``) is one rounded operation per step, which
XLA does not fuse, and equals the JAX CPU build as it is written.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..constants import (
    DBG_DARKRED, DBG_GRAY, DBG_GREEN, DBG_LIGHTGRAY, DBG_ORANGE, DBG_RED,
    DBG_VIOLET, DBG_WHITE, DBG_YELLOW, DBG_YELLOWGREEN, GP_EGO_VEHICLE,
    GP_FOG, GP_GROUND, GP_OBSTACLE, GP_UNKNOWN,
)

from ..utils.stats import LAUNCHES, to_device
from . import cc_cuda
from .insertion import f64_round, fma32
from .state import RingState, ring_put, ring_read


class SegmentInputs(NamedTuple):
    gcol0: torch.Tensor                    # () i32
    n_cols: torch.Tensor                   # () i32
    sensor_pos: torch.Tensor               # (B, 3) f32
    ego_rot: torch.Tensor                  # (B, 3, 3) f32
    ego_trans: torch.Tensor                # (B, 3) f32
    height_sensor_to_ground: torch.Tensor  # () f32


def _ffill_columns(values: torch.Tensor, valid: torch.Tensor, carry: torch.Tensor):
    """Forward-fill along columns, seeded by ``carry`` (R,); returns
    (filled (R, B), new carry (R,))."""
    v = torch.cat([carry[:, None], values], dim=1)
    m = torch.cat([~torch.isnan(carry)[:, None], valid], dim=1)
    pos = torch.arange(v.shape[1], device=v.device).expand_as(v)
    last = torch.cummax(torch.where(m, pos, -1), dim=1).values
    filled = torch.where(last >= 0, v.gather(1, last.clamp_min(0)), float("nan"))
    return filled[:, 1:], filled[:, -1]


def xy_distance(xs: torch.Tensor, ys: torch.Tensor, sensor_pos: torch.Tensor) -> torch.Tensor:
    """(R, B) distance in the azimuth plane from the sensor at ``sensor_pos``
    (B, 3), as XLA's CPU build evaluates ``sqrt(xr * xr + yr * yr)``."""
    xr, yr = xs - sensor_pos[:, 0][None, :], ys - sensor_pos[:, 1][None, :]
    return f64_round(torch.sqrt, fma32(xr, xr, yr * yr))


def ego_frame(xs, ys, zs, ego_rot: torch.Tensor, ego_trans: torch.Tensor):
    """The three (R, B) coordinates of the points in the ego frame, rotation
    ``ego_rot`` (B, 3, 3) and translation ``ego_trans`` (B, 3) per column,
    as XLA's CPU build evaluates ``r0 * x + r1 * y + r2 * z + t``."""
    return [fma32(ego_rot[:, i, 2][None, :], zs,
                  fma32(ego_rot[:, i, 0][None, :], xs, ego_rot[:, i, 1][None, :] * ys))
            + ego_trans[:, i][None, :] for i in range(3)]


def _select(default: int, shape, device, *cases) -> torch.Tensor:
    """Nested-where label selection: ``cases`` are (mask, value) pairs in
    DEcreasing priority; the first matching mask wins."""
    out = torch.full(shape, default, dtype=torch.int32, device=device)
    for mask, value in reversed(cases):
        out = out.masked_fill(mask, value)
    return out


def ground_segment_columns(
    config: Config, state: RingState, inputs: SegmentInputs, batch_size: int
) -> RingState:
    """Segment columns [gcol0, gcol0 + n_cols) and write the results to the
    ring in place.  A CUDA state launches the kernel or raises; a CPU state
    takes the plain twin."""
    if state.device.type == "cpu":
        return ground_segment_columns_reference(config, state, inputs, batch_size)
    if state.device.type != "cuda":
        raise ValueError(f"ground_segment_columns: unsupported device {state.device}")
    return _ground_segment_kernel(config, state, inputs, batch_size)


# ring fields the kernel reads or writes, in the order of its pointers
_RING_FIELDS = (("x", torch.float32), ("y", torch.float32), ("z", torch.float32),
                ("distance", torch.float32), ("intensity", torch.int32),
                ("inclination", torch.float32), ("cont_az", torch.float32),
                ("gcol", torch.int32), ("ground_label", torch.int32),
                ("debug_label", torch.int32), ("is_ignored", torch.bool))


def _check_strided(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected f32 {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_params(config: Config, inputs: SegmentInputs):
    """The kernel's thresholds (each rounded to f32 by ctypes, as a tensor
    compared with a Python float rounds it) and its integer arguments: the
    switches and the element strides of the per-column poses."""
    g, cl, ri = config.ground_segmentation, config.clustering, config.range_image
    if not isinstance(g.fog_filtering_intensity_below, int):
        raise ValueError("ground_segment: fog_filtering_intensity_below must be an int "
                         "(the intensity plane is i32)")
    floats = (g.max_slope, g.first_ring_as_ground_min_allowed_z_diff,
              g.first_ring_as_ground_max_allowed_z_diff, g.last_ground_point_slope_higher_than,
              g.last_ground_point_distance_smaller_than,
              g.ground_because_close_to_last_certain_ground_max_z_diff,
              g.ground_because_close_to_last_certain_ground_max_dist_diff,
              g.obstacle_because_next_certain_obstacle_max_dist_diff,
              g.length_ref_to_front_end, g.length_ref_to_rear_end, g.width_ref_to_left_mirror,
              g.width_ref_to_right_mirror, g.height_ref_to_maximum, g.height_ref_to_ground,
              g.fog_filtering_distance_below, g.fog_filtering_inclination_above,
              cl.max_distance, 2.0 * math.pi / ri.num_columns)
    flags = (1 * ri.supplement_inclination_angle_for_nan_cells
             | 2 * g.fog_filtering_enabled | 4 * g.use_terrain
             | 8 * cl.ignore_points_with_too_big_inclination_angle_diff
             | 16 * cl.ignore_points_in_chessboard_pattern)
    ints = (g.fog_filtering_intensity_below, ri.num_columns, flags,
            *inputs.sensor_pos.stride(), *inputs.ego_rot.stride(), *inputs.ego_trans.stride())
    return (ctypes.c_float * len(floats))(*floats), (ctypes.c_int * len(ints))(*ints)


def _ground_segment_kernel(config: Config, state: RingState, inputs: SegmentInputs,
                           B: int) -> RingState:
    """One launch of ``csrc/ground_segment.cu`` over the step's columns.
    Allocates the outputs that replace ``incl_diffs`` and ``overflow`` (the
    scalars are replaced, never mutated) and the (2, R, B) scratch; reads
    nothing back."""
    R, rc, dev = state.num_rows, state.ring_cols, state.device
    if not 1 <= B <= rc:
        raise ValueError(f"ground_segment: batch of {B} columns on a ring of {rc}")
    for name, dtype in _RING_FIELDS:
        cc_cuda.check_tensor(getattr(state, name), name, dtype, (R, rc), dev)
    for name, t, dtype in (("gcol0", inputs.gcol0, torch.int32),
                           ("n_cols", inputs.n_cols, torch.int32),
                           ("origin_rot", state.origin_rot, torch.int32),
                           ("height_sensor_to_ground", inputs.height_sensor_to_ground,
                            torch.float32),
                           ("overflow", state.overflow, torch.bool)):
        cc_cuda.check_tensor(t, name, dtype, (), dev)
    cc_cuda.check_tensor(state.incl_diffs, "incl_diffs", torch.float32, (R,), dev)
    _check_strided(inputs.sensor_pos, "sensor_pos", (B, 3), dev)
    _check_strided(inputs.ego_rot, "ego_rot", (B, 3, 3), dev)
    _check_strided(inputs.ego_trans, "ego_trans", (B, 3), dev)
    scratch = torch.empty((2, R, B), dtype=torch.float32, device=dev)
    incl_out = torch.empty((R,), dtype=torch.float32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    tensors = [getattr(state, name) for name, _ in _RING_FIELDS] + [
        inputs.gcol0, inputs.n_cols, state.origin_rot, inputs.sensor_pos, inputs.ego_rot,
        inputs.ego_trans, inputs.height_sensor_to_ground, state.incl_diffs, incl_out,
        state.overflow, overflow, scratch]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    fparams, iparams = _kernel_params(config, inputs)
    lib = cc_cuda.load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cct_ground_segment(ptrs, fparams, iparams, R, B, rc, stream)
    cc_cuda.raise_on_error(err, "ground_segment")
    LAUNCHES["ground_segment"] += 1
    state.incl_diffs = incl_out
    state.overflow = overflow
    return state


def ground_segment_columns_reference(
    config: Config, state: RingState, inputs: SegmentInputs, batch_size: int
) -> RingState:
    """Plain PyTorch twin of the kernel: segment columns [gcol0, gcol0 +
    n_cols) and write the results to the ring in place."""
    R, B, rc = state.num_rows, batch_size, state.ring_cols
    dev = state.device
    num_cols = config.range_image.num_columns
    az_width = float(np.float32(2.0 * math.pi / num_cols))
    g = config.ground_segmentation
    cl = config.clustering

    cols = inputs.gcol0 + torch.arange(B, dtype=torch.int32, device=dev)
    col_valid = torch.arange(B, device=dev) < inputs.n_cols
    lc0 = inputs.gcol0 % rc

    def take(arr):
        return ring_read(arr, lc0, B)

    dist = take(state.distance)
    inc_raw = take(state.inclination)
    xs, ys, zs = take(state.x), take(state.y), take(state.z)
    intensity = take(state.intensity)
    cont_az = take(state.cont_az)
    gcol_cell = take(state.gcol)

    overflow = torch.any((gcol_cell != -1) & (gcol_cell != cols[None, :]) & col_valid[None, :])

    # cross-column inclination diffs; the bottom row diffs against 0.0
    inc_below = torch.cat([inc_raw[1:], torch.zeros((1, B), device=dev)], dim=0)
    diffs = inc_raw - inc_below
    sc_incl, new_incl_carry = _ffill_columns(
        diffs, ~torch.isnan(diffs) & col_valid[None, :], state.incl_diffs)

    cell_nan = torch.isnan(dist)
    sp = inputs.sensor_pos
    zrel = zs - sp[:, 2][None, :]
    d = xy_distance(xs, ys, sp)

    fog = torch.zeros_like(cell_nan)
    if g.fog_filtering_enabled:
        fog = (~cell_nan & (intensity < g.fog_filtering_intensity_below)
               & (dist < g.fog_filtering_distance_below)
               & (inc_raw > g.fog_filtering_inclination_above))

    pe = ego_frame(xs, ys, zs, inputs.ego_rot, inputs.ego_trans)
    ego = (~cell_nan & ~fog
           & (pe[0] < g.length_ref_to_front_end) & (pe[0] > g.length_ref_to_rear_end)
           & (pe[1] < g.width_ref_to_left_mirror) & (pe[1] > g.width_ref_to_right_mirror)
           & (pe[2] < g.height_ref_to_maximum) & (pe[2] > g.height_ref_to_ground))
    hsg = inputs.height_sensor_to_ground
    skip_all = cell_nan | fog | ego

    # ---- classification pass, bottom (r = R-1) to top (r = 0) -----------
    zeros_b = torch.zeros(B, dtype=torch.bool, device=dev)
    first_found, first_obst = zeros_b, zeros_b
    lg_d = torch.zeros(B, dtype=torch.float32, device=dev)
    lg_z = torch.ones(B, dtype=torch.float32, device=dev) * hsg
    prev_d = torch.zeros(B, dtype=torch.float32, device=dev)
    prev_z = torch.zeros(B, dtype=torch.float32, device=dev)
    prev_label = torch.full((B,), DBG_WHITE, dtype=torch.int32, device=dev)
    inc_below_stored = torch.full((B,), float("nan"), device=dev)
    labels = torch.empty((R, B), dtype=torch.int32, device=dev)
    debug = torch.empty((R, B), dtype=torch.int32, device=dev)
    events = torch.empty((R, B), dtype=torch.bool, device=dev)
    inc_stored_all = torch.empty((R, B), dtype=torch.float32, device=dev)
    nan_b = torch.full((B,), float("nan"), device=dev)

    for r in range(R - 1, -1, -1):
        r_nan, r_fog, r_ego = cell_nan[r], fog[r], ego[r]
        r_d, r_z = d[r], zrel[r]
        if config.range_image.supplement_inclination_angle_for_nan_cells and r != R - 1:
            supplied = inc_below_stored + sc_incl[r]
        else:
            supplied = nan_b
        inc_stored = torch.where(r_nan, supplied, inc_raw[r])

        skip = skip_all[r]
        is_first = ~first_found & ~skip
        hog = r_z - hsg
        first_ground = (is_first & (hog > g.first_ring_as_ground_min_allowed_z_diff)
                        & (hog < g.first_ring_as_ground_max_allowed_z_diff))
        first_obstacle_pt = is_first & ~first_ground

        normal = first_found & ~skip
        dxp = r_d - prev_d
        dzp = r_z - prev_z
        slope_prev = dzp / dxp
        flat_prev = (torch.abs(slope_prev) < g.max_slope) & (dxp > 0)
        if g.use_terrain:
            flat_prev = flat_prev & (dxp < 5.0)
        dxl = r_d - lg_d
        dzl = r_z - lg_z
        slope_lg = dzl / dxl
        flat_lg = (torch.abs(slope_lg) < g.max_slope) & (dxl > 0)

        green = normal & ~first_obst & flat_prev
        if g.use_terrain:
            yellowgreen = torch.zeros_like(green)
            yellow = torch.zeros_like(green)
        else:
            yellowgreen = normal & ~green & first_obst & flat_prev & flat_lg
            yellow = (normal & ~green & ~yellowgreen
                      & (torch.abs(dxl) < g.ground_because_close_to_last_certain_ground_max_dist_diff)
                      & (torch.abs(dzl) < g.ground_because_close_to_last_certain_ground_max_z_diff))

        ground = green | yellowgreen | yellow | first_ground
        obstacle = (normal & ~ground) | first_obstacle_pt

        labels[r] = _select(GP_UNKNOWN, (B,), dev, (r_fog, GP_FOG), (r_ego, GP_EGO_VEHICLE),
                            (ground, GP_GROUND), (obstacle, GP_OBSTACLE))
        dbg = _select(DBG_WHITE, (B,), dev, (r_fog, DBG_LIGHTGRAY), (r_ego, DBG_VIOLET),
                      (first_ground, DBG_GRAY), (first_obstacle_pt, DBG_ORANGE),
                      (green, DBG_GREEN), (yellowgreen, DBG_YELLOWGREEN),
                      (yellow, DBG_YELLOW), (obstacle, DBG_RED))
        debug[r] = dbg
        events[r] = normal & ~ground
        inc_stored_all[r] = inc_stored

        update_lg = ((green | yellowgreen)
                     & (slope_prev > g.last_ground_point_slope_higher_than)
                     & (torch.abs(dxp) < g.last_ground_point_distance_smaller_than)
                     & (prev_label != DBG_YELLOW)) | first_ground
        lg_d = torch.where(update_lg, r_d, lg_d)
        lg_z = torch.where(update_lg, r_z, lg_z)
        first_obst = torch.where(is_first, first_obstacle_pt, first_obst | (normal & obstacle))
        first_found = first_found | ~skip
        prev_d = torch.where(~skip, r_d, prev_d)
        prev_z = torch.where(~skip, r_z, prev_z)
        prev_label = torch.where(~skip, dbg, prev_label)
        inc_below_stored = inc_stored

    # ---- backtrack pass: retroactive "close lower ground is obstacle" ----
    # each event at row r relabels the contiguous run of qualifying rows
    # below it (rows > r), against the labels as earlier events left them
    thr = g.obstacle_because_next_certain_obstacle_max_dist_diff
    for r in range(R - 2, -1, -1):
        lab_b, dbg_b, d_b = labels[r + 1:], debug[r + 1:], d[r + 1:]
        cont = (dbg_b == DBG_YELLOW) | (
            (lab_b == GP_GROUND) & (torch.abs(d[r][None, :] - d_b) < thr))
        in_run = torch.cumprod(cont.to(torch.int32), dim=0).to(torch.bool)
        relabel = in_run & (lab_b == GP_GROUND) & events[r][None, :]
        labels[r + 1:] = lab_b.masked_fill(relabel, GP_OBSTACLE)
        debug[r + 1:] = dbg_b.masked_fill(relabel, DBG_DARKRED)

    # ---- is_ignored flags --------------------------------------------------
    row_idx = torch.arange(R, dtype=torch.int32, device=dev)[:, None]
    ignored = cell_nan | (labels != GP_OBSTACLE) | (dist < 1.0 * cl.max_distance)
    if cl.ignore_points_with_too_big_inclination_angle_diff:
        gate = (row_idx < R - 1) & (_atan2_f32(cl.max_distance, dist) < sc_incl)
        ignored = ignored | gate
    if cl.ignore_points_in_chessboard_pattern:
        ignored = ignored | ((cols[None, :] % 2 == 0) != (row_idx % 2 == 0))

    # ---- NaN-cell continuous azimuth refill --------------------------------
    gcol_rel = (cols - state.origin_rot * num_cols).to(torch.float32)
    nan_az = (gcol_rel[None, :] + 0.5) * az_width
    cont_az_out = torch.where(cell_nan, nan_az, cont_az)

    wmask = col_valid[None, :].expand(R, B)
    ring_put(state.ground_label, lc0, wmask, labels)
    ring_put(state.debug_label, lc0, wmask, debug)
    ring_put(state.is_ignored, lc0, wmask, ignored)
    ring_put(state.inclination, lc0, wmask, inc_stored_all)
    ring_put(state.cont_az, lc0, wmask, cont_az_out)
    ring_put(state.gcol, lc0, wmask, cols[None, :].expand(R, B))
    state.incl_diffs = torch.where(inputs.n_cols > 0, new_incl_carry, state.incl_diffs)
    state.overflow = state.overflow | overflow
    return state


def _atan2_f32(y: float, x: torch.Tensor) -> torch.Tensor:
    """f32 ``atan2(y, x)`` evaluated in f64 and rounded once, so the CPU and
    the card give the same bits (their f32 atan2 may differ in the last ulp)."""
    return torch.atan2(to_device(np.float32(y), x.device, torch.float64),
                       x.to(torch.float64)).to(torch.float32)
