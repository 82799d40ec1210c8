"""The port's ground segmentation against the JAX package's CPU build, bit
for bit, on the two f32 expressions that XLA's CPU compiler fuses and on
inputs placed on the thresholds those expressions feed.

* ``d`` (the xy distance) and ``pe`` (the point in the ego frame): the
  port's ``xy_distance`` and ``ego_frame`` against ``jax.jit`` of the JAX
  module's own expressions (``ops/ground_segmentation.py``, the lines that
  compute ``d`` and ``pe``), on 204,800 random inputs each.
* Whole segmentation steps on hand-placed columns: a pair of points whose
  order in ``d`` is decided by the rounding (the slope test between them
  sees ``dxp > 0`` or not: green or yellow), and points whose ``pe[0]``
  sits on the ego box's front edge (ego vehicle or not).  The inputs are
  found by a seeded search over neighbouring f32 values, among those on
  which the fused and the unfused evaluation disagree.

Tolerance: exact, every state field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from continuous_clustering_tpu.config import kitti_config
from continuous_clustering_tpu.ops.ground_segmentation import SegmentInputs as JaxSegmentInputs
from continuous_clustering_tpu.ops.ground_segmentation import (
    ground_segment_columns as jax_ground_segment)
from continuous_clustering_tpu.ops.state import init_state as jax_init
from continuous_clustering_tpu_torch.constants import (GP_EGO_VEHICLE, GP_FOG, GP_GROUND,
                                                        GP_OBSTACLE)
from continuous_clustering_tpu_torch.convert import (config_from_dataclass, state_from_numpy,
                                                      state_to_numpy)
from continuous_clustering_tpu_torch.ops.ground_segmentation import (
    SegmentInputs, ego_frame, ground_segment_columns, xy_distance)

from .ground_cases import SWITCHES, segment_case, with_switches
from .test_torch_step import assert_states_equal, jax_state_numpy, one_torch_thread  # noqa: F401

R_RAND, B_RAND = 400, 512        # 204,800 random inputs per expression
HSG = np.float32(-1.5)           # sensor height above ground
R, B = 8, 16                     # the hand-placed segmentation step


@jax.jit
def jax_d(xs, ys, sensor_pos):
    # as continuous_clustering_tpu/ops/ground_segmentation.py computes ``d``
    sx = sensor_pos[:, 0][None, :]
    sy = sensor_pos[:, 1][None, :]
    xr, yr = xs - sx, ys - sy
    return jnp.sqrt(xr * xr + yr * yr)


@jax.jit
def jax_pe(xs, ys, zs, er, et):
    # as continuous_clustering_tpu/ops/ground_segmentation.py computes ``pe``
    return jnp.stack([
        er[:, i, 0][None, :] * xs + er[:, i, 1][None, :] * ys + er[:, i, 2][None, :] * zs
        + et[:, i][None, :]
        for i in range(3)
    ])


def _f32(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_xy_distance_equals_jax_cpu(seed):
    rng = np.random.default_rng(seed)
    xs, ys = _f32(rng, (R_RAND, B_RAND), 30.0), _f32(rng, (R_RAND, B_RAND), 30.0)
    sp = _f32(rng, (B_RAND, 3), 5.0)
    want = np.asarray(jax_d(xs, ys, sp))
    got = xy_distance(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(sp)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_ego_frame_equals_jax_cpu(seed):
    rng = np.random.default_rng(seed)
    xs, ys = _f32(rng, (R_RAND, B_RAND), 30.0), _f32(rng, (R_RAND, B_RAND), 30.0)
    zs = _f32(rng, (R_RAND, B_RAND), 3.0)
    er, et = _f32(rng, (B_RAND, 3, 3), 1.0), _f32(rng, (B_RAND, 3), 5.0)
    want = np.asarray(jax_pe(xs, ys, zs, er, et))
    T = torch.from_numpy
    got = np.stack([p.numpy() for p in ego_frame(T(xs), T(ys), T(zs), T(er), T(et))])
    np.testing.assert_array_equal(got, want)


# --- numpy models of the two evaluations, for the search of edge inputs -----


def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _d_fused(x, y):
    return np.sqrt(np.float64(_fma(x, x, y * y))).astype(np.float32)


def _d_unfused(x, y):
    return np.sqrt(x * x + y * y)


def _pe0_fused(a, b, c, t, x, y, z):
    return _fma(c, z, _fma(a, x, b * y)) + t


def _pe0_unfused(a, b, c, t, x, y, z):
    return a * x + b * y + c * z + t


def _neighbours(v, n):
    """The 2n + 1 f32 values nearest to ``v`` (v itself in the middle)."""
    out = [np.float32(v)]
    lo = hi = np.float32(v)
    for _ in range(n):
        lo, hi = np.nextafter(lo, np.float32(-np.inf)), np.nextafter(hi, np.float32(np.inf))
        out = [lo] + out + [hi]
    return np.array(out, np.float32)


def slope_edge_pairs(rng, n_pairs):
    """Pairs of xy points at equal height whose order in ``d`` flips between
    the fused and the unfused evaluation: [(x1, y1, x2, y2)]."""
    pairs = []
    while len(pairs) < n_pairs:
        x1, y1 = _f32(rng, 2, 8.0)
        xs = _neighbours(x1, 16)[:, None]
        ys = _neighbours(y1, 16)[None, :]
        x2, y2 = np.broadcast_arrays(xs, ys)
        flip = ((_d_fused(x2, y2) > _d_fused(x1, y1))
                != (_d_unfused(x2, y2) > _d_unfused(x1, y1)))
        if flip.any():
            i = np.flatnonzero(flip.ravel())[0]
            pairs.append((x1, y1, x2.ravel()[i], y2.ravel()[i]))
    return pairs


def ego_edge_points(rng, n_points, front):
    """(a, b, c, t, x, y, z) with ``pe[0]`` on the ego box's front edge: the
    fused and the unfused evaluation fall on either side of it."""
    out = []
    while len(out) < n_points:
        a, b, c = _f32(rng, 3, 1.0)
        y = np.float32(rng.uniform(-1.0, 1.0))
        z = np.float32(rng.uniform(-1.5, 0.3))
        t = np.float32(rng.uniform(-8.0, -4.0))
        x0 = np.float32((front - t - b * y - c * z) / a)
        xs = _neighbours(x0, 64)
        inside_f = _pe0_fused(a, b, c, t, xs, y, z) < front
        inside_u = _pe0_unfused(a, b, c, t, xs, y, z) < front
        flip = inside_f != inside_u
        if flip.any():
            out.append((a, b, c, t, xs[np.flatnonzero(flip)[0]], y, z))
    return out


def edge_step_inputs(case, cfg):
    """Ring planes (x, y, z) of columns [0, B) and the per-column poses."""
    rng = np.random.default_rng(7)
    x = np.full((R, B), np.nan, np.float32)
    y, z = x.copy(), x.copy()
    sensor_pos = np.zeros((B, 3), np.float32)
    ego_rot = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    ego_trans = np.zeros((B, 3), np.float32)
    if case == "slope":
        # bottom row: the first point, ground (|z - hsg| < 0.4); the row
        # above at the same height: green when d rises, else yellow
        for col, (x1, y1, x2, y2) in enumerate(slope_edge_pairs(rng, B)):
            x[R - 1, col], y[R - 1, col], z[R - 1, col] = x1, y1, HSG
            x[R - 2, col], y[R - 2, col], z[R - 2, col] = x2, y2, HSG
    else:
        front = np.float32(cfg.ground_segmentation.length_ref_to_front_end)
        for col, (a, b, c, t, px, py, pz) in enumerate(ego_edge_points(rng, B, front)):
            ego_rot[col, 0] = (a, b, c)
            ego_trans[col, 0] = t
            for r in (R - 1, R - 3):     # an ego candidate, and one above a gap
                x[r, col], y[r, col], z[r, col] = px, py, pz
            x[R - 2, col], y[R - 2, col], z[R - 2, col] = 12.0, 3.0, HSG
    return x, y, z, sensor_pos, ego_rot, ego_trans


@pytest.mark.parametrize("case", ["slope", "ego_box"])
def test_segmentation_on_edge_inputs_equals_jax_cpu(case):
    cfg = kitti_config()
    x, y, z, sp, er, et = edge_step_inputs(case, cfg)
    js = jax_init(cfg, R)
    rc = js.x.shape[1]

    def plane(v, fill=np.nan):
        p = np.full((R, rc), fill, np.float32)
        p[:, :B] = v
        return jnp.asarray(p)

    dist = np.sqrt(x * x + y * y + z * z)
    inc = np.arctan2(z, np.hypot(x, y)).astype(np.float32)
    cont = np.where(np.isnan(dist), np.nan, (np.arange(B, dtype=np.float32) * 0.01)[None, :])
    js = dataclasses.replace(js, x=plane(x), y=plane(y), z=plane(z), distance=plane(dist),
                             inclination=plane(inc), cont_az=plane(cont))
    jin = JaxSegmentInputs(gcol0=jnp.int32(0), n_cols=jnp.int32(B), sensor_pos=jnp.asarray(sp),
                           ego_rot=jnp.asarray(er), ego_trans=jnp.asarray(et),
                           height_sensor_to_ground=jnp.float32(HSG))
    want = jax.jit(lambda s: jax_ground_segment(cfg, s, jin, B))(js)
    ts = state_from_numpy(jax_state_numpy(js), "cpu")
    T = torch.from_numpy
    tin = SegmentInputs(gcol0=torch.tensor(0, dtype=torch.int32),
                        n_cols=torch.tensor(B, dtype=torch.int32), sensor_pos=T(sp),
                        ego_rot=T(er), ego_trans=T(et), height_sensor_to_ground=torch.tensor(HSG))
    got = ground_segment_columns(config_from_dataclass(cfg), ts, tin, B)
    assert_states_equal(jax_state_numpy(want), state_to_numpy(got), case)
    # the edge inputs reach both outcomes of the test they sit on
    labels = np.asarray(want.debug_label)[:, :B] if case == "slope" else np.asarray(
        want.ground_label)[:, :B]
    assert len(np.unique(labels[R - 2 if case == "slope" else R - 1])) > 1


@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("rows", [16, 32, 128])
def test_twin_equals_jax_cpu_under_switches(rows, switches):
    """Whole steps of ray-cast columns under each switch combination (the
    KITTI preset; fog filtering on; terrain on, supplied inclination off,
    chessboard on, inclination gate off): a window that wraps the ring's
    end, n_cols < B, NaN cells and columns, ego-box points, a carry with NaN
    entries, and at 32 rows stale cells of an older revolution (overflow)."""
    cfg = with_switches(kitti_config(), switches)
    cfg = dataclasses.replace(cfg, range_image=dataclasses.replace(cfg.range_image,
                                                                   num_columns=220))
    B, n_cols = 72, 60
    cells, extra, inp = segment_case(cfg, rows, B, n_cols, seed=rows, overflow=rows == 32)
    js = jax_init(cfg, rows)
    js = dataclasses.replace(js, **{k: jnp.asarray(v) for k, v in {**cells, **extra}.items()})
    jin = JaxSegmentInputs(**{k: jnp.asarray(v) for k, v in inp.items()})
    want = jax.jit(lambda s: jax_ground_segment(cfg, s, jin, B))(js)
    ts = state_from_numpy(jax_state_numpy(js), "cpu")
    tin = SegmentInputs(**{k: torch.from_numpy(np.array(v)) for k, v in inp.items()})
    got = ground_segment_columns(config_from_dataclass(cfg), ts, tin, B)
    want_np = jax_state_numpy(want)
    assert_states_equal(want_np, state_to_numpy(got), f"{switches}, {rows} rows")
    # the case reaches the labels its switches decide
    labels = set(np.unique(want_np["ground_label"]).tolist())
    assert {GP_GROUND, GP_OBSTACLE, GP_EGO_VEHICLE} <= labels
    assert (GP_FOG in labels) == (switches == "fog")
    assert bool(want_np["overflow"]) == (rows == 32)
