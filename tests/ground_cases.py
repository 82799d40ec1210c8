"""Inputs of one ground segmentation step, for the tests that hold the twin
against the JAX package (CPU) and the kernel against the twin (card).

Plain numpy and the port's synthetic scene; imports nothing of JAX, so the
card's tests can use it.  A case is the ring planes of a ray-cast batch of
columns (ground, many near boxes, noise, dropouts, whole NaN columns, a few
points inside the ego box, random intensities for the fog test), placed at
ring columns that wrap the ring's end, with per-column sensor positions and
ego transforms, a carry of inclination diffs with NaN entries, and
optionally stale cells of an older revolution (the overflow test).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from continuous_clustering_tpu_torch.evaluation.synthetic import make_scene, raycast_frame

HSG = np.float32(-1.7)        # sensor height above the ground (the scene's ground_z)
ORIGIN_ROT = 3                # rotations the continuous azimuth is relative to
# points of the sensor frame inside every preset's ego box
EGO_POINT = (1.0, 0.3, -0.5)

# switch combinations (ground_segmentation, range_image, clustering), applied
# with ``with_switches`` to the JAX package's or the port's Config
SWITCHES = {
    "preset": {},
    "fog": {"ground_segmentation": {"fog_filtering_enabled": True}},
    "terrain": {"ground_segmentation": {"use_terrain": True},
                "range_image": {"supplement_inclination_angle_for_nan_cells": False},
                "clustering": {"ignore_points_in_chessboard_pattern": True,
                               "ignore_points_with_too_big_inclination_angle_diff": False}},
}


def with_switches(cfg, switches: str, revolutions: int = 1):
    """``cfg`` with the groups of ``SWITCHES[switches]`` replaced and a ring
    of ``revolutions`` revolutions."""
    groups = {name: dataclasses.replace(getattr(cfg, name), **kw)
              for name, kw in SWITCHES[switches].items()}
    ri = groups.get("range_image", cfg.range_image)
    groups["range_image"] = dataclasses.replace(ri, ring_buffer_revolutions=revolutions)
    return dataclasses.replace(cfg, **groups)


def segment_case(cfg, num_rows: int, batch: int, n_cols: int, seed: int,
                 overflow: bool = False):
    """(cells, extra, inputs) of one step over ``batch`` columns, the first
    ``n_cols`` of them segmented: ``cells`` the (R, rc) ring planes it sets,
    ``extra`` the state's ``incl_diffs`` and ``origin_rot``, ``inputs`` the
    ``SegmentInputs`` fields, all numpy."""
    rng = np.random.default_rng(seed)
    R, B = num_rows, batch
    num_columns = cfg.range_image.num_columns
    rc = cfg.ring_buffer_max_columns
    assert B <= rc
    # the window starts 40 columns before the ring's end, so it wraps
    lc0 = (rc - 40) % rc
    gcol0 = (ORIGIN_ROT * num_columns // rc + 2) * rc + lc0

    scene = make_scene(num_boxes=40, seed=seed, ground_z=float(HSG), spread=22.0,
                       min_radius=2.5)
    frame_cols = max(4 * B, 720)
    xyz, _ = raycast_frame(scene, num_rows=R, num_columns=frame_cols, noise=0.02,
                           dropout=0.08, seed=seed)
    c0 = int(rng.integers(0, frame_cols - B + 1))
    pts = np.transpose(xyz[c0:c0 + B], (1, 0, 2)).astype(np.float64)   # (R, B, 3)
    ego_cols = rng.random(B) < 0.05
    for b in np.flatnonzero(ego_cols):
        rows = R - 1 - np.arange(int(rng.integers(1, 4)))
        pts[rows, b] = np.array(EGO_POINT) + rng.uniform(-0.2, 0.2, (len(rows), 3))
    pts[:, rng.random(B) < 0.03] = np.nan                             # empty columns
    rel = pts.astype(np.float32)
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    dist = np.sqrt(x.astype(np.float64) ** 2 + y ** 2 + z ** 2.0).astype(np.float32)
    inc = np.arctan2(z.astype(np.float64), np.hypot(x, y)).astype(np.float32)

    # the sensor moves a little from column to column; yaw turns the ego frame
    sensor_pos = (np.array([5.0, -3.0, 0.2]) + np.cumsum(rng.normal(0, 0.01, (B, 3)), 0)
                  ).astype(np.float32)
    yaw = rng.uniform(-0.05, 0.05, B)
    ego_rot = np.zeros((B, 3, 3), np.float32)
    ego_rot[:, 0, 0], ego_rot[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    ego_rot[:, 1, 0], ego_rot[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    ego_rot[:, 2, 2] = 1.0
    ego_trans = -np.einsum("bij,bj->bi", ego_rot.astype(np.float64), sensor_pos).astype(
        np.float32)

    cols = (lc0 + np.arange(B)) % rc
    gcol = gcol0 + np.arange(B)
    finite = ~np.isnan(dist)
    az_w = np.float32(2.0 * math.pi / num_columns)
    cont = ((gcol - ORIGIN_ROT * num_columns).astype(np.float32) + np.float32(0.3)) * az_w

    def plane(fill, dtype):
        return np.full((R, rc), fill, dtype)

    cells = {"x": plane(np.nan, np.float32), "y": plane(np.nan, np.float32),
             "z": plane(np.nan, np.float32), "distance": plane(np.nan, np.float32),
             "inclination": plane(np.nan, np.float32), "cont_az": plane(np.nan, np.float32),
             "gcol": plane(-1, np.int32), "intensity": plane(0, np.int32)}
    cells["x"][:, cols] = x + sensor_pos[None, :, 0]
    cells["y"][:, cols] = y + sensor_pos[None, :, 1]
    cells["z"][:, cols] = z + sensor_pos[None, :, 2]
    cells["distance"][:, cols] = dist
    cells["inclination"][:, cols] = inc
    cells["cont_az"][:, cols] = np.where(finite, cont[None, :], np.nan)
    cells["gcol"][:, cols] = np.where(finite, gcol[None, :], -1)
    cells["intensity"][:, cols] = rng.integers(0, 8, (R, B))
    if overflow:  # cells an older revolution left in a few segmented columns
        stale = (rng.random((R, B)) < 0.01) & (np.arange(B) < max(n_cols, 1))[None, :]
        cells["gcol"][:, cols] = np.where(stale, gcol[None, :] - rc, cells["gcol"][:, cols])
    # cells outside the window: another step's, which the step must leave alone
    other = np.setdiff1d(np.arange(rc), cols)[:8]
    for name, a in cells.items():
        a[:, other] = rng.uniform(-5, 5, (R, len(other))).astype(a.dtype)

    carry = rng.normal(0, 0.01, R).astype(np.float32)
    carry[rng.random(R) < 0.3] = np.nan
    extra = {"incl_diffs": carry, "origin_rot": np.int32(ORIGIN_ROT)}
    inputs = {"gcol0": np.int32(gcol0), "n_cols": np.int32(n_cols), "sensor_pos": sensor_pos,
              "ego_rot": ego_rot, "ego_trans": ego_trans, "height_sensor_to_ground": HSG}
    return cells, extra, inputs
