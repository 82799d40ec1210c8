# FROZEN COPY of ``continuous_clustering_tpu_torch/evaluation/synthetic.py`` at commit cce7c49ab9acd93ca72165a17ff47a74717926ce.
#
# Part of the benchmark's yardstick: later changes to the program do not
# edit this file, so the benchmark measures every commit with the same
# code.  Only imports were changed, so that nothing here imports the
# program or the JAX package.  The original's docstring follows.

"""Synthetic rotating-LiDAR scene generator.

No SemanticKITTI data ships with this repo, so tests and benchmarks ray-cast
procedural scenes (ground plane + box obstacles) into KITTI-shaped firings.
The geometry mimics an HDL-64E: ``num_rows`` lasers with inclinations from
+2° to -24.8°, one firing per azimuth column, clockwise rotation starting at
the negative x-axis (matching the reference's column convention,
src/clustering/continuous_clustering.cpp:144-151).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Box:
    center: Tuple[float, float, float]
    size: Tuple[float, float, float]
    label: int = 1  # instance label for GT


@dataclass
class Scene:
    ground_z: float = -1.7
    boxes: List[Box] = field(default_factory=list)
    max_range: float = 80.0


def make_scene(
    num_boxes: int = 12,
    seed: int = 0,
    ground_z: float = -1.7,
    spread: float = 35.0,
    min_radius: float = 5.0,
) -> Scene:
    rng = np.random.default_rng(seed)
    boxes = []
    for i in range(num_boxes):
        # rejection-sample positions outside the ego region
        while True:
            xy = rng.uniform(-spread, spread, size=2)
            if np.hypot(*xy) > min_radius:
                break
        size = rng.uniform([1.2, 1.2, 1.0], [4.5, 2.2, 2.0])
        boxes.append(
            Box(
                center=(float(xy[0]), float(xy[1]), float(ground_z + size[2] / 2)),
                size=tuple(float(s) for s in size),
                label=i + 1,
            )
        )
    return Scene(ground_z=ground_z, boxes=boxes)


def hdl64_inclinations(num_rows: int = 64) -> np.ndarray:
    """Top-to-bottom laser inclinations (row 0 = highest laser)."""
    return np.deg2rad(np.linspace(2.0, -24.8, num_rows)).astype(np.float64)


def _ray_box_t(origin: np.ndarray, dirs: np.ndarray, box: Box) -> np.ndarray:
    """Slab-method ray/AABB intersection; returns t (inf if miss). dirs: (N,3)."""
    lo = np.array(box.center) - np.array(box.size) / 2
    hi = np.array(box.center) + np.array(box.size) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirs
        t0 = (lo[None, :] - origin[None, :]) * inv
        t1 = (hi[None, :] - origin[None, :]) * inv
    tmin = np.nanmax(np.minimum(t0, t1), axis=1)
    tmax = np.nanmin(np.maximum(t0, t1), axis=1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(hit, np.maximum(tmin, 1e-6), np.inf)
    return t


def raycast_frame(
    scene: Scene,
    num_rows: int = 64,
    num_columns: int = 2200,
    sensor_origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    clockwise: bool = True,
    azimuth_jitter: float = 0.0,
    dropout: float = 0.0,
    noise: float = 0.0,
    seed: int = 0,
    inclinations: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one full revolution.

    Returns
    -------
    xyz : (num_columns, num_rows, 3) float32, sensor frame, NaN for misses
    labels : (num_columns, num_rows) int32 — 0 = no hit, -1 = ground,
        k>0 = box instance k
    """
    rng = np.random.default_rng(seed)
    if inclinations is None:
        inclinations = hdl64_inclinations(num_rows)
    origin = np.asarray(sensor_origin, dtype=np.float64)

    # column k covers increasing azimuth [k, k+1) * width where increasing
    # azimuth 0 is the negative x-axis and grows along the rotation direction
    width = 2.0 * math.pi / num_columns
    inc_az = (np.arange(num_columns) + 0.5) * width
    if azimuth_jitter:
        inc_az = inc_az + rng.uniform(-azimuth_jitter, azimuth_jitter, num_columns) * width
    # invert the reference mapping: increasing_azimuth = -azimuth + pi (cw)
    azimuth = math.pi - inc_az if clockwise else inc_az - math.pi

    cos_a, sin_a = np.cos(azimuth), np.sin(azimuth)
    cos_i, sin_i = np.cos(inclinations), np.sin(inclinations)
    # dirs[c, r] = unit direction of laser r at column c
    dirs = np.stack(
        [
            cos_a[:, None] * cos_i[None, :],
            sin_a[:, None] * cos_i[None, :],
            np.broadcast_to(sin_i[None, :], (num_columns, num_rows)).copy(),
        ],
        axis=-1,
    ).reshape(-1, 3)

    # ground plane
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = (scene.ground_z - origin[2]) / dirs[:, 2]
    t_ground = np.where(t_ground > 0, t_ground, np.inf)

    t_best = t_ground
    label = np.where(np.isfinite(t_ground), -1, 0).astype(np.int32)
    for box in scene.boxes:
        t_box = _ray_box_t(origin, dirs, box)
        closer = t_box < t_best
        t_best = np.where(closer, t_box, t_best)
        label = np.where(closer, box.label, label)

    miss = ~np.isfinite(t_best) | (t_best > scene.max_range)
    t_best = np.where(miss, np.nan, t_best)
    label = np.where(miss, 0, label)

    pts = origin[None, :] + dirs * t_best[:, None]
    if noise:
        pts = pts + rng.normal(0.0, noise, pts.shape)
    if dropout:
        drop = rng.random(pts.shape[0]) < dropout
        pts[drop] = np.nan
        label[drop] = 0

    xyz = pts.reshape(num_columns, num_rows, 3).astype(np.float32)
    labels = label.reshape(num_columns, num_rows)
    return xyz, labels


def frame_to_firings(
    xyz: np.ndarray,
    start_stamp: int = 0,
    end_stamp: int = 100_000_000,
    frame_index: int = 0,
    sequence_index: int = 0,
):
    """Convert a ray-cast frame into the pseudo-firing dicts consumed by the
    pipeline (mirrors kitti_demo's makePseudoFiringFromRangeImageColumn,
    src/tools/kitti_demo.cpp:123-159)."""
    num_columns, num_rows = xyz.shape[:2]
    firings = []
    for c in range(num_columns):
        ratio = c / (num_columns - 1)
        stamp = start_stamp + int((end_stamp - start_stamp) * ratio)
        uidx = (
            (np.uint64(sequence_index) << np.uint64(48))
            | (np.uint64(frame_index) << np.uint64(32))
            | (np.uint64(c) * np.uint64(num_rows) + np.arange(num_rows, dtype=np.uint64))
        )
        firings.append(
            {
                "xyz": xyz[c],
                "stamp": np.full(num_rows, stamp, dtype=np.uint64),
                "intensity": np.full(num_rows, 100, dtype=np.uint8),
                "firing_index": c,
                "uidx": uidx,
            }
        )
    return firings
