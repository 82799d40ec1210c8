"""The reference's answer for one steady revolution of a periodic stream.

Every cell feeds the same revolution of a static scene again and again:
revolution k of the stream is revolution 0 with its stamps shifted by k
revolution periods and, where the stream numbers its points, its point
indices by k revolutions of points.  The reference's answer is then
periodic too, so the sequential oracle (``oracle.py``) runs once, over
firings [C - m, 2C + m) of the stream, and its revolution 1 (global columns
[C, 2C)) stands for every revolution k >= 1 of the program's run, shifted
by k - 1 revolutions.  Clusters are assigned to the revolution of their
oldest point; a cluster across the seam of revolutions 1 and 2 is
revolution 1's.  The oracle starts a margin early so that the clusters
across the seam of revolutions 0 and 1 are whole, and runs a margin on so
that those across the seam of 1 and 2 are finished: a quarter revolution,
or twice that where a cluster is wider than the margin allows (the run is
then made again).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

from .config import (ClusteringConfig, Config, GeneralConfig, GroundSegmentationConfig,
                     RangeImageConfig)
from .oracle import OracleContinuousClustering


def reference_config(groups: Dict[str, Dict]) -> Config:
    """The reference's configuration from the configuration file's groups."""
    return Config(
        general=GeneralConfig(**groups.get("general", {})),
        range_image=RangeImageConfig(**groups.get("range_image", {})),
        ground_segmentation=GroundSegmentationConfig(**groups.get("ground_segmentation", {})),
        clustering=ClusteringConfig(**groups.get("clustering", {})),
    )


def round_to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), held
    in float32; NaN stays NaN."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, out)


@dataclasses.dataclass
class SteadyRevolution:
    """Revolution 1 of the reference's run: per (column c, row) of global
    column C + c, whether a point is there, its ground label, cluster id,
    coordinates, stamp and point index (-1 where the stream has none); and
    the published clusters of that revolution as arrays of keys
    (global column - C) * R + row, with their stamps."""

    num_columns: int
    num_rows: int
    present: np.ndarray      # (C, R) bool
    ground: np.ndarray       # (C, R) u8
    xyz: np.ndarray          # (C, R, 3) f32
    stamp: np.ndarray        # (C, R) u64
    uidx: np.ndarray         # (C, R) i64
    clusters: List[np.ndarray]
    cluster_stamps: List[int]


def steady_revolution(groups: Dict[str, Dict], num_rows: int,
                      firing: Callable[[int], Dict[str, np.ndarray]],
                      ego_from_sensor: np.ndarray,
                      bfloat16_points: bool = False) -> SteadyRevolution:
    """Run the oracle over firings [C - m, 2C + m) of the stream
    (``firing(k)`` is global firing k, as the program was given it) and
    return its revolution 1.  ``bfloat16_points`` holds every point's
    coordinates in bfloat16 (the control)."""
    cfg = reference_config(groups)
    C = cfg.range_image.num_columns
    margin = C // 4
    while True:
        rev, widest = _run_oracle(cfg, num_rows, firing, ego_from_sensor, bfloat16_points, margin)
        # a cluster, its wedge on either side, and the column it finishes in
        if widest + 2 * cfg.clustering.max_steps_in_row + 2 < margin or margin >= C // 2:
            return rev
        margin = C // 2


def _run_oracle(cfg: Config, num_rows: int, firing, ego_from_sensor, bfloat16_points: bool,
                margin: int):
    """(revolution 1, the widest published cluster in columns)."""
    C, R = cfg.range_image.num_columns, num_rows
    oracle = OracleContinuousClustering(cfg, R)
    oracle.set_transform_robot_from_sensor(ego_from_sensor)
    rc = cfg.ring_buffer_max_columns
    present = np.zeros((C, R), bool)
    ground = np.zeros((C, R), np.uint8)
    xyz = np.full((C, R, 3), np.nan, np.float32)
    stamp = np.zeros((C, R), np.uint64)
    uidx = np.full((C, R), -1, np.int64)
    clusters, cluster_stamps = [], []
    widest = [0]

    def on_columns(first, last, ground_only):
        if ground_only:
            return
        for g in range(max(first, C), min(last, 2 * C - 1) + 1):
            for r in range(R):
                cell = oracle.cells[g % rc][r]
                if np.isnan(cell.distance):
                    continue
                c = g - C
                present[c, r] = True
                ground[c, r] = cell.ground_point_label
                xyz[c, r] = (cell.x, cell.y, cell.z)
                stamp[c, r] = cell.stamp
                uidx[c, r] = cell.globally_unique_point_index

    def on_cluster(points, cluster_stamp):
        g = np.asarray([p.global_column_index for p in points], np.int64)
        widest[0] = max(widest[0], int(g.max() - g.min()) + 1)
        if C <= g.min() < 2 * C:
            r = np.asarray([p.row_index for p in points], np.int64)
            clusters.append(np.sort((g - C) * R + r))
            cluster_stamps.append(int(cluster_stamp))

    oracle.finished_column_callback = on_columns
    oracle.finished_cluster_callback = on_cluster
    eye = np.eye(4)
    for k in range(C - margin, 2 * C + margin):
        f = firing(k)
        if bfloat16_points:
            f = dict(f, xyz=round_to_bfloat16(f["xyz"]))
        oracle.add_firing(f, eye)
        if oracle.reset_required:
            raise RuntimeError(f"the reference asked for a reset at firing {k}")
    return SteadyRevolution(C, R, present, ground, xyz, stamp, uidx, clusters,
                            cluster_stamps), widest[0]
