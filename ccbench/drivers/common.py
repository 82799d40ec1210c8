"""What the two drivers share: the scene of a cell, the program's
configuration, the readback of the program's answers into the comparison's
arrays, and the cluster log."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from ..check import Cluster, Columns
from ..frozen.latency import latency_ms
from ..frozen.synthetic import make_scene, raycast_frame

U64_MAX = np.iinfo(np.uint64).max


def sensor_inclinations(sensor: Dict) -> np.ndarray:
    """Top-to-bottom beam inclinations (radians), evenly spaced."""
    return np.deg2rad(np.linspace(sensor["inclination_top_deg"],
                                  sensor["inclination_bottom_deg"], sensor["rows"]))


def ego_from_sensor(sensor: Dict, groups: Dict) -> np.ndarray:
    """The mount: the sensor ``height_m`` over the ground, the vehicle's
    reference frame ``-height_ref_to_ground`` over it."""
    ego = np.eye(4)
    ego[2, 3] = sensor["height_m"] + groups["ground_segmentation"]["height_ref_to_ground"]
    return ego


def scene_revolution(sensor: Dict, scene: Dict, seed: int) -> np.ndarray:
    """One ray-cast revolution (C, R, 3) f32 of the seed's scene, the ground
    ``height_m`` below the sensor."""
    sc = make_scene(num_boxes=scene["num_boxes"], seed=seed, ground_z=-sensor["height_m"],
                    spread=scene["spread_m"], min_radius=scene["min_radius_m"])
    xyz, _ = raycast_frame(sc, num_rows=sensor["rows"], num_columns=sensor["columns"],
                           seed=seed, inclinations=sensor_inclinations(sensor))
    return xyz


def port_config(port, groups: Dict):
    """The program's configuration from the configuration file's groups."""
    cfg = port.config
    return cfg.Config(
        general=cfg.GeneralConfig(**groups.get("general", {})),
        range_image=cfg.RangeImageConfig(**groups.get("range_image", {})),
        ground_segmentation=cfg.GroundSegmentationConfig(**groups.get("ground_segmentation", {})),
        clustering=cfg.ClusteringConfig(**groups.get("clustering", {})),
    )


class ClusterLog:
    """The finished-cluster callback: the wall time of each call, the
    cluster's stamp, and its points' columns, rows and coordinates."""

    def __init__(self):
        self.entries: List[Tuple[int, int, np.ndarray]] = []
        self.span = None  # the traced run's span factory

    def __call__(self, records: np.ndarray, stamp) -> None:
        now = time.time_ns()
        if self.span is not None:
            with self.span("cluster_callback"):
                self._keep(now, records, stamp)
        else:
            self._keep(now, records, stamp)

    def _keep(self, now: int, records: np.ndarray, stamp) -> None:
        pts = np.empty(len(records), [("g", np.int64), ("r", np.int64), ("xyz", np.float32, 3)])
        pts["g"] = records["global_column_index"]
        pts["r"] = records["row_index"]
        pts["xyz"][:, 0] = records["x"]
        pts["xyz"][:, 1] = records["y"]
        pts["xyz"][:, 2] = records["z"]
        self.entries.append((now, int(stamp), pts))

    def clusters(self) -> List[Cluster]:
        return [Cluster(p["g"], p["r"], p["xyz"], st) for _, st, p in self.entries]

    def latencies_ms(self, t0_ns: int, t1_ns: int) -> List[float]:
        """Of the clusters published in [t0_ns, t1_ns): the callback's wall
        time less the cluster's stamp (the newest point's scheduled arrival,
        where the stream stamps points with it), in ms."""
        return [latency_ms(t, st) for t, st, _ in self.entries if t0_ns <= t < t1_ns]


def read_columns(cloud) -> Columns:
    """``get_columns`` records as the comparison's arrays (none: empty)."""
    if cloud is None:
        z = np.zeros(0, np.int64)
        return Columns(z, z, z.astype(bool), np.zeros((0, 3), np.float32),
                       z.astype(np.uint8), z.astype(np.uint64), z)
    present = ~np.isnan(cloud["x"])
    u = cloud["globally_unique_point_index"]
    stamp = (cloud["time_sec"].astype(np.uint64) * np.uint64(1_000_000_000)
             + cloud["time_nsec"].astype(np.uint64))
    return Columns(
        gcol=cloud["global_column_index"].astype(np.int64),
        row=cloud["row_index"].astype(np.int64),
        present=present,
        xyz=np.stack([cloud["x"], cloud["y"], cloud["z"]], axis=1),
        ground=cloud["ground_point_label"].astype(np.uint8),
        stamp=stamp,
        uidx=np.where(present & (u != U64_MAX), u.astype(np.int64), -1),
    )


def points_before(cum_points: np.ndarray, num_columns: int, gcol: int) -> int:
    """Finite points of firings [0, gcol) of the repeated revolution whose
    per-column running count is ``cum_points``."""
    rev, c = divmod(max(gcol, 0), num_columns)
    return int(rev * cum_points[-1] + cum_points[c])


def synchronize(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def finished_revolutions(fed: int, num_columns: int) -> List[int]:
    """Revolutions k >= 1 whose clusters the stream finished: the stream
    went on half a revolution past their end, as the reference's does."""
    C = num_columns
    return [k for k in range(1, fed // C) if (k + 1) * C + C // 2 <= fed]
