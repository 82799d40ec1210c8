"""Point-cloud schemas and serialization helpers.

Mirrors the reference's published PointCloud2 layout
(``src/ros/ros_utils.cpp:109-207``): 26 fields filled progressively by
processing stage (8 / 15 / 19 / 26 fields).  Here the cloud is a NumPy
structured array; adapters for middleware (e.g. a ROS bridge) can serialize
it without touching the pipeline.
"""

from __future__ import annotations

import enum
import numpy as np


class ProcessingStage(enum.IntEnum):
    """How many fields are populated (reference ros/ros_utils.hpp:15-22)."""

    RAW_POINT = 0
    RANGE_IMAGE_GENERATION = 1
    GROUND_POINT_SEGMENTATION = 2
    CONTINUOUS_CLUSTERING = 3


# full 26-field dtype; uint64-ish reference fields stay integral here
POINT_DTYPE = np.dtype(
    [
        ("x", np.float32),
        ("y", np.float32),
        ("z", np.float32),
        ("firing_index", np.int64),
        ("intensity", np.uint8),
        ("globally_unique_point_index", np.uint64),
        ("time_sec", np.uint32),
        ("time_nsec", np.uint32),
        ("distance", np.float32),
        ("azimuth_angle", np.float32),
        ("inclination_angle", np.float32),
        ("continuous_azimuth_angle", np.float64),
        ("global_column_index", np.int64),
        ("local_column_index", np.uint16),
        ("row_index", np.uint16),
        ("ground_point_label", np.uint8),
        ("debug_ground_point_label", np.uint8),
        ("height_over_ground", np.float32),
        ("ignore_for_clustering", np.uint8),
        ("finished_at_continuous_azimuth_angle", np.float64),
        ("num_child_points", np.uint16),
        ("tree_root_row_index", np.uint16),
        ("tree_root_column_index", np.int64),
        ("number_of_visited_neighbors", np.uint32),
        ("tree_id", np.uint64),
        ("id", np.uint64),
    ]
)

STAGE_FIELD_COUNT = {
    ProcessingStage.RAW_POINT: 8,
    ProcessingStage.RANGE_IMAGE_GENERATION: 15,
    ProcessingStage.GROUND_POINT_SEGMENTATION: 19,
    ProcessingStage.CONTINUOUS_CLUSTERING: 26,
}


def stage_dtype(stage: ProcessingStage) -> np.dtype:
    names = POINT_DTYPE.names[: STAGE_FIELD_COUNT[stage]]
    return np.dtype([(n, POINT_DTYPE[n]) for n in names])


def empty_cloud(n: int, stage: ProcessingStage = ProcessingStage.CONTINUOUS_CLUSTERING):
    return np.zeros(n, dtype=stage_dtype(stage))


def combine_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def firing_to_structured(firing: dict) -> np.ndarray:
    """Convert a sensor firing dict to a RAW_POINT-stage structured cloud
    (the reference publishes raw firings this way, ros_utils.cpp:114-122 /
    continuous_clustering_node.cpp raw_firings topic)."""
    xyz = np.asarray(firing["xyz"], np.float32).reshape(-1, 3)
    n = len(xyz)
    out = empty_cloud(n, ProcessingStage.RAW_POINT)
    out["x"], out["y"], out["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    out["firing_index"] = int(firing.get("firing_index", 0))
    if "intensity" in firing:
        out["intensity"] = np.asarray(firing["intensity"], np.uint8).reshape(-1)
    stamp = np.asarray(firing.get("stamp", np.zeros(n, np.uint64)), np.uint64)
    out["time_sec"] = (stamp // np.uint64(1_000_000_000)).astype(np.uint32)
    out["time_nsec"] = (stamp % np.uint64(1_000_000_000)).astype(np.uint32)
    if "uidx" in firing:
        out["globally_unique_point_index"] = np.asarray(firing["uidx"], np.uint64)
    return out
