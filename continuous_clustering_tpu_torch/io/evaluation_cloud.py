"""Evaluation comparison cloud (the port's copy of
``continuous_clustering_tpu/io/evaluation_cloud.py``).

Mirrors the reference's evaluationToPointCloud (src/ros/ros_utils.cpp:319-402):
a 10-field per-point cloud joining ground truth and detections for visual
inspection — semantic/instance labels, correspondence flag, ground-point
confusion category, GT euclidean-clustering label, detection label and a
false-negative marker.
"""

from __future__ import annotations

import numpy as np

from ..evaluation.kitti_loader import GROUND_LABEL_IDS, UNLABELED_ID

EVALUATION_DTYPE = np.dtype(
    [
        ("x", np.float32),
        ("y", np.float32),
        ("z", np.float32),
        ("semantic_label", np.uint16),
        ("instance_label", np.uint16),
        ("has_corresponding_point_in_detection_point_cloud", np.uint8),
        ("ground_point_evaluation", np.uint8),  # 0 none, 1 TP, 2 FN, 3 FP, 4 TN
        ("ground_truth_label", np.uint32),
        ("detection_label", np.uint32),
        ("false_negative", np.uint8),
    ]
)


def evaluation_to_cloud(
    xyz: np.ndarray,
    semantic: np.ndarray,
    instance: np.ndarray,
    gt_label: np.ndarray,
    det_label: np.ndarray,
    is_ground_pred: np.ndarray,
    has_det: np.ndarray,
) -> np.ndarray:
    """Build the comparison cloud for one frame."""
    n = len(xyz)
    out = np.zeros(n, dtype=EVALUATION_DTYPE)
    out["x"], out["y"], out["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    out["semantic_label"] = semantic
    out["instance_label"] = instance
    out["has_corresponding_point_in_detection_point_cloud"] = has_det.astype(np.uint8)
    out["ground_truth_label"] = gt_label
    out["detection_label"] = det_label

    labeled = semantic != UNLABELED_ID
    gt_ground = np.isin(semantic, list(GROUND_LABEL_IDS)) & labeled
    pred = is_ground_pred.astype(bool)
    ev = np.zeros(n, np.uint8)
    ev[labeled & gt_ground & pred] = 1   # TP
    ev[labeled & gt_ground & ~pred] = 2  # FN
    ev[labeled & ~gt_ground & pred] = 3  # FP
    ev[labeled & ~gt_ground & ~pred] = 4 # TN
    out["ground_point_evaluation"] = ev

    # a GT-clustered point with no detection label is a clustering miss
    out["false_negative"] = ((gt_label != 0) & (det_label == 0)).astype(np.uint8)
    return out
