"""Middleware-free tf / clock / ego-bounding-box message construction (the
port's copy of ``continuous_clustering_tpu/io/publish_utils.py``).

Analog of the reference's publish_tf / publish_clock /
publish_ego_robot_bounding_box (src/ros/ros_utils.cpp:404-457), expressed as
plain dicts so the demo, rosbag replay, and any downstream consumer can use
them without rospy.  A ROS bridge (the JAX package's ``io/ros_bridge.py``;
not ported yet) converts them into real ``tf2_msgs/TFMessage`` /
``rosgraph_msgs/Clock`` / ``visualization_msgs/Marker``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..config import GroundSegmentationConfig


def rotation_matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> quaternion (x, y, z, w), Shepperd's method."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = math.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = math.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = math.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w], np.float64)


def make_tf_message(
    odom_from_sensor: np.ndarray,
    stamp_ns: int,
    frame_id: str = "odom",
    child_frame_id: str = "velo_link",
) -> Dict:
    """publish_tf analog (ros_utils.cpp:404-412): one stamped transform."""
    T = np.asarray(odom_from_sensor, np.float64)
    return {
        "type": "tf",
        "stamp_ns": int(stamp_ns),
        "frame_id": frame_id,
        "child_frame_id": child_frame_id,
        "translation": T[:3, 3].copy(),
        "rotation_xyzw": rotation_matrix_to_quaternion(T[:3, :3]),
    }


def make_clock_message(stamp_ns: int) -> Dict:
    """publish_clock analog (ros_utils.cpp:414-422)."""
    return {"type": "clock", "stamp_ns": int(stamp_ns)}


def make_ego_bounding_box_marker(
    stamp_ns: int,
    config: GroundSegmentationConfig,
    frame_id: str = "velo_link",
) -> Dict:
    """publish_ego_robot_bounding_box analog (ros_utils.cpp:424-457):
    a CUBE marker sized/positioned from the ego dimensions, frame-locked."""
    sx = abs(config.length_ref_to_rear_end) + abs(config.length_ref_to_front_end)
    sy = abs(config.width_ref_to_right_mirror) + abs(config.width_ref_to_left_mirror)
    sz = abs(config.height_ref_to_ground) + abs(config.height_ref_to_maximum)
    return {
        "type": "marker",
        "stamp_ns": int(stamp_ns),
        "frame_id": frame_id,
        "ns": "ego_robot",
        "id": 0,
        "marker_type": "cube",
        "color_rgba": (1.0, 1.0, 1.0, 0.4),
        "scale": (sx, sy, sz),
        # bounding-box center relative to the sensor (ros_utils.cpp:446-449)
        "position": (
            config.length_ref_to_rear_end + sx / 2,
            config.width_ref_to_right_mirror + sy / 2,
            config.height_ref_to_ground + sz / 2,
        ),
        "orientation_xyzw": (0.0, 0.0, 0.0, 1.0),
        "frame_locked": True,
    }
