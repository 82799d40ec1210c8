"""Transform synchronizer: buffer firings until an odometry pose is available
(the port's copy of ``continuous_clustering_tpu/io/transform_synchronizer.py``,
with the stamped-pose interpolation it takes from the JAX package's
``evaluation/kitti_loader.py``, whose port is still to come).

Mirrors the reference RosTransformSynchronizer
(ros/ros_transform_synchronizer.hpp:10-114): messages queue with their
stamps; whenever a transform newer than a message's stamp exists the message
is released with the interpolated pose.  ``wait_for_tf=False`` releases
immediately with the latest transform (lower latency, larger column batches
— trade-off documented in the reference README:188-195).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------------- poses
@dataclass
class StampedPose:
    stamp: int
    pose: np.ndarray  # 4x4


def interpolate(transforms: List[StampedPose], stamp: int) -> StampedPose:
    """Slerp pose interpolation (…cpp:297-328)."""
    stamps = [t.stamp for t in transforms]
    i = np.searchsorted(stamps, stamp, side="left")
    if i >= len(transforms):
        return StampedPose(stamp, transforms[-1].pose)
    if i == 0:
        return StampedPose(stamp, transforms[0].pose)
    before, after = transforms[i - 1], transforms[i]
    f = (stamp - before.stamp) / (after.stamp - before.stamp)
    q0 = _mat_to_quat(before.pose[:3, :3])
    q1 = _mat_to_quat(after.pose[:3, :3])
    q = _slerp(q0, q1, f)
    t = (1 - f) * before.pose[:3, 3] + f * after.pose[:3, 3]
    pose = np.eye(4)
    pose[:3, :3] = _quat_to_mat(q)
    pose[:3, 3] = t
    return StampedPose(stamp, pose)


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _slerp(q0: np.ndarray, q1: np.ndarray, f: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + f * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = math.acos(np.clip(d, -1, 1))
    return (math.sin((1 - f) * theta) * q0 + math.sin(f * theta) * q1) / math.sin(theta)




class TransformSynchronizer:
    def __init__(self, wait_for_tf: bool = True, buffer_length: int = 1000):
        self.wait_for_tf = wait_for_tf
        self._poses: List[StampedPose] = []
        self._queue: Deque[Tuple[int, object]] = deque(maxlen=buffer_length)
        self._cb: Optional[Callable[[object, np.ndarray], None]] = None

    def set_callback(self, cb: Callable[[object, np.ndarray], None]) -> None:
        self._cb = cb

    def reset(self, clear_poses: bool = False) -> None:
        """Drop queued messages; keep the pose history unless asked.

        The reference's reset re-arms the synchronizer but the tf *buffer*
        lives in ROS's global listener and is never cleared
        (ros_transform_synchronizer.hpp:30-44) — so transforms received
        before a reset must stay usable.  ``clear_poses=True`` is for
        genuine time jumps, where the old time base is meaningless.
        """
        if clear_poses:
            self._poses.clear()
        self._queue.clear()

    def add_transform(self, stamp: int, pose: np.ndarray) -> None:
        self._poses.append(StampedPose(stamp, np.asarray(pose, np.float64)))
        # keep a bounded history
        if len(self._poses) > 10000:
            del self._poses[:5000]
        self._drain()

    def add_message(self, stamp: int, msg) -> None:
        if not self.wait_for_tf:
            if self._poses and self._cb:
                self._cb(msg, self._poses[-1].pose)
            return
        self._queue.append((stamp, msg))
        self._drain()

    def _drain(self) -> None:
        # release while a transform newer than the front message exists
        # (reference drain loop, ros_transform_synchronizer.hpp:75-92)
        while self._queue and self._poses and self._poses[-1].stamp >= self._queue[0][0]:
            stamp, msg = self._queue.popleft()
            pose = interpolate(self._poses, stamp).pose
            if self._cb:
                self._cb(msg, pose)
