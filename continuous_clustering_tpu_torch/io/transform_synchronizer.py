"""Transform synchronizer: buffer firings until an odometry pose is available
(the port's copy of ``continuous_clustering_tpu/io/transform_synchronizer.py``;
the stamped-pose slerp comes from the port's ``evaluation/kitti_loader.py``,
as the JAX module takes it from the JAX loader).

Mirrors the reference RosTransformSynchronizer
(ros/ros_transform_synchronizer.hpp:10-114): messages queue with their
stamps; whenever a transform newer than a message's stamp exists the message
is released with the interpolated pose.  ``wait_for_tf=False`` releases
immediately with the latest transform (lower latency, larger column batches
— trade-off documented in the reference README:188-195).

The pose history is indexed: beside each pose it keeps the pose's stamp in
an int64 array and its rotation's quaternion, so a release searches the
array (``np.searchsorted``, as ``interpolate`` does over the list) and
slerps with the stored quaternions.  A lookup costs the same at any history
length, and releases the poses ``interpolate`` would, bit for bit.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from ..evaluation.kitti_loader import StampedPose, _mat_to_quat, slerp_pose
from ..utils.stats import TRACE


class TransformSynchronizer:
    def __init__(self, wait_for_tf: bool = True, buffer_length: int = 1000):
        self.wait_for_tf = wait_for_tf
        self._poses: List[StampedPose] = []
        # per pose of ``_poses``: its rotation's quaternion, and its stamp in
        # the first len(_poses) entries of a growing array
        self._quats: List[np.ndarray] = []
        self._stamps = np.empty(1024, np.int64)
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
            self._quats.clear()
        self._queue.clear()

    def add_transform(self, stamp: int, pose: np.ndarray) -> None:
        """Buffer the pose at integer ``stamp`` (ns); the history keeps its
        own copy, which its stored quaternion describes."""
        pose = np.array(pose, np.float64)
        n = len(self._poses)
        if n == len(self._stamps):
            self._stamps = np.resize(self._stamps, 2 * n)
        self._stamps[n] = stamp
        self._poses.append(StampedPose(stamp, pose))
        self._quats.append(_mat_to_quat(pose[:3, :3]))
        # keep a bounded history
        if len(self._poses) > 10000:
            del self._poses[:5000]
            del self._quats[:5000]
            self._stamps[:len(self._poses)] = self._stamps[5000:n + 1]
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
        poses = self._poses
        while self._queue and poses and poses[-1].stamp >= self._queue[0][0]:
            stamp, msg = self._queue.popleft()
            n = len(poses)
            TRACE.count("node.tf_lookups")
            TRACE.count("node.tf_history", n)
            # the branches of ``interpolate``, on the indexed history
            i = np.searchsorted(self._stamps[:n], stamp, side="left")
            if i >= n:
                pose = poses[-1].pose
            elif i == 0:
                pose = poses[0].pose
            else:
                pose = slerp_pose(stamp, poses[i - 1], self._quats[i - 1], poses[i],
                                  self._quats[i])
            if self._cb:
                self._cb(msg, pose)
