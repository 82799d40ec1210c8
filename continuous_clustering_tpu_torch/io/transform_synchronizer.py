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
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from ..evaluation.kitti_loader import StampedPose, interpolate


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
