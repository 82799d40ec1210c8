"""Middleware-agnostic clustering node (the port's counterpart of
``continuous_clustering_tpu/io/node.py``).

Mirrors the reference ROS node's wiring (src/ros/continuous_clustering_node.cpp)
without any middleware dependency: sensor-input selection by manufacturer,
transform synchronization, time-jump detection with full pipeline reset, ego
geometry configuration, and publisher callbacks for firings / ground columns /
instance columns / clusters.  A ROS (or any other middleware) bridge only
needs to feed ``on_raw_data`` / ``on_transform`` and consume the publisher
callbacks.

The pipeline runs on ``device`` (``utils.platform.resolve_device``: ``None``
means the card, and raises without one; a CPU run is asked for with
``device="cpu"``), through the facade's ``insertion`` path.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..config import Config
from ..models.continuous_clustering import ContinuousClustering
from ..sensors.sensor_input import GenericPointsInput, SensorInput
from ..utils.platform import resolve_device
from ..utils.stats import TRACE
from .point_cloud import ProcessingStage
from .transform_synchronizer import TransformSynchronizer


def make_sensor_input(manufacturer: str, **kwargs) -> SensorInput:
    """(reference …node.cpp:41-48)."""
    m = manufacturer.lower()
    if m == "velodyne":
        from ..sensors.velodyne import VelodyneInput

        return VelodyneInput(**kwargs)
    if m == "ouster":
        from ..sensors.ouster import OusterInput

        return OusterInput(**kwargs)
    if m == "generic_points":
        return GenericPointsInput(**kwargs)
    raise ValueError(f"Unknown sensor manufacturer: {manufacturer}")


class ClusteringNode:
    """Wires a sensor input + transform sync + pipeline + publishers."""

    MAX_TIME_JUMP_NS = int(0.1e9)  # reference …node.cpp:110-131

    def __init__(
        self,
        config: Config = Config(),
        sensor_manufacturer: str = "generic_points",
        sensor_kwargs: Optional[Dict] = None,
        ego_robot_frame_from_sensor_frame: Optional[np.ndarray] = None,
        wait_for_tf: bool = True,
        firing_batch_size: int = 256,
        device=None,
        insertion: str = "host",
    ):
        self.config = config
        # the card unless the caller names the CPU; raises without a card
        self.device = resolve_device(device)
        self.clustering = ContinuousClustering(config, firing_batch_size=firing_batch_size,
                                               device=self.device, insertion=insertion)
        self.sensor_input = make_sensor_input(sensor_manufacturer, **(sensor_kwargs or {}))
        self.tf_sync = TransformSynchronizer(wait_for_tf=wait_for_tf)
        self.ego_from_sensor = (
            np.eye(4)
            if ego_robot_frame_from_sensor_frame is None
            else np.asarray(ego_robot_frame_from_sensor_frame, np.float64)
        )

        # publisher callbacks (reference topics …node.cpp:73-77)
        self.publish_firing: Optional[Callable] = None
        self.publish_ground_columns: Optional[Callable] = None
        self.publish_instance_columns: Optional[Callable] = None
        self.publish_cluster: Optional[Callable] = None
        # clock / tf / ego-bbox analogs (ros_utils.cpp:404-457; clock+tf
        # emitted per firing like the reference demo, kitti_demo.cpp:76-80)
        self.publish_clock: Optional[Callable] = None
        self.publish_tf: Optional[Callable] = None
        self.publish_ego_bbox: Optional[Callable] = None

        self._last_stamp: Optional[int] = None
        self._num_rows: Optional[int] = None

        self.sensor_input.add_on_new_firing_callback(self._on_new_firing)
        self.tf_sync.set_callback(self._on_firing_with_tf)
        self.clustering.set_finished_column_callback(self._on_finished_columns)
        self.clustering.set_finished_cluster_callback(self._on_finished_cluster)

    # ------------------------------------------------------------ ingress
    def on_raw_data(self, packet: bytes, stamp_ns: int) -> None:
        self.sensor_input.on_packet(packet, stamp_ns)

    def on_points(self, xyz: np.ndarray, stamp_ns: int, intensity=None) -> None:
        self.sensor_input.on_message(xyz, stamp_ns, intensity)

    def on_transform(self, stamp_ns: int, odom_from_sensor: np.ndarray) -> None:
        self.tf_sync.add_transform(stamp_ns, odom_from_sensor)

    # ----------------------------------------------------------- plumbing
    def _on_new_firing(self, firing) -> None:
        stamp = int(firing["stamp"].max()) if len(firing["stamp"]) else 0

        # reset on time jumps or config change (…node.cpp:110-131)
        if self._last_stamp is not None and abs(stamp - self._last_stamp) > self.MAX_TIME_JUMP_NS:
            self.reset(len(firing["xyz"]), stale_time_base=True)
        self._last_stamp = stamp

        if self.clustering.reset_required() or self._num_rows is None:
            self.reset(len(firing["xyz"]))

        if self.publish_firing:
            self.publish_firing(firing)
        self.clustering._sensor_depth = self.sensor_input.pending_packets()
        with TRACE.span("node.tf_sync"):
            self.tf_sync.add_message(stamp, firing)

    def _on_firing_with_tf(self, firing, pose) -> None:
        if self.publish_clock or self.publish_tf:
            from .publish_utils import make_clock_message, make_tf_message

            stamp = int(firing["stamp"].max()) if len(firing["stamp"]) else 0
            if self.publish_clock:
                self.publish_clock(make_clock_message(stamp))
            if self.publish_tf:
                self.publish_tf(make_tf_message(pose, stamp))
        self.clustering.add_firing(firing, pose)

    def _on_finished_columns(self, from_gcol: int, to_gcol: int, ground_only: bool) -> None:
        cb = self.publish_ground_columns if ground_only else self.publish_instance_columns
        if cb:
            stage = (
                ProcessingStage.GROUND_POINT_SEGMENTATION
                if ground_only
                else ProcessingStage.CONTINUOUS_CLUSTERING
            )
            cb(self.clustering.get_columns(from_gcol, to_gcol, stage))

    def _on_finished_cluster(self, points, stamp) -> None:
        if self.publish_cluster:
            self.publish_cluster(points, stamp)

    # ------------------------------------------------------------- control
    def reset(self, num_rows: int, stale_time_base: bool = False) -> None:
        """(reference …node.cpp:87-102).

        ``stale_time_base`` discards buffered transforms too — only correct
        for genuine time jumps.  The startup / reconfigure reset must keep
        them: with an async decode thread, firings can arrive *after* all
        transforms were buffered, and wiping poses here would strand every
        queued firing in the synchronizer forever.
        """
        self._num_rows = num_rows
        self.tf_sync.reset(clear_poses=stale_time_base)
        self.clustering.reset(num_rows)
        self.clustering.set_transform_robot_frame_from_sensor_frame(self.ego_from_sensor)
        self.sensor_input.reset()
        if self.publish_ego_bbox:
            from .publish_utils import make_ego_bounding_box_marker

            self.publish_ego_bbox(
                make_ego_bounding_box_marker(
                    self._last_stamp or 0, self.config.ground_segmentation
                )
            )

    def set_configuration(self, config: Config) -> None:
        self.config = config
        self.clustering.set_configuration(config)

    def flush(self) -> None:
        """Drain the decode thread first, so its last firings reach the
        pipeline, then flush the pipeline."""
        self.sensor_input.drain()
        self.clustering.flush()
