"""Sensor input base: firing assembly (the port's copy of
``continuous_clustering_tpu/sensors/sensor_input.py``).

Mirrors the reference's SensorInput (ros/sensor_input.hpp:9-63): concrete
inputs decode raw data into *firings* (one slot per laser row) and invoke a
callback per completed firing.  Each firing dict carries
``xyz (R,3) f32 | stamp (R,) u64 | intensity (R,) u8 | firing_index | uidx``
— the shape consumed by ``ContinuousClustering.add_firing``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..utils.stats import TRACE


class SensorInput:
    def __init__(self, num_lasers: Optional[int] = None):
        self.num_lasers = num_lasers
        self._cb: Optional[Callable[[Dict[str, np.ndarray]], None]] = None
        self.firing_index = 0
        self._pending = 0  # queue depth (dataCount analog)

    def add_on_new_firing_callback(self, cb) -> None:
        self._cb = cb

    def data_count(self) -> int:
        return self._pending

    def pending_packets(self) -> int:
        """Raw packets awaiting decode (nonzero only with a decode-thread
        offload, reference ros_sensor_input.hpp:19-60)."""
        return 0

    def drain(self) -> None:
        """Block until any decode offload has consumed its queue."""

    def reset(self) -> None:
        self.firing_index = 0
        self._pending = 0

    def _emit(self, xyz, stamp, intensity, uidx=None) -> None:
        TRACE.count("node.firings")
        with TRACE.span("node.firing"):
            self._emit_firing(xyz, stamp, intensity, uidx)

    def _emit_firing(self, xyz, stamp, intensity, uidx) -> None:
        num = len(xyz)
        firing = {
            "xyz": np.asarray(xyz, np.float32).reshape(num, 3),
            "stamp": np.asarray(stamp, np.uint64),
            "intensity": np.asarray(intensity, np.uint8),
            "firing_index": self.firing_index,
        }
        if uidx is not None:
            firing["uidx"] = np.asarray(uidx, np.uint64)
        # firing stamp = midpoint convention (sensor_input.hpp:27-44) is
        # implicit: per-point stamps carry the detail
        self.firing_index += 1
        if self._cb:
            self._cb(firing)


class GenericPointsInput(SensorInput):
    """Organized point-cloud messages, one message per firing
    (reference GenericPointsInput, ros/generic_points_input.hpp:13-54:
    width=1, height=num_lasers, NaN for missing returns)."""

    def on_message(self, xyz: np.ndarray, stamp: int, intensity=None) -> None:
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        if self.num_lasers is None:
            self.num_lasers = len(xyz)  # latched from first message
        n = self.num_lasers
        if intensity is None:
            intensity = np.zeros(n, np.uint8)
        self._emit(xyz, np.full(n, stamp, np.uint64), intensity)
