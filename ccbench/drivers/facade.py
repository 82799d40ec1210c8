"""Firings into ``ContinuousClustering.add_firing``: one revolution of the
seed's scene, handed in again and again, each revolution k with its stamps
shifted by k revolution periods and its point indices by k revolutions of
points.

Traffic keys: ``scene`` (``num_boxes``, ``spread_m``, ``min_radius_m``),
``firing_batch``, ``insertion`` (``host`` or ``device``), ``loop``:

* ``closed``: the next firing as soon as ``add_firing`` returns; stamps on
  the sensor's clock (its rpm);
* ``open``: firing k is due ``k / columns_per_s`` seconds after the
  stream's start, whatever the program does; its stamp is that due time
  on the wall clock (``time.time_ns``), so a cluster's stamp under
  ``use_last_point_for_cluster_stamp`` is the scheduled arrival of its
  newest column.

The first ``warmup_revolutions`` are set-up; the window goes on with the
same stream.  In the open loop they run closed loop through a pipeline
that is then thrown away (it takes the cold start: first launches, the
allocator), and one revolution on the schedule leads the stream in, so
that the window does not start behind.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .common import (ClusterLog, ego_from_sensor, finished_revolutions, points_before,
                     port_config, read_columns, scene_revolution, synchronize)

SENSOR_T0_NS = 1_000_000_000


class Driver:
    ego_pose = np.eye(4)   # odometry: the vehicle stands still

    def __init__(self, port, config: Dict, traffic: Dict, seed: int, device):
        self.port, self.traffic, self.device = port, traffic, device
        sensor = config["sensor"]
        self.groups = config["pipeline"]
        self.R, self.C = sensor["rows"], sensor["columns"]
        self.open_loop = traffic["loop"] == "open"
        if self.open_loop:
            self.rev_ns = int(round(self.C * 1e9 / traffic["columns_per_s"]))
        else:
            self.rev_ns = int(round(60e9 / sensor["rpm"]))
        self.uidx_per_rev = self.C * self.R
        self.ego = ego_from_sensor(sensor, self.groups)
        self.xyz = scene_revolution(sensor, traffic["scene"], seed)
        per_col = (~np.isnan(self.xyz[..., 0])).sum(axis=1)
        self.cum_points = np.concatenate([[0], np.cumsum(per_col)])
        self.rows = np.arange(self.R, dtype=np.uint64)
        self.intensity = np.full(self.R, 100, np.uint8)
        self.t0_ns = SENSOR_T0_NS
        self.k = 0

    # -------------------------------------------------------------- stream
    def stamp(self, k: int) -> int:
        return self.t0_ns + (k * self.rev_ns) // self.C

    def firing(self, k: int) -> Dict[str, np.ndarray]:
        return {"xyz": self.xyz[k % self.C],
                "stamp": np.full(self.R, self.stamp(k), np.uint64),
                "intensity": self.intensity,
                "firing_index": k,
                "uidx": np.uint64(k * self.R) + self.rows}

    # ------------------------------------------------------------- program
    def _make_pipe(self):
        port = self.port
        pipe = port.continuous_clustering.ContinuousClustering(
            port_config(port, self.groups), firing_batch_size=self.traffic["firing_batch"],
            device=self.device, insertion=self.traffic["insertion"])
        pipe.reset(self.R)
        pipe.set_transform_robot_frame_from_sensor_frame(self.ego)
        return pipe

    def _closed(self, pipe, n: int) -> None:
        for k in range(n):
            pipe.add_firing(self.firing(k), self.ego_pose)

    def setup(self) -> None:
        n = self.traffic["warmup_revolutions"] * self.C
        if self.open_loop:
            warm = self._make_pipe()
            self._closed(warm, n)
            warm.flush()
            del warm
        self.pipe = self._make_pipe()
        self.log = ClusterLog()
        self.pipe.set_finished_cluster_callback(self.log)
        if self.open_loop:
            self.t0_ns = time.time_ns()
            self.p0 = time.perf_counter()
            self._paced(self.C, None, None, None)
        else:
            self._closed(self.pipe, n)
            self.k = n
        synchronize(self.device)

    def _due(self, k: int) -> float:
        return self.p0 + ((k * self.rev_ns) // self.C) / 1e9

    def _paced(self, stop, end, lags, tracer) -> None:
        """Firings up to ``stop`` (or due before ``end``) on the schedule;
        each one's lateness when ``add_firing`` takes it into ``lags``
        (before the profiled slice, in a traced run)."""
        pipe, pose = self.pipe, self.ego_pose
        k = self.k
        while k < stop if end is None else self._due(k) < end:
            due = self._due(k)
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
                now = time.perf_counter()
            # lateness of the columns before the profiled slice: the
            # profiler's own stalls are not the program's back-pressure
            if lags is not None and (tracer is None or tracer.state == "wait"):
                lags.append((now - due) * 1e3)
            if tracer is None:
                pipe.add_firing(self.firing(k), pose)
            else:
                with tracer.span("generator"):
                    f = self.firing(k)
                with tracer.span("add_firing"):
                    pipe.add_firing(f, pose)
                tracer.poll(time.perf_counter(), pipe.n_steps)
            k += 1
        self.k = k

    def window(self, seconds: float, tracer=None) -> Dict:
        pipe = self.pipe
        if tracer is not None:
            self.log.span = tracer.span
        frontier0 = pipe.first_unpublished_global_column_index
        k0 = self.k
        if self.open_loop:
            t0 = self._due(k0)
            w0_ns = self.stamp(k0)
            end = t0 + seconds
            lags = []
            self._paced(None, end, lags, tracer)
            now = time.perf_counter()
            if now < end:
                time.sleep(end - now)
        else:
            add, pose, firing = pipe.add_firing, self.ego_pose, self.firing
            k = k0
            t0 = time.perf_counter()
            w0_ns = time.time_ns()
            end = t0 + seconds
            if tracer is None:
                while True:
                    add(firing(k), pose)
                    k += 1
                    if time.perf_counter() >= end:
                        break
            else:
                span, poll = tracer.span, tracer.poll
                while True:
                    with span("generator"):
                        f = firing(k)
                    with span("add_firing"):
                        add(f, pose)
                    k += 1
                    now = time.perf_counter()
                    poll(now, pipe.n_steps)
                    if now >= end:
                        break
            self.k = k
            lags = None
        synchronize(self.device)
        t1 = time.perf_counter()
        frontier1 = pipe.first_unpublished_global_column_index
        window_s = t1 - t0
        return {
            "window_s": window_s,
            "firings": self.k - k0,
            "points": (points_before(self.cum_points, self.C, frontier1)
                       - points_before(self.cum_points, self.C, frontier0)),
            "latency_ms": self.log.latencies_ms(w0_ns, w0_ns + int(window_s * 1e9)),
            "input_lag_ms": lags,
            "n_steps": pipe.n_steps,
        }

    def finish(self):
        """Flush the stream (late answers count), read back the last
        published revolution, free the program.  Returns (clusters,
        columns, revolutions to compare)."""
        pipe = self.pipe
        pipe.flush()
        fu = pipe.first_unpublished_global_column_index
        cloud = pipe.get_columns(max(fu - self.C, self.C), fu - 1) if fu > self.C + 1 else None
        del self.pipe, pipe
        return self.log.clusters(), read_columns(cloud), finished_revolutions(self.k, self.C)

    def reference_firing(self, k: int) -> Dict[str, np.ndarray]:
        return self.firing(k)
