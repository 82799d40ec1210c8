"""Raw sensor packets into ``ClusteringNode.on_raw_data``, closed loop: the
next packet as soon as the call returns.  One revolution of the seed's
scene is ray-cast at the sensor's beam inclinations and made into packets
in set-up; revolution k is those packets with their stamps shifted by k
revolution periods.  Each packet is preceded by an odometry pose stamped
1 ms after it, so every firing finds its transform.

Traffic keys: ``scene``, ``firing_batch``, ``insertion``, ``loop``
(``closed``), ``warmup_revolutions``.  The configuration's ``sensor``
gives the decoder (``kind`` ``velodyne``: ``distance_resolution_m``,
``firing_cycle_ns``, ``decode_threads``).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from ..frozen.sensor_packets import velodyne_packets
from ..reference.velodyne import decode
from .common import (ClusterLog, ego_from_sensor, finished_revolutions, points_before,
                     port_config, read_columns, scene_revolution, synchronize)

SENSOR_T0_NS = 1_000_000_000
TF_LEAD_NS = 1_000_000


class Driver:
    pose = np.eye(4)   # odometry: the vehicle stands still

    def __init__(self, port, config: Dict, traffic: Dict, seed: int, device):
        if traffic["loop"] != "closed" or config["sensor"]["kind"] != "velodyne":
            raise ValueError("the node driver runs Velodyne packets in a closed loop")
        self.port, self.traffic, self.device = port, traffic, device
        self.sensor = sensor = config["sensor"]
        self.groups = config["pipeline"]
        self.R, self.C = sensor["rows"], sensor["columns"]
        self.rev_ns = int(round(60e9 / sensor["rpm"]))
        self.uidx_per_rev = 0
        self.ego = ego_from_sensor(sensor, self.groups)
        xyz = scene_revolution(sensor, traffic["scene"], seed)
        per_col = (~np.isnan(xyz[..., 0])).sum(axis=1)
        self.cum_points = np.concatenate([[0], np.cumsum(per_col)])
        self.packets = velodyne_packets([xyz], distance_resolution=sensor["distance_resolution_m"],
                                        rpm=sensor["rpm"], t0_ns=SENSOR_T0_NS)
        self.vert_deg = np.linspace(sensor["inclination_top_deg"],
                                    sensor["inclination_bottom_deg"], self.R)
        self.i = 0
        self._decoded = None

    def packet(self, i: int):
        rev, p = divmod(i, len(self.packets))
        stamp, pkt = self.packets[p]
        return stamp + rev * self.rev_ns, pkt

    def setup(self) -> None:
        port, s = self.port, self.sensor
        self.node = port.node.ClusteringNode(
            config=port_config(port, self.groups), sensor_manufacturer="velodyne",
            sensor_kwargs={"num_lasers": self.R, "vert_angles_deg": self.vert_deg,
                           "distance_resolution": s["distance_resolution_m"],
                           "firing_cycle_ns": s["firing_cycle_ns"],
                           "decode_threads": s["decode_threads"]},
            ego_robot_frame_from_sensor_frame=self.ego,
            firing_batch_size=self.traffic["firing_batch"], device=self.device,
            insertion=self.traffic["insertion"])
        self.log = ClusterLog()
        self.node.publish_cluster = self.log
        self.inside_s = 0.0
        for _ in range(self.traffic["warmup_revolutions"] * len(self.packets)):
            self._feed()
        # the warm-up's firings are through the decode thread before the window
        self.node.sensor_input.drain()
        synchronize(self.device)

    def _feed(self) -> None:
        stamp, pkt = self.packet(self.i)
        self.node.on_transform(stamp + TF_LEAD_NS, self.pose)
        self.node.on_raw_data(pkt, stamp)
        self.i += 1

    def window(self, seconds: float, tracer=None) -> Dict:
        node = self.node
        facade = node.clustering
        frontier0 = facade.first_unpublished_global_column_index
        t0 = time.perf_counter()
        end = t0 + seconds
        feed = self._feed
        if tracer is None:
            while True:
                feed()
                if time.perf_counter() >= end:
                    break
        else:
            # spans around the facade's public call from the node
            self.log.span = tracer.span
            add = facade.add_firing

            def timed_add(firing, pose):
                t = time.perf_counter()
                with tracer.span("add_firing"):
                    add(firing, pose)
                if tracer.state == "wait":   # the share is read before the slice
                    self.inside_s += time.perf_counter() - t

            facade.add_firing = timed_add
            while True:
                with tracer.span("node.on_raw_data"):
                    feed()
                now = time.perf_counter()
                tracer.poll(now, facade.n_steps)
                if now >= end:
                    break
            del facade.add_firing
        synchronize(self.device)
        window_s = time.perf_counter() - t0
        frontier1 = facade.first_unpublished_global_column_index
        out = {
            "window_s": window_s,
            "packets": self.i,
            "points": (points_before(self.cum_points, self.C, frontier1)
                       - points_before(self.cum_points, self.C, frontier0)),
            "latency_ms": None,
            "input_lag_ms": None,
            "n_steps": facade.n_steps,
        }
        if tracer is not None:
            # the spans' share over the part of the window before the slice
            out["inside_facade_s"] = self.inside_s
            out["spans_window_s"] = (tracer.t0 if tracer.state != "wait" else t0 + window_s) - t0
        return out

    def finish(self):
        node = self.node
        node.flush()
        facade = node.clustering
        fu = facade.first_unpublished_global_column_index
        cloud = facade.get_columns(max(fu - self.C, self.C), fu - 1) if fu > self.C + 1 else None
        del self.node, node, facade
        # the firings the decoder made of the packets fed
        per_packet = 12 // (self.R // 32)
        n_firings = (self.i // len(self.packets)) * self.C + min(
            per_packet * (self.i % len(self.packets)), self.C)
        return self.log.clusters(), read_columns(cloud), finished_revolutions(n_firings, self.C)

    def reference_firing(self, k: int) -> Dict[str, np.ndarray]:
        """Firing k of the stream as the reference decodes it from the same
        packets (revolutions 0 to 2 are decoded once)."""
        if self._decoded is None:
            s = self.sensor
            pk = [self.packet(i) for i in range(3 * len(self.packets))]
            self._decoded = decode(pk, self.R, self.vert_deg, s["distance_resolution_m"],
                                   s["firing_cycle_ns"])
            if len(self._decoded) != 3 * self.C:
                raise RuntimeError(f"the reference decoded {len(self._decoded)} firings "
                                   f"of 3 revolutions of {self.C}")
        f = dict(self._decoded[k])
        f["firing_index"] = k
        return f
