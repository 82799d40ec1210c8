"""Observability: workload recording, stage timing, latency tracking (the
port's copy of ``continuous_clustering_tpu/utils/stats.py``).

Covers the reference's debug facilities (recordJobQueueWorkload,
src/clustering/continuous_clustering.cpp:1147-1159; per-sequence wall clock,
kitti_demo.cpp:421-437) plus what a device deployment needs: per-step
timing and end-to-end cluster-publish latency percentiles.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np


class WorkloadRecorder:
    """Queue-depth samples across pipeline stages (bounded like the
    reference's 100k-sample ring)."""

    def __init__(self, stages=("sensor", "fifo", "device", "publish"), max_samples=100_000):
        self.stages = stages
        self.samples: Deque[tuple] = deque(maxlen=max_samples)

    def record(self, **depths: int) -> None:
        self.samples.append(tuple(depths.get(s, 0) for s in self.stages))

    def summary(self) -> Dict[str, Dict[str, float]]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples, dtype=np.float64)
        return {
            s: {
                "mean": float(arr[:, i].mean()),
                "max": float(arr[:, i].max()),
                "p95": float(np.percentile(arr[:, i], 95)),
            }
            for i, s in enumerate(self.stages)
        }


class StageTimer:
    """Wall-clock accumulation per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    class _Ctx:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timer.totals[self.name] = self.timer.totals.get(self.name, 0.0) + dt
            self.timer.counts[self.name] = self.timer.counts.get(self.name, 0) + 1

    def track(self, name: str) -> "StageTimer._Ctx":
        return self._Ctx(self, name)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_ms": 1e3 * v / self.counts[k]}
            for k, v in self.totals.items()
        }


class LatencyTracker:
    """Cluster-publish latency w.r.t. the newest point stamp in the cluster
    (the reference's headline ~5 ms metric, README.md:11)."""

    def __init__(self, max_samples: int = 100_000):
        self.samples: Deque[float] = deque(maxlen=max_samples)

    def record_cluster(self, max_point_stamp_ns: int, wall_publish_ns: Optional[int] = None):
        now = wall_publish_ns if wall_publish_ns is not None else time.time_ns()
        self.samples.append((now - max_point_stamp_ns) / 1e6)  # ms

    def percentiles(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "p95_ms": float(np.percentile(arr, 95)),
            "p99_ms": float(np.percentile(arr, 99)),
            "mean_ms": float(arr.mean()),
        }
