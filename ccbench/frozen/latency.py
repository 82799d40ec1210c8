# FROZEN COPY of the percentile arithmetic of
# ``continuous_clustering_tpu_torch/utils/stats.py::LatencyTracker``
# (``record_cluster`` and ``percentiles``, utils/stats.py:72-94) and of the
# pacing idea of ``tools/latency_bench.py`` (``schedule_*``: a cluster's
# latency counted from the slot in which the sensor delivered its newest
# column, backlog included) at commit cce7c49ab9acd93ca72165a17ff47a74717926ce.
#
# Part of the benchmark's yardstick: later changes to the program do not
# edit this file.

"""Publish latency: a cluster's callback wall time less the scheduled
arrival of its newest column, in ms, and numpy's linear percentiles over
all of them."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def latency_ms(wall_publish_ns: int, newest_scheduled_ns: int) -> float:
    return (wall_publish_ns - newest_scheduled_ns) / 1e6


def percentiles(samples_ms: Sequence[float]) -> Dict[str, float]:
    if len(samples_ms) == 0:
        return {}
    arr = np.asarray(samples_ms, dtype=np.float64)
    return {
        "p50_ms": float(np.percentile(arr, 50)),
        "p90_ms": float(np.percentile(arr, 90)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
        "mean_ms": float(arr.mean()),
    }
