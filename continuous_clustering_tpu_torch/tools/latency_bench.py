"""Cluster-publish latency benchmark (the port's counterpart of
``continuous_clustering_tpu/tools/latency_bench.py``).

Streams a synthetic scene at real sensor pacing and measures the latency of
each published cluster w.r.t. its newest point's wall-clock stamp — the
reference's headline ~5 ms metric (README.md:11; measured with the
use_last_point_for_cluster_stamp flag, cfg/ContinuousClustering.cfg:76-78).
Runs on the card unless ``--device cpu`` names the CPU
(``utils.platform.resolve_device``: no card and no ``--device cpu`` raises).

Usage: python -m continuous_clustering_tpu_torch.tools.latency_bench \\
    [--rows 64] [--columns 2200] [--revolutions 5] [--batch 128] [--rpm 600] \\
    [--device cuda|cpu]

Prints one JSON line: the JAX tool's keys, plus ``p95_ms``, the device's
name and, for a card, its power limit (as ``nvidia-smi --query-gpu=
name,power.limit --format=csv,noheader`` gives it), and ``stream_s``, the
wall time from the first paced column to the end of the flush, beside
``real_time_s``, the time the sensor took to deliver those columns.

A column's stamp is the wall clock when it is handed to the pipeline, as in
the JAX tool, so when the pipeline falls behind the pacing the backlog
delays the stamps and the percentiles above do not see it.
``schedule_p50_ms`` / ``schedule_p95_ms`` / ``schedule_p99_ms`` measure the
same clusters from the time the sensor delivered their newest column (its
slot in the pacing), backlog included.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

from ..config import kitti_config
from ..evaluation.synthetic import make_scene, raycast_frame
from ..models.continuous_clustering import ContinuousClustering
from ..utils.cli import CommandLineParser
from ..utils.platform import describe_device, resolve_device
from ..utils.stats import LatencyTracker


def main(argv=None) -> dict:
    p = CommandLineParser(argv if argv is not None else sys.argv[1:])
    rows = int(p.get_value_for_argument("--rows", "64"))
    cols = int(p.get_value_for_argument("--columns", "2200"))
    revolutions = int(p.get_value_for_argument("--revolutions", "5"))
    batch = int(p.get_value_for_argument("--batch", "128"))
    rpm = float(p.get_value_for_argument("--rpm", "600"))
    dev = resolve_device(p.get_value_for_argument("--device", None))

    cfg = kitti_config(single_threaded=False)
    cfg = cfg.replace(
        range_image=cfg.range_image.__class__(num_columns=cols),
        clustering=dataclasses.replace(
            cfg.clustering, use_last_point_for_cluster_stamp=True
        ),
    )
    pipe = ContinuousClustering(cfg, firing_batch_size=batch, device=dev)
    pipe.reset(rows)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))

    tracker = LatencyTracker()
    # the same clusters against the pacing: a column's lateness by its stamp
    schedule, late_ns = LatencyTracker(), {}

    def on_cluster(pts, stamp):
        now = time.time_ns()
        tracker.record_cluster(int(stamp), now)
        schedule.record_cluster(int(stamp) - late_ns.get(int(stamp), 0), now)

    pipe.set_finished_cluster_callback(on_cluster)

    scene = make_scene(num_boxes=20, seed=0, spread=30.0)
    xyz, _ = raycast_frame(scene, num_rows=rows, num_columns=cols, seed=0)

    col_period = 60.0 / rpm / cols  # seconds per column
    rng = np.arange(rows, dtype=np.uint64)

    # warm-up revolution (first launches, allocator)
    for c in range(cols):
        firing = {
            "xyz": xyz[c],
            "stamp": np.full(rows, time.time_ns(), np.uint64),
            "intensity": np.full(rows, 100, np.uint8),
            "firing_index": c,
            "uidx": np.uint64(c * rows) + rng,
        }
        pipe.add_firing(firing, np.eye(4))
    pipe.flush()
    tracker.samples.clear()
    schedule.samples.clear()

    deadline_miss = 0
    t_start = t_next = time.perf_counter()
    for rev in range(revolutions):
        for c in range(cols):
            t_next += col_period
            now = time.perf_counter()
            if now < t_next:
                time.sleep(t_next - now)
            else:
                deadline_miss += 1
            stamp = time.time_ns()
            late_ns[stamp] = int(max(0.0, time.perf_counter() - t_next) * 1e9)
            firing = {
                "xyz": xyz[c],
                "stamp": np.full(rows, stamp, np.uint64),
                "intensity": np.full(rows, 100, np.uint8),
                "firing_index": rev * cols + c,
                "uidx": np.uint64((rev * cols + c) * rows) + rng,
            }
            pipe.add_firing(firing, np.eye(4))
    pipe.flush()
    stream_s = time.perf_counter() - t_start

    out = tracker.percentiles()
    sched = schedule.percentiles()
    out.update({f"schedule_{k}": sched[k] for k in ("p50_ms", "p95_ms", "p99_ms") if k in sched})
    out.update(
        {
            "metric": "cluster_publish_latency",
            "unit": "ms",
            "clusters": len(tracker.samples),
            "deadline_misses": deadline_miss,
            "columns_per_second": cols * rpm / 60.0,
            "stream_s": stream_s,
            "real_time_s": revolutions * 60.0 / rpm,
            "rows": rows,
            "columns": cols,
            "batch": batch,
        }
    )
    out.update(describe_device(dev))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
