"""Workload statistics reporting (the port's copy of
``continuous_clustering_tpu/tools/plot_workload.py``): it reads the port
facade's ``workload`` recorder and ``stats`` timers.

The reference records per-firing queue depths for a (never-written) plotting
script (src/debugging/plot_job_queue_sizes.py is empty;
recordJobQueueWorkload at src/clustering/continuous_clustering.cpp:1147).
This tool completes the story: dump a pipeline's workload/timing/latency
summaries as JSON (optionally CSV of the raw samples for external plotting).

Library use:
    from continuous_clustering_tpu_torch.tools.plot_workload import report
    print(report(pipe))
"""

from __future__ import annotations

import csv
import io
import json


def report(pipe, latency_tracker=None) -> str:
    out = {
        "workload": pipe.workload.summary(),
        "stage_timing": pipe.stats.summary(),
    }
    if latency_tracker is not None:
        out["latency"] = latency_tracker.percentiles()
    return json.dumps(out, indent=2)


def samples_csv(pipe) -> str:
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(pipe.workload.stages)
    for row in pipe.workload.samples:
        w.writerow(row)
    return buf.getvalue()
