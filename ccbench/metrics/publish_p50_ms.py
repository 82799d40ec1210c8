"""Median over all clusters published in the window of the callback's wall
time less the scheduled arrival of the cluster's newest column (frozen
``latency.percentiles``)."""

from ccbench.frozen.latency import percentiles


def read(run):
    lat = run.window.get("latency_ms")
    return percentiles(lat)["p50_ms"] if lat else None
