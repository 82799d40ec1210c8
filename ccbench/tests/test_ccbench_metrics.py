"""The end-to-end numbers are taken over the whole window and every
cluster of it; the trace's reduction of device activity."""

from __future__ import annotations


import numpy as np
import pytest

from ccbench import harness
from ccbench.drivers.common import ClusterLog
from ccbench.trace import TraceRecord, _busy_and_gaps


def run(window, trace=None, setup_s=1.5):
    return harness.Run(cell=None, setup_s=setup_s, window=window, trace=trace)


def test_rate_is_points_over_the_whole_window():
    r = run({"points": 1_000_000, "window_s": 8.0})
    assert harness.reader("points_per_s")(r) == pytest.approx(125_000.0)
    assert harness.reader("points_per_s")(run({"points": 0, "window_s": 8.0})) is None


def test_latency_percentiles_take_every_cluster_of_the_window():
    log = ClusterLog()
    rec = np.zeros(3, dtype=[("global_column_index", "i8"), ("row_index", "u2"),
                             ("x", "f4"), ("y", "f4"), ("z", "f4")])
    for i in range(200):
        log(rec, 0)
        t, _, pts = log.entries[-1]
        log.entries[-1] = (1_000_000_000 + i * 1_000_000, 1_000_000_000 - 5_000_000, pts)
    lat = log.latencies_ms(1_000_000_000, 1_000_000_000 + 100 * 1_000_000)
    assert len(lat) == 100                      # the window's clusters, all of them
    assert lat == [5.0 + i for i in range(100)]
    r = run({"latency_ms": lat})
    assert harness.reader("publish_p50_ms")(r) == pytest.approx(np.percentile(lat, 50))
    assert harness.reader("publish_p95_ms")(r) == pytest.approx(np.percentile(lat, 95))


def test_input_lag_and_outside_share():
    lags = list(np.linspace(0.0, 10.0, 101))
    assert harness.reader("facade.input_lag_p95_ms.paced")(
        run({"input_lag_ms": lags})) == pytest.approx(9.5)
    r = run({"window_s": 12.0, "spans_window_s": 10.0, "inside_facade_s": 8.0})
    assert harness.reader("node.outside_facade_pct")(r) == pytest.approx(20.0)
    assert harness.reader("node.outside_facade_pct")(run({"window_s": 10.0})) is None


def test_trace_readers():
    t = TraceRecord(busy_s=0.25, window_s=1.0, steps=4, kernels=36_000, device_ops=[],
                    idle_gaps=[], roofline_pct={"edge_bits": 12.5, "window_cc": None})
    assert harness.reader("device.idle_pct")(run({}, t)) == pytest.approx(75.0)
    assert harness.reader("device.kernels_per_step")(run({}, t)) == 9000
    assert harness.reader("device.kernels_per_step.paced")(run({}, t)) == 9000
    assert harness.reader("edge_bits_roofline")(run({}, t)) == 12.5
    assert harness.reader("window_cc_roofline")(run({}, t)) is None
    assert harness.reader("device.idle_pct")(run({}, None)) is None


def test_busy_is_the_union_and_gaps_the_rest():
    ev = [("k", True, False, 10, 20), ("k", True, False, 15, 30), ("k", True, False, 50, 60)]
    busy, gaps = _busy_and_gaps(ev, 0, 100)
    assert busy == 30
    assert gaps == [(0, 10), (30, 50), (60, 100)]
