"""The port's tracing registry (``utils/stats.py``: ``StageTimer``, the
process's ``TRACE``) on the CPU: spans nest with their parent, step and
self time; every device-to-host read of a host-insertion stream is counted;
with tracing off no ``record_function`` is opened, no CUDA event recorded,
no synchronisation added and a step reads the clock about 30 times; under
``torch.profiler`` every step layer is a user annotation; the benchmark's
readers of the registry take the steps before the profiled slice.

Streams are 32 x 220 (the facade tests' size) through the port's own scene
generator; host insertion needs ``g++`` and skips without it.
"""

from __future__ import annotations

import shutil
import threading
import types

import numpy as np
import pytest
import torch

from ccbench import harness
from continuous_clustering_tpu_torch.config import kitti_config
from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings, make_scene,
                                                                  raycast_frame)
from continuous_clustering_tpu_torch.io.node import ClusteringNode
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
from continuous_clustering_tpu_torch.utils import stats

from .test_torch_step import one_torch_thread  # noqa: F401

ROWS, COLS = 32, 220
STEP_SPANS = ("step.ingest", "step.ground_segmentation", "step.association",
              "step.association.cc", "step.finish")
DEVICE_STEP_SPANS = ("step.insertion", "step.frontier", "step.ground_segmentation",
                     "step.association", "step.association.cc", "step.finish")
# torch.Tensor methods that read a tensor's values into the host
READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__", "__index__")


def small_config():
    cfg = kitti_config()
    return cfg.replace(range_image=cfg.range_image.__class__(num_columns=COLS,
                                                             ring_buffer_revolutions=4))


def stream(frames=2, seed=3):
    scene = make_scene(num_boxes=8, seed=seed, spread=20.0)
    firings = []
    for f in range(frames):
        xyz, _ = raycast_frame(scene, num_rows=ROWS, num_columns=COLS, seed=seed + f)
        firings += frame_to_firings(xyz, frame_index=f)
    return firings


def run_stream(insertion="host", frames=2, batch=64):
    """A pipeline fed ``frames`` revolutions and flushed; the registry holds
    only its steps."""
    if insertion == "host" and shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")
    firings = stream(frames)
    pipe = ContinuousClustering(small_config(), firing_batch_size=batch, device="cpu",
                                insertion=insertion)
    pipe.reset(ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    clusters = []
    pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append(stamp))
    pipe.set_finished_column_callback(lambda a, b, ground_only: None)
    stats.TRACE.clear()
    for f in firings:
        pipe.add_firing(f, np.eye(4))
    pipe.flush()
    assert clusters, "the stream published no cluster"
    return pipe


@pytest.fixture
def clock(monkeypatch):
    """The registry's clock, advanced by hand."""
    now = types.SimpleNamespace(ns=0)
    monkeypatch.setattr(stats, "_clock", lambda: now.ns)
    return now


def test_spans_nest_with_parent_step_and_self_time(clock):
    reg = stats.StageTimer()
    reg.step(7)
    with reg.span("a"):
        clock.ns += 10
        with reg.span("b"):
            clock.ns += 100
        clock.ns += 10
        reg.step(8)
        with reg.span("c"):
            clock.ns += 1000
            other = []
            t = threading.Thread(target=lambda: other.append(reg.span("d").__enter__()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            other[0].__exit__(None, None, None)
        clock.ns += 1
    s = {name: (sid, parent, step, t0, t1) for name, sid, parent, step, t0, t1 in reg.spans()}
    assert s["a"][1] == -1 and s["b"][1] == s["a"][0] and s["c"][1] == s["a"][0]
    assert s["d"][1] == -1          # a span of another thread has none of this one's parents
    assert (s["a"][2], s["b"][2], s["c"][2]) == (7, 7, 8)
    assert s["a"][4] - s["a"][3] == 1121 and s["c"][4] - s["c"][3] == 1000
    w = reg.window(0)
    assert w["steps"] == 2
    assert w["spans"]["a"] == {"total_ns": 1121, "self_ns": 1121 - 100 - 1000, "count": 1}
    assert w["spans"]["b"]["self_ns"] == 100 and w["spans"]["c"]["self_ns"] == 1000
    assert reg.summary()["a"]["count"] == 1


def test_host_syncs_count_every_device_to_host_read(monkeypatch, one_torch_thread):
    """``facade.host_syncs`` over a host-insertion stream equals the reads
    of tensor values into the host that a tally of torch's own read methods
    sees: every read goes through ``to_host``/``host_bool``, which count it
    once.  On the CPU the ground segmentation kernel is never launched."""
    tally = {"n": 0}

    def counted(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            tally["n"] += 1
            return orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, read)

    for name in READS:
        counted(name)
    pipe = run_stream("host")
    w = stats.TRACE.window(0)
    assert w["steps"] == pipe.n_steps > 4
    syncs = w["counts"]["facade.host_syncs"]
    assert syncs == tally["n"]
    # the meta read of every step, FastSV's checks, the twin's rounds and
    # the slab of the steps that emit
    assert syncs >= 3 * pipe.n_steps
    assert w["counts"]["step.cc_rounds"] >= pipe.n_steps
    assert w["counts"]["facade.uploads"] >= pipe.n_steps
    assert stats.TRACE.snapshot()["launches"]["ground_segment"] == 0


@pytest.mark.parametrize("insertion", ["host", "device"])
def test_tracing_off_adds_no_range_event_or_sync(monkeypatch, insertion, one_torch_thread):
    """With the profiler off and ``enable()`` not called a step opens no
    ``record_function``, records no CUDA event, adds no synchronisation
    (the reads are the counted ones: the test above), and the registry
    reads the clock at most ~30 times a step."""

    def refuse(*a, **k):
        raise AssertionError("tracing is off")

    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    ticks = {"n": 0}
    orig_clock = stats._clock

    def clock():
        ticks["n"] += 1
        return orig_clock()

    monkeypatch.setattr(stats, "_clock", clock)
    pipe = run_stream(insertion, frames=1 if insertion == "device" else 2)
    w = stats.TRACE.window(0)
    assert not stats.TRACE._pending and not w["device_ns"]
    assert ticks["n"] <= 30 * pipe.n_steps
    assert "facade.meta_wait" in w["spans"] and "step.association" in w["spans"]


@pytest.mark.parametrize("insertion", ["host", "device"])
def test_step_layers_are_user_annotations_under_the_profiler(insertion, one_torch_thread):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe = run_stream(insertion, frames=1)
    assert pipe.n_steps >= 2
    marked = {e.name() for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    want = STEP_SPANS if insertion == "host" else DEVICE_STEP_SPANS
    assert set(want) <= marked, set(want) - marked
    assert {"facade.batch", "facade.upload", "facade.meta_wait"} <= marked
    assert stats.TRACE.profiler_started_ns is not None


def test_node_counts_its_pose_lookups(one_torch_thread):
    """``node.tf_lookups`` counts the firings the node's transform
    synchronizer releases, ``node.tf_history`` the length of the pose
    history each of those lookups searched."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")
    node = ClusteringNode(small_config(), sensor_manufacturer="generic_points",
                          firing_batch_size=64, device="cpu")
    sync, histories = node.tf_sync, []
    release = sync._cb

    def counted(firing, pose):
        histories.append(len(sync._poses))
        release(firing, pose)

    sync.set_callback(counted)
    xyz, _ = raycast_frame(make_scene(num_boxes=8, seed=3, spread=20.0), num_rows=ROWS,
                           num_columns=COLS)
    stats.TRACE.clear()
    for c in range(2 * COLS):
        stamp = 10**9 + c * 400_000
        if c % 3 == 0:                  # a pose for every third firing
            node.on_transform(stamp + 1, np.eye(4))
        node.on_points(xyz[c % COLS], stamp)
    node.flush()
    counts = stats.TRACE.window(0)["counts"]
    assert len(histories) > COLS and histories[-1] > histories[0]
    assert counts["node.tf_lookups"] == len(histories)
    assert counts["node.tf_history"] == sum(histories)


# ------------------------------------------------------- the benchmark's readers
NEW_METRICS = ("step.ground_segmentation_ms", "step.association_ms", "step.insertion_ms",
               "facade.host_syncs_per_step", "facade.meta_wait_ms.paced",
               "node.host_ms_per_rev")
S = 1_000_000_000


def synthetic_ring(clock) -> stats.StageTimer:
    """Steps every second from t = 1 s; each step: node spans (1 ms of
    enqueue, a 5 ms firing holding a 2 ms tf sync that holds a 1 ms facade
    batch), ground segmentation 3 ms, association 4 ms holding 1 ms of
    kernels, insertion 6 ms, meta wait 2 ms, 5 host syncs, 100 firings.
    Steps from t = 8 s run twice as long: the profiler started at 8 s."""
    reg = stats.StageTimer()

    def timed(name, ms, inner=()):
        with reg.span(name):
            for sub in inner:
                timed(*sub)
            clock.ns += int(ms * 1e6)

    for k in range(1, 13):
        clock.ns = k * S
        reg.step(k)
        slow = 2 if k >= 8 else 1
        if k == 8:
            reg.profiler_started_ns = clock.ns
        timed("node.enqueue", 1 * slow)
        timed("node.firing", 2 * slow, [("node.tf_sync", 1 * slow,
                                         [("facade.batch", 1 * slow)])])
        timed("step.ground_segmentation", 3 * slow)
        timed("step.association", 3 * slow, [("step.association.cc", 1 * slow)])
        timed("step.insertion", 6 * slow)
        timed("facade.meta_wait", 2 * slow)
        reg.count("facade.host_syncs", 5 * slow)
        reg.count("node.firings", 100)
    return reg


def reading(name, start_s=5.0):
    cell = types.SimpleNamespace(traffic={"trace": {"steps": 2, "start_s": start_s}},
                                 config={"sensor": {"columns": 1700}})
    return harness.reader(name)(harness.Run(cell=cell, setup_s=1.0,
                                            window={"window_s": 30.0}, trace=None))


def test_readers_take_the_steps_before_the_profiled_slice(monkeypatch, clock):
    monkeypatch.setattr(stats, "TRACE", synthetic_ring(clock))
    # steps 3-7: begun in the 5 s before the profiler's start, ended by it
    assert stats.TRACE.window(3 * S, 8 * S)["steps"] == 5
    assert reading("step.ground_segmentation_ms") == pytest.approx(3.0)
    assert reading("step.association_ms") == pytest.approx(4.0)
    assert reading("step.insertion_ms") == pytest.approx(6.0)
    assert reading("facade.meta_wait_ms.paced") == pytest.approx(2.0)
    assert reading("facade.host_syncs_per_step") == pytest.approx(5.0)
    # node self time 1 + 2 + 1 ms a step (the facade's batch left out), 17
    # steps of 100 firings to a revolution of 1,700 columns
    assert reading("node.host_ms_per_rev") == pytest.approx(4.0 * 17)
    # a shorter lead takes fewer steps, the same per-step values
    assert reading("step.insertion_ms", start_s=2.0) == pytest.approx(6.0)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_read_nothing_from_an_empty_registry(monkeypatch, clock, name):
    monkeypatch.setattr(stats, "TRACE", stats.StageTimer())
    assert reading(name) is None                     # the profiler never seen
    stats.TRACE.profiler_started_ns = 10 * S
    assert reading(name) is None                     # no step before it
    monkeypatch.delattr(stats, "TRACE")
    assert reading(name) is None                     # a program without the registry
