"""The port's ROS 1 bridge (``io/ros_bridge.py``) on the CPU, under stub ROS
modules.

The tests need no ROS installation: each test that needs ``rospy`` and the
message packages puts small stand-ins of ``rospy``, ``sensor_msgs.msg``,
``rosgraph_msgs.msg``, ``visualization_msgs.msg``, ``geometry_msgs.msg`` and
``tf2_ros`` into ``sys.modules`` (monkeypatched, so they are removed after
the test).  Under them:

* ``structured_to_pointcloud2`` equals the JAX package's on every stage's
  cloud: fields, offsets and datatypes (int64/uint64 sent as FLOAT64),
  ``point_step``, ``row_step``, the data bytes and the header;
* the tf, clock and marker conversions equal the JAX package's;
* ``RosBridge`` advertises the four topics of the reference node under a
  namespace, and a port ``ClusteringNode`` on the CPU driven through two
  revolutions publishes through every hook;
* without ROS, the bridge raises ``ImportError``.
"""

from __future__ import annotations

import shutil
import sys
import types

import numpy as np
import pytest

from continuous_clustering_tpu.io import ros_bridge as jax_bridge
from continuous_clustering_tpu_torch.config import Config
from continuous_clustering_tpu_torch.evaluation.synthetic import make_scene, raycast_frame
from continuous_clustering_tpu_torch.io import publish_utils, ros_bridge
from continuous_clustering_tpu_torch.io.node import ClusteringNode
from continuous_clustering_tpu_torch.io.point_cloud import ProcessingStage, empty_cloud

from .test_torch_step import one_torch_thread  # noqa: F401

NUM_ROWS, NUM_COLS = 16, 110


class Msg:
    """A ROS message stand-in: any attribute can be set, and a nested one
    springs into being on first read (``msg.header.stamp = ...``)."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        value = Msg()
        object.__setattr__(self, name, value)
        return value


class Time:
    def __init__(self, secs=0, nsecs=0):
        self.secs, self.nsecs = secs, nsecs

    def to_nsec(self):
        return self.secs * 10**9 + self.nsecs

    @staticmethod
    def now():
        return Time(secs=1_700_000_000, nsecs=5)


class PointField(Msg):
    INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)

    def __init__(self, name="", offset=0, datatype=0, count=0):
        self.name, self.offset, self.datatype, self.count = name, offset, datatype, count


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


@pytest.fixture
def ros(monkeypatch):
    """Stub ROS modules in ``sys.modules``; yields the publishers and the
    transforms sent."""
    sent = {"publishers": [], "tf": []}

    class Publisher:
        def __init__(self, topic, msg_type, queue_size=None, latch=False):
            self.topic, self.msg_type, self.latch, self.msgs = topic, msg_type, latch, []
            sent["publishers"].append(self)

        def publish(self, msg):
            self.msgs.append(msg)

    class TransformBroadcaster:
        def sendTransform(self, msg):  # noqa: N802 (the ROS name)
            sent["tf"].append(msg)

    msgs = {
        "sensor_msgs": {"PointCloud2": type("PointCloud2", (Msg,), {}), "PointField": PointField},
        "rosgraph_msgs": {"Clock": type("Clock", (Msg,), {})},
        "visualization_msgs": {"Marker": type("Marker", (Msg,), {"CUBE": 1})},
        "geometry_msgs": {"TransformStamped": type("TransformStamped", (Msg,), {})},
    }
    for pkg, classes in msgs.items():
        sub = _module(f"{pkg}.msg", **classes)
        monkeypatch.setitem(sys.modules, pkg, _module(pkg, msg=sub))
        monkeypatch.setitem(sys.modules, f"{pkg}.msg", sub)
    monkeypatch.setitem(sys.modules, "rospy", _module(
        "rospy", Time=Time, Publisher=Publisher, spin=lambda: None))
    monkeypatch.setitem(sys.modules, "tf2_ros", _module(
        "tf2_ros", TransformBroadcaster=TransformBroadcaster))
    yield sent


def pc2_dict(msg):
    return {
        "fields": [(f.name, f.offset, f.datatype, f.count) for f in msg.fields],
        "point_step": msg.point_step, "row_step": msg.row_step, "height": msg.height,
        "width": msg.width, "data": msg.data, "is_dense": msg.is_dense,
        "frame_id": msg.header.frame_id, "stamp": (msg.header.stamp.secs, msg.header.stamp.nsecs),
    }


def random_cloud(stage, n=37, seed=0):
    rng = np.random.default_rng(seed)
    cloud = empty_cloud(n, stage)
    for name in cloud.dtype.names:
        dt = cloud.dtype[name]
        if dt.kind == "f":
            cloud[name] = rng.normal(size=n) * 10
        else:
            hi = min(np.iinfo(dt).max, 2**40)
            cloud[name] = rng.integers(0, hi, n, dtype=np.int64).astype(dt)
    return cloud


@pytest.mark.parametrize("stage", list(ProcessingStage), ids=lambda s: s.name)
def test_pointcloud2_equals_jax(ros, stage):
    cloud = random_cloud(stage, seed=stage.value)
    stamp = 1_234_567_890_123_456_789
    got = pc2_dict(ros_bridge.structured_to_pointcloud2(cloud, "odom", stamp))
    assert got == pc2_dict(jax_bridge.structured_to_pointcloud2(cloud, "odom", stamp))
    assert got["stamp"] == (1_234_567_890, 123_456_789)
    wide = [f for f in got["fields"] if cloud.dtype[f[0]].itemsize == 8]
    assert wide and all(f[2] == PointField.FLOAT64 for f in wide)
    assert got["point_step"] * len(cloud) == len(got["data"]) == got["row_step"]
    gui = [f for f in got["fields"] if f[0] == "globally_unique_point_index"]
    if gui:
        packed = np.frombuffer(got["data"], np.uint8).reshape(len(cloud), -1)
        off = gui[0][1]
        vals = packed[:, off:off + 8].copy().view(np.float64)[:, 0]
        np.testing.assert_array_equal(vals, cloud["globally_unique_point_index"].astype(np.float64))


def test_message_conversions_equal_jax(ros):
    T = np.eye(4)
    T[:3, 3] = [1.0, -2.0, 0.5]
    tf = publish_utils.make_tf_message(T, 3 * 10**9 + 7)
    a, b = ros_bridge.tf_message_to_ros(tf), jax_bridge.tf_message_to_ros(tf)
    for m in (a, b):
        assert (m.header.stamp.secs, m.header.stamp.nsecs) == (3, 7)
    assert (a.header.frame_id, a.child_frame_id) == (b.header.frame_id, b.child_frame_id)
    for part in ("translation", "rotation"):
        pa, pb = getattr(a.transform, part), getattr(b.transform, part)
        assert vars(pa) == vars(pb)
    clock = publish_utils.make_clock_message(5 * 10**9 + 9)
    assert vars(ros_bridge.clock_message_to_ros(clock).clock) == vars(
        jax_bridge.clock_message_to_ros(clock).clock)
    marker = publish_utils.make_ego_bounding_box_marker(11, Config().ground_segmentation)
    ma, mb = ros_bridge.marker_message_to_ros(marker), jax_bridge.marker_message_to_ros(marker)
    for part in ("color", "scale"):
        assert vars(getattr(ma, part)) == vars(getattr(mb, part))
    assert vars(ma.pose.position) == vars(mb.pose.position)
    assert (ma.ns, ma.id, ma.type, ma.frame_locked) == (mb.ns, mb.id, mb.type, mb.frame_locked)


def test_bridge_wires_the_node_hooks(ros):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the port's native library")
    cfg = Config()
    cfg = cfg.replace(range_image=cfg.range_image.__class__(num_columns=NUM_COLS,
                                                            ring_buffer_revolutions=4))
    node = ClusteringNode(cfg, sensor_manufacturer="generic_points", firing_batch_size=32,
                          device="cpu")
    bridge = ros_bridge.RosBridge(node, namespace="/car/")
    topics = {p.topic: p for p in ros["publishers"]}
    assert set(topics) == {"/car/raw_firings", "/car/continuous_ground_point_segmentation",
                           "/car/continuous_instance_segmentation", "/car/continuous_clusters",
                           "/clock", "/car/ego_robot_bounding_box"}
    assert topics["/car/ego_robot_bounding_box"].latch and bridge.node is node

    scene = make_scene(num_boxes=4, seed=0, spread=15.0)
    xyz = raycast_frame(scene, num_rows=NUM_ROWS, num_columns=NUM_COLS)[0]
    t0 = 1_000_000_000
    for k in range(2 * NUM_COLS):
        stamp = t0 + k * 400_000
        node.on_transform(stamp + 1, np.eye(4))
        node.on_points(xyz[k % NUM_COLS], stamp)
    node.flush()
    counts = {t: len(p.msgs) for t, p in topics.items()}
    assert counts["/car/raw_firings"] == counts["/clock"] == 2 * NUM_COLS == len(ros["tf"])
    assert counts["/car/ego_robot_bounding_box"] == 1
    assert all(counts[t] > 0 for t in topics), counts
    firing = topics["/car/raw_firings"].msgs[0]
    assert firing.width == NUM_ROWS and firing.header.frame_id == "odom"
    assert [f.name for f in firing.fields][:3] == ["x", "y", "z"]
    for cloud in topics["/car/continuous_clusters"].msgs:
        assert cloud.width > 20 and cloud.point_step * cloud.width == len(cloud.data)


def test_bridge_raises_import_error_without_ros(monkeypatch):
    for name in ("rospy", "sensor_msgs", "sensor_msgs.msg"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="rospy"):
        ros_bridge.structured_to_pointcloud2(empty_cloud(1), "odom", 0)
    with pytest.raises(ImportError, match="continuous_clustering_tpu_torch works"):
        ros_bridge.RosBridge(object())
