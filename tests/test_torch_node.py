"""The port's sensor entry point on the CPU: ``io/node.py``
(``ClusteringNode``), ``io/transform_synchronizer.py``,
``io/publish_utils.py`` and the ``launch.py`` presets, against the JAX
package's.

* The scenarios of ``tests/test_node.py`` run against the port's node
  (``device="cpu"``).
* One seeded VLP-16 packet stream goes through the JAX node and the port's
  node, both decoding in NumPy (the JAX package's native library is not
  built here, so its node decodes in NumPy) and both inserting on the same
  path (the JAX facade inserts on the device when its native library is
  absent, on the host when it is present): the published clusters (point
  sets by (column, row), ids and stamps) and the column callbacks' ranges
  must be equal.
* ``pipeline_step_block`` under the OS-32 preset (fog filtering on,
  chessboard and inclination-difference filters off) and the VLS-128 preset,
  at 32 x 110, against the JAX step: every state field and meta lane after
  every step, at ``tests/test_torch_step.py``'s tolerance (exact, except
  ``finish_az``/``slot_finish`` within 2 ulp of XLA's f32 arcsin).
* The VLS-128 preset from raw packets through the decode thread, async
  against sync at 128 rows: the same partition, and no packet left in the
  decode queue after ``flush``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from continuous_clustering_tpu import launch as jax_launch
from continuous_clustering_tpu import native as jax_native
from continuous_clustering_tpu.config import Config as JaxConfig
from continuous_clustering_tpu.io import publish_utils as jax_publish_utils
from continuous_clustering_tpu.io.node import ClusteringNode as JaxClusteringNode
from continuous_clustering_tpu_torch import launch
from continuous_clustering_tpu_torch.config import Config, GroundSegmentationConfig, kitti_config
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.evaluation import kitti_loader as kl
from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
from continuous_clustering_tpu_torch.evaluation.synthetic import make_scene, raycast_frame
from continuous_clustering_tpu_torch.io import publish_utils
from continuous_clustering_tpu_torch.io.node import ClusteringNode
from continuous_clustering_tpu_torch.io.transform_synchronizer import TransformSynchronizer
from continuous_clustering_tpu_torch.models.step import pipeline_step_block
from continuous_clustering_tpu_torch.ops.state import init_state
from continuous_clustering_tpu_torch.tools import sensor_packets as sp

from .test_torch_step import (HSG, assert_slabs_equal, assert_states_equal, column_blocks,
                              jax_state_numpy, one_torch_thread,  # noqa: F401
                              to_torch_block)

NUM_ROWS = 16
NUM_COLS = 110
VLP16_COLS = 440    # the packet streams: 0.8 degrees a column


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the port's native library")


def make_node(wait_for_tf=True, **kw):
    cfg = Config()
    cfg = cfg.replace(range_image=cfg.range_image.__class__(num_columns=NUM_COLS,
                                                            ring_buffer_revolutions=4))
    return ClusteringNode(cfg, sensor_manufacturer="generic_points", wait_for_tf=wait_for_tf,
                          firing_batch_size=32, device="cpu", **kw)


def frame(seed=0, num_boxes=4, spread=15.0):
    scene = make_scene(num_boxes=num_boxes, seed=seed, spread=spread)
    return raycast_frame(scene, num_rows=NUM_ROWS, num_columns=NUM_COLS)[0]


# ----------------------------------------------------- test_node.py's scenarios

def test_node_end_to_end():
    node = make_node()
    ground_cols, inst_cols, clusters = [], [], []
    node.publish_ground_columns = lambda cloud: ground_cols.append(len(cloud))
    node.publish_instance_columns = lambda cloud: inst_cols.append(len(cloud))
    node.publish_cluster = lambda pts, stamp: clusters.append(len(pts))
    xyz = frame()
    t0 = 1_000_000_000
    for rev in range(2):
        for c in range(NUM_COLS):
            stamp = t0 + (rev * NUM_COLS + c) * 400_000
            node.on_transform(stamp + 1, np.eye(4))
            node.on_points(xyz[c], stamp)
    node.flush()
    assert node.device == torch.device("cpu") and node.clustering.state.x.device.type == "cpu"
    assert ground_cols and inst_cols
    assert clusters and all(n > 20 for n in clusters)


def test_node_time_jump_resets():
    node = make_node(wait_for_tf=False)
    xyz = frame(seed=1, num_boxes=2, spread=10.0)
    t0 = 1_000_000_000
    node.on_transform(t0, np.eye(4))
    for c in range(100):
        node.on_points(xyz[c], t0 + c * 400_000)
    assert node.clustering._h_first_unfinished >= 0
    # a jump > 0.1 s resets the whole pipeline (reference …node.cpp:110-131)
    node.on_transform(t0 + 10**10, np.eye(4))
    node.on_points(xyz[0], t0 + 10**10)
    assert node.clustering._h_first_unfinished == -1


def test_transform_synchronizer_buffers():
    sync = TransformSynchronizer(wait_for_tf=True)
    out = []
    sync.set_callback(lambda msg, pose: out.append((msg, pose[0, 3])))
    sync.add_message(100, "a")
    assert out == []                    # no tf yet
    p = np.eye(4)
    p[0, 3] = 7.0
    sync.add_transform(50, np.eye(4))
    assert out == []                    # tf older than the message
    sync.add_transform(150, p)
    assert len(out) == 1 and out[0][0] == "a"
    assert abs(out[0][1] - 3.5) < 1e-9  # interpolated at stamp 100


def test_transform_synchronizer_equals_jax():
    """The port's synchronizer (with its copy of the pose interpolation)
    releases the same messages with the same poses as the JAX one."""
    from continuous_clustering_tpu.io.transform_synchronizer import \
        TransformSynchronizer as JaxSync

    rng = np.random.default_rng(3)
    poses = []
    for k in range(20):
        a = 0.3 * k
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        pose[:3, 3] = rng.normal(size=3)
        poses.append(pose)
    out = {}
    for name, cls in (("port", TransformSynchronizer), ("jax", JaxSync)):
        sync, got = cls(wait_for_tf=True), []
        sync.set_callback(lambda msg, pose, got=got: got.append((msg, pose.copy())))
        for k, pose in enumerate(poses):
            sync.add_transform(1000 * k, pose)
            sync.add_message(1000 * k + 250, k)
            if k % 7 == 6:
                sync.reset()
        out[name] = got
    assert [m for m, _ in out["port"]] == [m for m, _ in out["jax"]] and out["port"]
    for (_, a), (_, b) in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)


class ListSynchronizer:
    """The synchronizer as it was before its history was indexed: every
    release calls ``kitti_loader.interpolate`` over the whole pose list."""

    def __init__(self, wait_for_tf=True, buffer_length=1000):
        self.wait_for_tf = wait_for_tf
        self._poses = []
        self._queue = collections.deque(maxlen=buffer_length)
        self._cb = None

    def set_callback(self, cb):
        self._cb = cb

    def reset(self, clear_poses=False):
        if clear_poses:
            self._poses.clear()
        self._queue.clear()

    def add_transform(self, stamp, pose):
        self._poses.append(kl.StampedPose(stamp, np.asarray(pose, np.float64)))
        if len(self._poses) > 10000:
            del self._poses[:5000]
        self._drain()

    def add_message(self, stamp, msg):
        if not self.wait_for_tf:
            if self._poses and self._cb:
                self._cb(msg, self._poses[-1].pose)
            return
        self._queue.append((stamp, msg))
        self._drain()

    def _drain(self):
        while self._queue and self._poses and self._poses[-1].stamp >= self._queue[0][0]:
            stamp, msg = self._queue.popleft()
            pose = kl.interpolate(self._poses, stamp).pose
            if self._cb:
                self._cb(msg, pose)


def random_pose(rng):
    """A rotation about a random axis by up to 180 degrees (both branches
    of the quaternion from a matrix, both of the slerp) and a translation."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    pose = np.eye(4)
    pose[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    pose[:3, 3] = rng.normal(size=3) * 10
    return pose


def sync_stream(case, rng):
    """(wait_for_tf, events): ("tf", stamp, pose), ("msg", stamp, id) and
    ("reset", clear_poses, None) in the order they are fed."""
    ev = []
    if case == "cut":
        # 12,000 poses cross the 10,000 -> 5,000 cut; between them messages,
        # some stamped before the oldest pose the cut keeps
        pose = np.eye(4)
        for k in range(12_000):
            if k % 50 == 0:
                pose = random_pose(rng)
            ev.append(("tf", 10**9 + 1000 * k, pose))
            if k % 5 == 4:
                ev.append(("msg", 10**9 + 1000 * k - int(rng.integers(0, 4000)), k))
            if k % 997 == 0:
                ev.append(("msg", 10**9 + 1000 * (k - 6000), -k))
        return True, ev
    stamps = 10**9 + 1000 * np.arange(40)
    if case == "unordered":
        stamps = stamps + rng.integers(-2500, 2500, 40)   # out of order
        stamps[5:9] = stamps[4]                             # repeated stamps
        stamps[20:23] = stamps[30]
    for k, s in enumerate(stamps):
        ev.append(("tf", int(s), random_pose(rng)))
        if case == "edges":
            ev.append(("msg", 10**9 - 500 * k, ("before", k)))  # before the oldest pose
            ev.append(("msg", int(s), ("on", k)))               # on a pose's stamp
            ev.append(("msg", int(s) + 700, ("after", k)))      # after the newest pose
        else:
            ev.append(("msg", int(s) - int(rng.integers(-500, 5000)), k))
        if case == "resets" and k % 6 == 5:
            ev.append(("reset", k % 12 == 11, None))
    return case != "no_wait", ev


def run_sync(cls, wait_for_tf, events):
    """(the event at which each message was released, the message, its pose)."""
    sync, got, at = cls(wait_for_tf=wait_for_tf), [], [0]
    sync.set_callback(lambda msg, pose: got.append((at[0], msg, pose.copy())))
    for at[0], (kind, a, b) in enumerate(events):
        if kind == "tf":
            sync.add_transform(a, b)
        elif kind == "msg":
            sync.add_message(a, b)
        else:
            sync.reset(clear_poses=a)
    return got


@pytest.mark.parametrize("case", ["cut", "edges", "unordered", "resets", "no_wait"])
def test_indexed_pose_history_releases_what_interpolate_does(case):
    """The indexed history releases the same messages, at the same calls,
    with poses bit-equal to ``interpolate`` over the pose list; a short
    stream also equals the JAX synchronizer."""
    from continuous_clustering_tpu.io.transform_synchronizer import \
        TransformSynchronizer as JaxSync

    wait_for_tf, events = sync_stream(case, np.random.default_rng(17))
    got = run_sync(TransformSynchronizer, wait_for_tf, events)
    refs = [run_sync(ListSynchronizer, wait_for_tf, events)]
    if case != "cut":
        refs.append(run_sync(JaxSync, wait_for_tf, events))
    assert len(got) > 20
    for ref in refs:
        assert [(a, m) for a, m, _ in got] == [(a, m) for a, m, _ in ref]
        for (_, _, p), (_, _, r) in zip(got, ref):
            np.testing.assert_array_equal(p, r)


def test_stats_recording():
    node = make_node()
    node.publish_instance_columns = lambda cloud: None
    xyz = frame(seed=2, num_boxes=2, spread=12.0)
    t0 = 1_000_000_000
    for c in range(NUM_COLS):
        node.on_transform(t0 + c * 400_000 + 1, np.eye(4))
        node.on_points(xyz[c], t0 + c * 400_000)
    node.flush()
    s = node.clustering.stats.summary()
    assert "device_step" in s and s["device_step"]["count"] >= 1
    w = node.clustering.workload.summary()
    assert w.keys() == {"sensor", "fifo", "device", "publish"}
    assert w["fifo"]["max"] == 32       # one full firing batch per sample


def test_stats_recording_device_insertion():
    """The device-insertion path times the batch build apart from the step,
    as the JAX facade does."""
    node = make_node(insertion="device")
    xyz = frame(seed=2, num_boxes=2, spread=12.0)
    for c in range(NUM_COLS):
        node.on_transform(10**9 + c * 400_000 + 1, np.eye(4))
        node.on_points(xyz[c], 10**9 + c * 400_000)
    node.flush()
    s = node.clustering.stats.summary()
    assert s["host_batch_prep"]["count"] == s["device_step"]["count"] >= 3


def test_launch_presets(tmp_path):
    """The launch-file cascade: the port's presets carry the JAX presets'
    (the reference's) values, and compose runnable nodes, here with a
    sensor_info written to ``tmp_path``."""
    descs = launch.demo_touareg()
    jdescs = jax_launch.demo_touareg()
    assert [d.name for d in descs] == ["vls128_roof", "os32_left", "os32_right"]
    for d, j in zip(descs, jdescs):
        assert dataclasses.asdict(d.config) == dataclasses.asdict(j.config)
        assert (d.sensor_manufacturer, d.sensor_frame, d.raw_data_topic) == (
            j.sensor_manufacturer, j.sensor_frame, j.raw_data_topic)
    for d, j in ((launch.sensor_kitti(), jax_launch.sensor_kitti()),
                 (launch.demo_kitti_folder(), jax_launch.demo_kitti_folder())):
        assert dataclasses.asdict(d.config) == dataclasses.asdict(j.config)
    vls = descs[0]
    assert vls.config.range_image.num_columns == 1700
    assert vls.config.ground_segmentation.height_ref_to_ground == -0.64
    assert vls.sensor_kwargs == {"num_lasers": 128, "decode_threads": 1}
    os32 = descs[1]
    assert os32.config.range_image.num_columns == 1024
    gs = os32.config.ground_segmentation
    assert gs.fog_filtering_enabled and gs.fog_filtering_distance_below == 5.0
    assert not os32.config.clustering.ignore_points_in_chessboard_pattern
    assert os32.raw_data_topic == "/bus/os32_left/lidar_packets"

    path = tmp_path / "os32.json"
    path.write_text(json.dumps(sp.os32_sensor_info()))
    for meta in (str(path), sp.os32_sensor_info()):
        nodes = [launch.make_node(d, device="cpu")
                 for d in launch.demo_touareg(use_vls128_roof=False, os32_metadata=meta)]
        assert [n.sensor_input.pixels_per_column for n in nodes] == [32, 32]
        assert all(n.config.range_image.num_columns == 1024 for n in nodes)
        assert all(n.sensor_input._offload is not None for n in nodes)
    node = launch.make_node(launch.sensor_os32("right", metadata_path=str(path)), device="cpu")
    assert node.sensor_input.columns_per_frame == 1024
    kitti = launch.demo_kitti_folder()
    assert kitti.config.clustering.max_distance == 0.5
    assert launch.make_node(kitti, device="cpu").clustering is not None
    vnode = launch.make_node(vls, device="cpu")
    assert vnode.sensor_input.num_lasers == 128 and vnode.sensor_input._offload is not None


def vlp16_stream(n_rev=2, seed=0):
    frames = sp.scene_frames(16, VLP16_COLS, n_rev, sp.vlp16_inclinations(), seed=seed,
                             num_boxes=6, spread=12.0)
    return sp.vlp16_packets(frames, t0_ns=2_000_000_000)


def test_node_raw_packets_to_clusters_with_decode_offload():
    """Raw VLP-16 packets -> decode thread -> firings -> tf sync -> the
    pipeline -> columns and clusters; ``flush`` drains the decode thread."""
    cfg = kitti_config()
    cfg = cfg.replace(range_image=cfg.range_image.__class__(num_columns=VLP16_COLS,
                                                            ring_buffer_revolutions=4))
    node = ClusteringNode(config=cfg, sensor_manufacturer="velodyne",
                          sensor_kwargs={"num_lasers": 16, "decode_threads": 1},
                          ego_robot_frame_from_sensor_frame=np.eye(4), firing_batch_size=64,
                          device="cpu")
    cols, clusters = [], []
    node.publish_instance_columns = lambda cloud: cols.append(len(cloud))
    node.publish_cluster = lambda pts, stamp: clusters.append(len(pts))
    sp.feed(node, vlp16_stream())
    assert node.sensor_input.pending_packets() == 0
    assert cols and clusters and any(n > 20 for n in clusters)


def test_publish_utils_equal_jax():
    """tf/clock/ego-bbox messages equal the JAX package's (which
    tests/test_node.py holds against the reference formulas)."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        ang = rng.uniform(0, 2 * np.pi)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
        T[:3, 3] = rng.normal(size=3)
        got, want = publish_utils.make_tf_message(T, 123), jax_publish_utils.make_tf_message(T, 123)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert publish_utils.make_clock_message(7) == {"type": "clock", "stamp_ns": 7}
    kw = dict(height_ref_to_maximum=0.5, height_ref_to_ground=-1.7, length_ref_to_front_end=3.0,
              length_ref_to_rear_end=-2.0, width_ref_to_left_mirror=1.1,
              width_ref_to_right_mirror=-1.0)
    from continuous_clustering_tpu.config import GroundSegmentationConfig as JaxGS

    m = publish_utils.make_ego_bounding_box_marker(42, GroundSegmentationConfig(**kw))
    assert m == jax_publish_utils.make_ego_bounding_box_marker(42, JaxGS(**kw))
    assert m["scale"] == (5.0, 2.1, 2.2)


def test_node_emits_clock_tf_and_ego_bbox():
    node = make_node()
    clocks, tfs, bboxes = [], [], []
    node.publish_clock = clocks.append
    node.publish_tf = tfs.append
    node.publish_ego_bbox = bboxes.append
    xyz = frame(seed=1, num_boxes=2, spread=12.0)
    T = np.eye(4)
    T[:3, 3] = [0.5, 0.0, 0.1]
    t0 = 1_000_000_000
    for c in range(40):
        node.on_transform(t0 + c * 400_000 + 1, T)
        node.on_points(xyz[c % NUM_COLS], t0 + c * 400_000)
    node.flush()
    assert len(bboxes) == 1             # once per reset
    assert bboxes[0]["type"] == "marker" and bboxes[0]["ns"] == "ego_robot"
    assert len(clocks) == len(tfs) == 40
    cs = [m["stamp_ns"] for m in clocks]
    assert cs == sorted(cs) and cs[0] >= t0
    np.testing.assert_allclose(tfs[0]["translation"], [0.5, 0.0, 0.1])
    np.testing.assert_allclose(tfs[0]["rotation_xyzw"], [0, 0, 0, 1])


def test_node_transforms_before_firings_survive_startup_reset():
    """With a decode thread the first firing can arrive after every
    transform was buffered; the startup reset keeps the poses."""
    node = make_node()
    clusters = []
    node.publish_cluster = lambda pts, stamp: clusters.append(len(pts))
    xyz = frame()
    stamps = [10**9 + i * 400_000 for i in range(2 * NUM_COLS)]
    for s in stamps:
        node.on_transform(s + 1, np.eye(4))
    for i, s in enumerate(stamps):
        node.on_points(xyz[i % NUM_COLS], s)
    node.flush()
    assert clusters and all(n > 20 for n in clusters)


def test_time_jump_reset_clears_stale_poses():
    sync = TransformSynchronizer(wait_for_tf=True)
    got = []
    sync.set_callback(lambda msg, pose: got.append((msg, pose)))
    sync.add_transform(10**9, np.eye(4))
    sync.reset(clear_poses=True)
    sync.add_message(10**9, "stale-release")
    assert not got
    sync.add_transform(2 * 10**9, np.eye(4))
    assert [m for m, _ in got] == ["stale-release"]


# -------------------------------------------------------- the JAX node, the port's

def record_node(node):
    """Published clusters as (sorted (column, row) keys, ids, stamp) and the
    column callbacks as (kind, first column, last column, points)."""
    clusters, columns = [], []

    def on_cluster(pts, stamp):
        keys = sorted(zip(pts["global_column_index"].tolist(), pts["row_index"].tolist()))
        clusters.append((tuple(keys), tuple(sorted(set(pts["id"].tolist()))), int(stamp)))

    def on_columns(kind):
        def cb(cloud):
            g = cloud["global_column_index"]
            columns.append((kind, int(g.min()), int(g.max()), len(cloud)))
        return cb

    node.publish_cluster = on_cluster
    node.publish_ground_columns = on_columns("ground")
    node.publish_instance_columns = on_columns("instance")
    return clusters, columns


def test_port_node_equals_jax_node():
    """The same seeded VLP-16 packets through the JAX node and the port's
    node (CPU, NumPy decode on both, the same insertion path): the same
    clusters with the same points, ids and stamps, and the same column
    callbacks."""
    jcfg = JaxConfig()
    jcfg = jcfg.replace(range_image=jcfg.range_image.__class__(num_columns=VLP16_COLS,
                                                               ring_buffer_revolutions=4))
    kw = dict(sensor_manufacturer="velodyne",
              sensor_kwargs={"num_lasers": 16, "use_native": False},
              ego_robot_frame_from_sensor_frame=np.eye(4), firing_batch_size=48)
    insertion = "host" if jax_native.available() else "device"
    jnode = JaxClusteringNode(config=jcfg, **kw)
    pnode = ClusteringNode(config=config_from_dataclass(jcfg), device="cpu", insertion=insertion,
                           **kw)
    packets = vlp16_stream(n_rev=3, seed=4)
    got = {}
    for name, node in (("jax", jnode), ("port", pnode)):
        rec = record_node(node)
        sp.feed(node, packets)
        got[name] = rec
    assert (jnode.clustering._host_ins is None) == (insertion == "device")
    (jc, jcol), (pc, pcol) = got["jax"], got["port"]
    assert len(pc) >= 3 and any(k == "instance" for k, *_ in pcol)
    assert pc == jc
    assert pcol == jcol


# ---------------------------------------------- the step under the sensor presets

def preset_config(name):
    """The JAX preset's configuration at 110 columns (ring of 4
    revolutions)."""
    desc = {"os32": lambda: jax_launch.sensor_os32("left"),
            "vls128": lambda: jax_launch.sensor_vls128_roof()}[name]()
    cfg = desc.config
    return cfg.replace(range_image=dataclasses.replace(cfg.range_image, num_columns=NUM_COLS,
                                                       ring_buffer_revolutions=4))


@pytest.mark.parametrize("preset", ["os32", "vls128"])
def test_step_block_matches_jax_under_the_sensor_presets(preset):
    """Two revolutions of a scene with near boxes and low intensities (so
    the OS-32's fog filter has points to drop) through the JAX step and the
    port's step at 32 x 110: every state field, the meta and the publish
    slab after every step."""
    import jax
    import jax.numpy as jnp

    from continuous_clustering_tpu.models.step import pipeline_step_block as jax_step
    from continuous_clustering_tpu.ops.state import init_state as jax_init

    cfg = preset_config(preset)
    if preset == "os32":
        assert cfg.ground_segmentation.fog_filtering_enabled
        assert not cfg.clustering.ignore_points_in_chessboard_pattern
        assert not cfg.clustering.ignore_points_with_too_big_inclination_angle_diff
    batch, num_rows = 48, 32
    scene = make_scene(num_boxes=6, seed=9, spread=9.0, min_radius=2.5)
    frames = [np.asarray(raycast_frame(scene, num_rows=num_rows, num_columns=NUM_COLS,
                                       seed=9 + r)[0], np.float32).transpose(1, 0, 2)
              for r in range(2)]
    rng = np.random.default_rng(9)
    steps = [(blk._replace(intensity=jnp.asarray(
        rng.integers(0, 6, blk.intensity.shape).astype(np.int32))), segp)
        for blk, segp in column_blocks(frames, batch)]
    fog = 0
    js = jax_init(cfg, num_rows)
    tcfg = config_from_dataclass(cfg)
    ts = init_state(tcfg, num_rows, "cpu")
    jstep = jax.jit(lambda s, b, p: jax_step(cfg, s, b, p, jnp.float32(HSG), batch))
    for k, (blk, segp) in enumerate(steps):
        d, inc, inten = (np.asarray(blk.distance), np.asarray(blk.inclination),
                         np.asarray(blk.intensity))
        fog += int(((d < 5.0) & (inten < 3) & (inc > -0.17)).sum())
        js, jinfo = jstep(js, blk, segp)
        tblk, tseg = to_torch_block(blk, segp)
        ts, tinfo = pipeline_step_block(tcfg, ts, tblk, tseg, torch.tensor(HSG), batch)
        assert_states_equal(jax_state_numpy(js), state_to_numpy(ts), f"step {k}")
        np.testing.assert_array_equal(tinfo.meta.numpy(), np.asarray(jinfo.meta),
                                      err_msg=f"step {k}: meta")
        for part in ("slab", "slab_ext"):
            assert_slabs_equal(np.asarray(getattr(jinfo, part)), getattr(tinfo, part).numpy(),
                               f"step {k} {part}")
    assert fog > 50, f"only {fog} points meet the fog predicate"
    assert int(ts.cluster_counter) > 1


# --------------------------------------------- the VLS-128 preset from raw packets

def vls128_node_run(is_single_threaded, columns=110, n_rev=2, device="cpu"):
    desc = launch.sensor_vls128_roof(is_single_threaded=is_single_threaded)
    desc.config = desc.config.replace(range_image=dataclasses.replace(
        desc.config.range_image, num_columns=columns))
    node = launch.make_node(desc, firing_batch_size=64, device=device)
    labels, clusters = {}, []

    def on_instance(cloud):
        ok = np.isfinite(cloud["x"])
        for g, r, i in zip(cloud["global_column_index"][ok], cloud["row_index"][ok],
                           cloud["id"][ok]):
            labels[(int(g), int(r))] = int(i)

    node.publish_instance_columns = on_instance
    node.publish_cluster = lambda pts, stamp: clusters.append((len(pts), int(stamp)))
    frames = sp.scene_frames(128, columns, n_rev, sp.velodyne_inclinations(128), seed=6,
                             num_boxes=8, spread=15.0)
    sp.feed(node, sp.velodyne_packets(frames))
    return node, labels, clusters


def test_vls128_preset_from_packets_async_equals_sync():
    """The roof preset at 128 rows (decode thread on) from raw packets: the
    asynchronous consumption publishes exactly the synchronous partition and
    clusters, and ``flush`` leaves no packet in the decode queue."""
    a_node, a_labels, a_clusters = vls128_node_run(False)
    s_node, s_labels, s_clusters = vls128_node_run(True)
    assert a_node.sensor_input._offload is not None
    assert a_node.sensor_input.pending_packets() == 0
    assert len(s_labels) > 5000 and s_clusters
    assert a_labels.keys() == s_labels.keys()
    assert partition_agreement(s_labels, a_labels) == 1.0
    assert a_clusters == s_clusters


def test_entry_points_raise_without_a_card(monkeypatch):
    """``device=None`` means the card: without one the node, ``make_node``
    and ``resolve_device`` raise instead of running on the CPU."""
    from continuous_clustering_tpu_torch.utils.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CCT_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusteringNode(Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.make_node(launch.sensor_kitti())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("CCT_PLATFORM", "cpu")
    assert ClusteringNode(Config()).device == torch.device("cpu")
