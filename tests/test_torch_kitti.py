"""The port's KITTI evaluation path on the CPU against the JAX package.

First the six scenarios of ``tests/test_kitti_tools.py`` run against the
port (loader round trip, euclidean GT labels, GT zip layout, OSE/USE
basics, the demo with a moving sensor, end to end).  Then parity, on the
same synthetic 32 x 220 sequences of 2 frames (seeds from numpy):

* the synthetic writer's files, byte for byte;
* ``recover_laser_indices``, ``generate_range_image(use_native=False)``,
  ``undo_ego_motion_correction``, ``interpolate`` and the pose chains
  exactly (f64 poses within 1e-12);
* the native rasterization against its NumPy twin under the column rule:
  the twin takes a point's column in f32, the native loop from ``atan2f`` in
  double.  A point is *suspect* when the two columns differ or it lies
  within 1e-3 of a column boundary.  Images may differ only in rows that
  hold a suspect, and only in cells that, in one image or the other, hold
  that row's first suspect point or a later point of the row (the shifts it
  starts).  With no suspect the images are equal;
* ``generate_euclidean_clustering_labels`` exactly;
* the demo with ``device="cpu", insertion="device"`` and the NumPy
  rasterization (the JAX demo runs device insertion and NumPy here: its
  native library is not built) gives the JAX demo's per-frame
  ``FrameResult``s and table rows exactly, still and moving.

The native library needs ``g++``; tests that use it skip without it.
"""

from __future__ import annotations

import dataclasses
import math
import shutil
import zipfile
from pathlib import Path

import numpy as np
import pytest

from continuous_clustering_tpu.evaluation import kitti_loader as jkl
from continuous_clustering_tpu.evaluation.euclidean_clustering import \
    generate_euclidean_clustering_labels as jax_euclid
from continuous_clustering_tpu.tools.kitti_demo import KittiDemo as JaxKittiDemo
from continuous_clustering_tpu.tools.make_synthetic_dataset import write_sequence as jax_write
from continuous_clustering_tpu_torch.evaluation import kitti_loader as kl
from continuous_clustering_tpu_torch.evaluation.euclidean_clustering import \
    generate_euclidean_clustering_labels
from continuous_clustering_tpu_torch.evaluation.kitti_evaluation import (FrameResult,
                                                                         evaluate_clusters)
from continuous_clustering_tpu_torch.tools.gt_label_generator import main as gt_main
from continuous_clustering_tpu_torch.tools.kitti_demo import KittiDemo
from continuous_clustering_tpu_torch.tools.kitti_demo import main as demo_main
from continuous_clustering_tpu_torch.tools.make_synthetic_dataset import write_sequence

from .test_torch_step import one_torch_thread  # noqa: F401

ROWS, COLS = 32, 220
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ is needed to build the native library")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_kitti")
    write_sequence(root, "00", num_frames=2, num_boxes=8, num_rows=ROWS, num_columns=COLS,
                   seed=1)
    return root


@pytest.fixture(scope="module")
def moving(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_move")
    write_sequence(root, "00", num_frames=2, num_boxes=6, num_rows=ROWS, num_columns=COLS,
                   seed=2, speed_mps=5.0)
    return root


def load_frame(root, frame=0, loader=kl):
    seq = root / "00"
    points = loader.load_point_cloud(seq / "velodyne" / f"{frame:06d}.bin")
    semantic, instance = loader.load_labels(seq / "labels" / f"{frame:06d}.label", len(points))
    return points, semantic, instance


def xyz_of(points):
    return np.stack([points["x"], points["y"], points["z"]], axis=1)


def pooled_row(text):
    ours = [line for line in text.splitlines() if "All (**Ours**)" in line][0]
    return [float(c.strip().split("/")[0]) for c in ours.split("|")[2:8]]


# ---- the scenarios of tests/test_kitti_tools.py, on the port ---------------
@needs_gxx
def test_loader_roundtrip(dataset):
    points, semantic, instance = load_frame(dataset)
    assert len(points) > 2000
    laser = kl.recover_laser_indices(points["x"], points["y"], num_lasers=ROWS)
    assert laser.max() >= 28
    image = kl.generate_range_image(points, laser, width=COLS, num_lasers=ROWS)
    filled = image >= 0
    assert filled.sum() >= 0.9 * len(points)
    assert image[filled].max() < len(points)


def test_euclidean_gt_labels(dataset):
    points, semantic, instance = load_frame(dataset)
    labels = generate_euclidean_clustering_labels(xyz_of(points), semantic, instance)
    assert np.all(labels[semantic == 40] == 0)
    for inst in np.unique(instance[instance > 0]):
        sel = (instance == inst) & (semantic == 10)
        if sel.sum() >= 20:
            vals, counts = np.unique(labels[sel], return_counts=True)
            assert vals[np.argmax(counts)] != 0, f"instance {inst} entirely unclustered"
            assert counts.max() >= 0.8 * sel.sum(), f"instance {inst}: {vals}, {counts}"
    nz = labels != 0
    seen = {}
    for lab, inst in set(zip(labels[nz].tolist(), instance[nz].tolist())):
        assert seen.setdefault(lab, inst) == inst, f"label {lab} spans instances"


def test_gt_label_zip_layout(dataset, tmp_path):
    out = tmp_path / "labels.zip"
    gt_main([str(dataset), "00", "--zip", str(out)])
    names = zipfile.ZipFile(out).namelist()
    assert names, "empty archive"
    assert all(n.startswith("dataset/sequences/00/labels_euclidean_clustering/")
               and n.endswith(".label") for n in names), names


def test_gt_label_generator_process_pool_matches_jax(dataset, tmp_path):
    """``--num-threads 2`` (a process pool) writes the JAX package's labels."""
    root = tmp_path / "copy"
    shutil.copytree(dataset / "00", root / "00",
                    ignore=shutil.ignore_patterns("labels_euclidean_clustering"))
    gt_main([str(root), "--num-threads", "2"])
    for frame in range(2):
        points, semantic, instance = load_frame(root, frame, jkl)
        got = np.fromfile(root / "00" / "labels_euclidean_clustering" / f"{frame:06d}.label",
                          np.uint16)
        np.testing.assert_array_equal(got, jax_euclid(xyz_of(points), semantic, instance))


def test_ose_use_metrics_basics():
    gt = np.array([1, 1, 1, 2, 2, 0])
    r = FrameResult()
    evaluate_clusters(gt, np.array([5, 5, 5, 7, 7, 0]), r)
    assert r.ose == 0.0 and r.use == 0.0
    r2 = FrameResult()
    evaluate_clusters(gt, np.array([5, 5, 6, 7, 7, 0]), r2)
    assert r2.ose > 0 and r2.use == 0.0
    r3 = FrameResult()
    evaluate_clusters(gt, np.array([5, 5, 5, 5, 5, 0]), r3)
    assert r3.use > 0 and r3.ose == 0.0


@needs_gxx
def test_kitti_demo_moving_sensor(moving, tmp_path, monkeypatch):
    """Ego motion (5 m/s) exercises undo-ego-motion + pose interpolation, on
    the port's main path (host insertion, native rasterization)."""
    monkeypatch.chdir(tmp_path)
    demo_main([str(moving), "00", "--evaluate-fast", "--rows", str(ROWS), "--columns",
               str(COLS), "--firing-batch", "64", "--device", "cpu"])
    recall, _, _, _, use, _ = pooled_row((tmp_path / "evaluation_results.txt").read_text())
    assert recall > 95.0
    assert use < 5.0


@needs_gxx
def test_kitti_demo_end_to_end(dataset, tmp_path, monkeypatch):
    gt_main([str(dataset), "00"])
    assert (dataset / "00" / "labels_euclidean_clustering" / "000000.label").exists()
    monkeypatch.chdir(tmp_path)
    demo = demo_main([str(dataset), "00", "--evaluate-fast", "--rows", str(ROWS), "--columns",
                      str(COLS), "--firing-batch", "64", "--device", "cpu"])
    assert demo.last_pipe.state.x.device.type == "cpu" and demo.insertion == "host"
    out = (tmp_path / "evaluation_results.txt").read_text()
    assert "All (**Ours**)" in out
    recall, precision, _, _, use, _ = pooled_row(out)
    assert recall > 95.0
    assert precision > 95.0
    assert use < 5.0


# ---- parity with the JAX package ------------------------------------------
@pytest.mark.parametrize("speed", [0.0, 5.0])
def test_synthetic_writer_files_equal_jax_byte_for_byte(tmp_path, speed):
    a, b = tmp_path / "jax", tmp_path / "port"
    jax_write(a, "00", num_frames=2, num_boxes=5, num_rows=ROWS, num_columns=COLS, seed=3,
              speed_mps=speed)
    write_sequence(b, "00", num_frames=2, num_boxes=5, num_rows=ROWS, num_columns=COLS, seed=3,
                   speed_mps=speed)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert len(files) == 7
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_loader_steps_equal_jax(moving):
    """Row recovery, ego-motion undo, the NumPy rasterization, the pose
    chains and the interpolation of the moving sequence, step by step."""
    seq = moving / "00"
    stamps = kl.load_timestamps(seq / "times.txt")
    assert stamps == jkl.load_timestamps(seq / "times.txt")
    start, end = kl.get_start_end_timestamps(stamps)
    assert (start, end) == jkl.get_start_end_timestamps(stamps)
    tf, proj = kl.get_static_transform_and_projection_matrices(seq / "calib.txt")
    jtf, jproj = jkl.get_static_transform_and_projection_matrices(seq / "calib.txt")
    np.testing.assert_array_equal(tf, jtf)
    np.testing.assert_array_equal(np.stack(proj), np.stack(jproj))
    chain = kl.get_all_dynamic_transforms(seq / "poses.txt", stamps, tf)
    jchain = jkl.get_all_dynamic_transforms(seq / "poses.txt", stamps, jtf)
    assert [t.stamp for t in chain] == [t.stamp for t in jchain]
    for t, jt in zip(chain, jchain):
        np.testing.assert_allclose(t.pose, jt.pose, rtol=0, atol=1e-12)
    assert chain[1].pose[0, 3] != chain[0].pose[0, 3]
    rel = kl.make_transforms_relative_to_first(chain)
    jrel = jkl.make_transforms_relative_to_first(jchain)
    for t, jt in zip(rel, jrel):
        np.testing.assert_allclose(t.pose, jt.pose, rtol=0, atol=1e-12)
    for stamp in np.linspace(start[0] - 10**7, end[-1] + 10**7, 17).astype(np.int64).tolist():
        np.testing.assert_allclose(kl.interpolate(chain, stamp).pose,
                                   jkl.interpolate(jchain, stamp).pose, rtol=0, atol=1e-12)
    for frame in range(2):
        points, _, _ = load_frame(moving, frame)
        jpoints = points.copy()
        laser = kl.recover_laser_indices(points["x"], points["y"], num_lasers=ROWS)
        np.testing.assert_array_equal(
            laser, jkl.recover_laser_indices(points["x"], points["y"], num_lasers=ROWS))
        kl.undo_ego_motion_correction(points, start[frame], end[frame], chain[frame].pose, chain)
        jkl.undo_ego_motion_correction(jpoints, start[frame], end[frame], jchain[frame].pose,
                                       jchain)
        assert points.tobytes() == jpoints.tobytes()
        for shift in (True, False):
            np.testing.assert_array_equal(
                kl.generate_range_image(points, laser, shift, width=COLS, num_lasers=ROWS,
                                        use_native=False),
                jkl.generate_range_image(jpoints, laser, shift, width=COLS, num_lasers=ROWS,
                                         use_native=False))


def test_slerp_with_rotation_equals_jax():
    """Interpolation between rotated poses (both slerp branches, and the
    quaternion branches of a trace <= 0) equals the JAX loader's."""
    rng = np.random.default_rng(5)

    def rot(axis, angle):
        axis = axis / np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * k @ k

    for angle in (1e-4, 0.3, 2.5, 3.1):
        poses = []
        for s in range(3):
            p = np.eye(4)
            p[:3, :3] = rot(rng.normal(size=3), angle * s)
            p[:3, 3] = rng.normal(size=3)
            poses.append(p)
        chain = [kl.StampedPose(100 * s, p) for s, p in enumerate(poses)]
        jchain = [jkl.StampedPose(100 * s, p) for s, p in enumerate(poses)]
        for stamp in (0, 13, 50, 100, 171, 200, 250):
            np.testing.assert_allclose(kl.interpolate(chain, stamp).pose,
                                       jkl.interpolate(jchain, stamp).pose, rtol=0, atol=1e-12)


def test_raw_oxts_chain_equals_jax(tmp_path):
    """The raw-dataset pose chain (OXTS measurements, datetime stamps,
    calib files) equals the JAX loader's."""
    rng = np.random.default_rng(6)
    data = tmp_path / "oxts" / "data"
    data.mkdir(parents=True)
    lines = []
    for k in range(4):
        vals = [49.01 + 1e-5 * k, 8.43 + 2e-5 * k, 112.0 + k] + list(rng.normal(0, 0.1, 27))
        (data / f"{k:010d}.txt").write_text(" ".join(f"{v:.12f}" for v in vals) + "\n")
        lines.append(f"2011-09-26 13:02:{25 + k:02d}.{123456789 + k * 1000:09d}")
    (tmp_path / "oxts" / "timestamps.txt").write_text("\n".join(lines) + "\n")
    calib = tmp_path / "calib_imu_to_velo.txt"
    calib.write_text("calib_time: 25-May-2012 16:47:16\n"
                     "R: " + " ".join(f"{v:.9f}" for v in np.eye(3).reshape(-1) + 1e-3) + "\n"
                     "T: -0.8 0.3 -0.7\n")
    static = kl.load_static_transform(calib)
    np.testing.assert_array_equal(static, jkl.load_static_transform(calib))
    stamps = kl.load_timestamps_raw(tmp_path / "oxts" / "timestamps.txt")
    assert stamps == jkl.load_timestamps_raw(tmp_path / "oxts" / "timestamps.txt")
    chain = kl.get_all_dynamic_transforms_raw(tmp_path / "oxts", 1, 3, static)
    jchain = jkl.get_all_dynamic_transforms_raw(tmp_path / "oxts", 1, 3, static)
    assert [t.stamp for t in chain] == [t.stamp for t in jchain] == stamps[1:]
    for t, jt in zip(chain, jchain):
        np.testing.assert_allclose(t.pose, jt.pose, rtol=0, atol=1e-12)
    assert kl.kitti_odometry_to_raw_mapping() == {
        k: kl.RawSequenceSubset(**dataclasses.asdict(v))
        for k, v in jkl.kitti_odometry_to_raw_mapping().items()}
    assert (kl.SEMANTIC_KITTI_LABELS, kl.GROUND_LABEL_IDS, kl.UNLABELED_ID) == (
        jkl.SEMANTIC_KITTI_LABELS, jkl.GROUND_LABEL_IDS, jkl.UNLABELED_ID)


def column_rule(points, laser, width, num_lasers, native_img, numpy_img):
    """Assert the column rule of the module docstring; returns (suspect
    points, differing cells)."""
    n = len(points)
    az32 = np.arctan2(points["y"], points["x"])
    col32 = ((math.pi - az32) / (2 * math.pi / width)).astype(np.int64)
    t64 = (math.pi - az32.astype(np.float64)) / (2.0 * math.pi / width)
    col64 = t64.astype(np.int64)
    suspect = (np.minimum(col32, width - 1) != np.minimum(col64, width - 1)) | (
        np.abs(t64 - np.rint(t64)) < 1e-3)
    first = np.full(num_lasers, n, np.int64)
    np.minimum.at(first, laser[suspect], np.flatnonzero(suspect))
    diff = np.flatnonzero(native_img != numpy_img)
    late = np.maximum(native_img[diff], numpy_img[diff]) >= first[diff // width]
    assert late.all(), f"cells {diff[~late][:10]} differ before their row's first suspect"
    return int(suspect.sum()), len(diff)


@needs_gxx
def test_native_rasterization_follows_the_column_rule(moving):
    """A real frame of the moving sequence, then 20,000 points laid on
    column boundaries (many land in another column, and their rows differ
    by the rule), then the same points without the suspects (equal)."""
    points, _, _ = load_frame(moving, 1)
    laser = kl.recover_laser_indices(points["x"], points["y"], num_lasers=ROWS)
    args = dict(width=COLS, num_lasers=ROWS)
    column_rule(points, laser, COLS, ROWS, kl.generate_range_image(points, laser, **args),
                kl.generate_range_image(points, laser, use_native=False, **args))

    W, R, n = 2200, 64, 20000
    rng = np.random.default_rng(7)
    az = math.pi - rng.integers(0, W, n) * (2 * math.pi / W)
    r = rng.uniform(2.0, 60.0, n)
    pts = np.zeros(n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"), ("i", "f4")])
    pts["x"], pts["y"], pts["z"] = r * np.cos(az), r * np.sin(az), rng.normal(0.0, 1.0, n)
    lz = rng.integers(0, R, n).astype(np.int32)
    native = kl.generate_range_image(pts, lz, width=W, num_lasers=R)
    twin = kl.generate_range_image(pts, lz, width=W, num_lasers=R, use_native=False)
    n_suspect, n_diff = column_rule(pts, lz, W, R, native, twin)
    assert n_suspect > 1000 and n_diff > 0

    az32 = np.arctan2(pts["y"], pts["x"])
    t64 = (math.pi - az32.astype(np.float64)) / (2.0 * math.pi / W)
    clean = np.abs(t64 - np.rint(t64)) >= 1e-3
    native = kl.generate_range_image(pts[clean], lz[clean], width=W, num_lasers=R)
    twin = kl.generate_range_image(pts[clean], lz[clean], width=W, num_lasers=R,
                                   use_native=False)
    assert column_rule(pts[clean], lz[clean], W, R, native, twin) == (0, 0)
    np.testing.assert_array_equal(native, twin)


def test_native_rasterization_raises_without_the_library(moving, monkeypatch):
    """No fallback: when the library cannot be built, ``use_native=True``
    raises and the NumPy twin still runs when asked for."""
    points, _, _ = load_frame(moving)
    laser = kl.recover_laser_indices(points["x"], points["y"], num_lasers=ROWS)

    def cannot_build():
        raise RuntimeError("native library cannot be built: g++ not found")

    monkeypatch.setattr(kl.native, "load", cannot_build)
    with pytest.raises(RuntimeError, match="cannot be built"):
        kl.generate_range_image(points, laser, width=COLS, num_lasers=ROWS)
    assert (kl.generate_range_image(points, laser, width=COLS, num_lasers=ROWS,
                                    use_native=False) >= 0).sum() > 2000


def test_euclidean_labels_equal_jax(dataset, moving):
    for root in (dataset, moving):
        for frame in range(2):
            points, semantic, instance = load_frame(root, frame)
            got = generate_euclidean_clustering_labels(xyz_of(points), semantic, instance)
            np.testing.assert_array_equal(got, jax_euclid(xyz_of(points), semantic, instance))
            assert got.max() > 0


@pytest.mark.parametrize("which", ["still", "moving"])
def test_kitti_demo_equals_jax_demo(which, dataset, moving, tmp_path, monkeypatch):
    """Device insertion on the CPU and the NumPy rasterization on both
    sides: the same FrameResult per frame and the same table rows (the
    execution-duration lines excluded)."""
    root = dataset if which == "still" else moving
    monkeypatch.chdir(tmp_path)
    kw = dict(evaluate=True, delay_between_columns=0, firing_batch=64, num_rows=ROWS,
              num_columns=COLS)
    jdemo = JaxKittiDemo(**kw)
    jdemo.run(root, ["00"])
    jtext = Path("evaluation_results.txt").read_text()
    demo = KittiDemo(device="cpu", insertion="device", use_native=False, **kw)
    demo.run(root, ["00"])
    text = Path("evaluation_results.txt").read_text()
    got = [dataclasses.astuple(r) for r in demo.evaluation.per_sequence[-1]]
    want = [dataclasses.astuple(r) for r in jdemo.evaluation.per_sequence[-1]]
    assert len(got) == 2 and got == want
    assert text.split("Execution Duration")[0] == jtext.split("Execution Duration")[0]
    assert pooled_row(text)[0] > 95.0
