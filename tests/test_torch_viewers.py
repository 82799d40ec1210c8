"""The port's viewers and evaluation I/O on the CPU.

* ``tools/html_viewer.py``: the three payload tests of
  ``tests/test_html_viewer.py`` on the port's ``ClusterViewer``, the JAX
  viewer's HTML byte for byte on the same clusters, and ``main`` streaming a
  synthetic scene through the port's facade on the CPU;
* ``tools/visualize.py``: the render functions equal the JAX module's,
  ``dump_state`` writes three PNGs of a live facade, and ``main`` runs the
  port's ``KittiDemo`` on a synthetic sequence;
* ``io/evaluation_cloud.py`` equals the JAX module's cloud field by field;
* ``tools/plot_workload.py``: ``report`` and ``samples_csv`` read the port
  facade's ``workload`` and ``stats`` as the JAX functions read them.
"""

from __future__ import annotations

import base64
import json
import re
import shutil
import struct
import zlib

import numpy as np
import pytest

from continuous_clustering_tpu.io.evaluation_cloud import evaluation_to_cloud as jax_cloud
from continuous_clustering_tpu.tools import plot_workload as jax_plot_workload
from continuous_clustering_tpu.tools import visualize as jax_visualize
from continuous_clustering_tpu.tools.html_viewer import ClusterViewer as JaxClusterViewer
from continuous_clustering_tpu_torch.config import kitti_config
from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings, make_scene,
                                                                  raycast_frame)
from continuous_clustering_tpu_torch.io.evaluation_cloud import (EVALUATION_DTYPE,
                                                                 evaluation_to_cloud)
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
from continuous_clustering_tpu_torch.tools import html_viewer, plot_workload, visualize
from continuous_clustering_tpu_torch.tools.html_viewer import _PALETTE, ClusterViewer
from continuous_clustering_tpu_torch.tools.make_synthetic_dataset import write_sequence

from .test_torch_step import one_torch_thread  # noqa: F401

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ is needed to build the native library")


def _decode(path):
    html = open(path).read()
    m = re.search(r"const DATA = (\{.*?\});\n", html, re.S)
    assert m, "payload not embedded"
    d = json.loads(m.group(1))
    xyz = np.frombuffer(base64.b64decode(d["xyz_b64"]), "<f4").reshape(-1, 3)
    rgb = np.frombuffer(base64.b64decode(d["rgb_b64"]), np.uint8).reshape(-1, 3)
    return html, d, xyz, rgb


def _read_png(path):
    """(height, width, rgb) of a PNG written by ``visualize._write_png``."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return h, w, raw[:, 1:].reshape(h, w, 3)


# ---- html_viewer ------------------------------------------------------------
def test_viewer_payload_roundtrip(tmp_path):
    v = ClusterViewer()
    rng = np.random.default_rng(0)
    a = rng.standard_normal((30, 3)).astype(np.float32)
    b = rng.standard_normal((50, 3)).astype(np.float32) + 5
    v.add_cluster(a, stamp=123, cluster_id=7)
    v.add_cluster(b, stamp=456, cluster_id=8)
    g = rng.standard_normal((40, 3)).astype(np.float32) - 5
    v.add_ground(g)
    out = v.write(tmp_path / "v.html")
    html, d, xyz, rgb = _decode(out)
    assert d["n"] == 120 and len(xyz) == 120 and len(rgb) == 120
    assert d["kinds"] == ["cluster", "cluster", "ground"]
    assert d["ids"] == [7, 8, -1]
    assert d["counts"] == [30, 50, 40]
    np.testing.assert_allclose(xyz[:30], a)
    np.testing.assert_array_equal(rgb[0], np.asarray(_PALETTE[7 % len(_PALETTE)]))
    assert "http://" not in html and "https://" not in html
    assert "<script src" not in html
    jv = JaxClusterViewer()
    jv.add_cluster(a, stamp=123, cluster_id=7)
    jv.add_cluster(b, stamp=456, cluster_id=8)
    jv.add_ground(g)
    assert out.read_bytes() == jv.write(tmp_path / "j.html").read_bytes()


def test_viewer_structured_array_and_nan_filter(tmp_path):
    v = ClusterViewer()
    pts = np.zeros(5, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"), ("id", "i4")])
    pts["x"] = [1, 2, np.nan, 4, 5]
    pts["id"] = 3
    v.add_cluster(pts, stamp=9)
    out = v.write(tmp_path / "v.html")
    _, d, xyz, _ = _decode(out)
    assert d["n"] == 4
    assert d["ids"] == [3]


def test_viewer_empty(tmp_path):
    out = ClusterViewer().write(tmp_path / "v.html")
    _, d, xyz, rgb = _decode(out)
    assert d["n"] == 0 and len(xyz) == 0


@needs_gxx
def test_viewer_main_streams_through_the_port(tmp_path):
    out = tmp_path / "scene.html"
    assert html_viewer.main([str(out), "--device", "cpu"]) == 0
    _, d, xyz, _ = _decode(out)
    assert d["n"] > 500 and "cluster" in d["kinds"] and "ground" in d["kinds"]
    assert np.isfinite(xyz).all()
    assert html_viewer.main([]) == 2


# ---- visualize --------------------------------------------------------------
def test_render_functions_equal_jax():
    rng = np.random.default_rng(1)
    dist = rng.uniform(0, 80, (16, 40)).astype(np.float32)
    dist[rng.random((16, 40)) < 0.2] = np.nan
    debug = rng.choice(list(visualize.DEBUG_COLORS) + [0], size=(16, 40)).astype(np.uint8)
    ids = rng.integers(0, 9000, (16, 40))
    np.testing.assert_array_equal(visualize.render_range_image(dist),
                                  jax_visualize.render_range_image(dist))
    np.testing.assert_array_equal(visualize.render_debug_labels(debug),
                                  jax_visualize.render_debug_labels(debug))
    np.testing.assert_array_equal(visualize.render_cluster_ids(ids),
                                  jax_visualize.render_cluster_ids(ids))
    assert visualize.DEBUG_COLORS == jax_visualize.DEBUG_COLORS


def small_facade(rows=16, cols=110, revs=2):
    cfg = kitti_config()
    cfg = cfg.replace(range_image=cfg.range_image.__class__(num_columns=cols,
                                                            ring_buffer_revolutions=4))
    pipe = ContinuousClustering(cfg, firing_batch_size=32, device="cpu")
    pipe.reset(rows)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    xyz, _ = raycast_frame(make_scene(num_boxes=6, seed=2, spread=20.0), num_rows=rows,
                           num_columns=cols, seed=2)
    for _ in range(revs):
        for f in frame_to_firings(xyz, start_stamp=0, end_stamp=10**8):
            pipe.add_firing(dict(f), np.eye(4))
    pipe.flush()
    return pipe


@needs_gxx
def test_dump_state_writes_the_three_views(tmp_path):
    pipe = small_facade()
    fu = pipe.first_unpublished_global_column_index
    files = visualize.dump_state(pipe, fu - 110, fu - 1, tmp_path / "d")
    cloud = pipe.get_columns(fu - 110, fu - 1)
    ids = cloud["id"].reshape(110, 16).T.astype(np.int64)
    for name, want in zip(files, (None, None, visualize.render_cluster_ids(ids))):
        h, w, rgb = _read_png(tmp_path / name.split("/")[-1])
        assert (h, w) == (16, 110)
        if want is not None:
            np.testing.assert_array_equal(rgb, want)
    assert (ids > 0).any()


@needs_gxx
def test_visualize_main_runs_the_demo(tmp_path, monkeypatch):
    write_sequence(tmp_path / "ds", "00", num_frames=1, num_boxes=5, num_rows=16,
                   num_columns=110, seed=4)
    monkeypatch.chdir(tmp_path)
    files = visualize.main([str(tmp_path / "ds"), "00", "--rows", "16", "--columns", "110",
                            "--out", str(tmp_path / "v"), "--device", "cpu"])
    assert [f.split("_")[-1] for f in files] == ["range.png", "ground.png", "clusters.png"]
    for f in files:
        h, w, _ = _read_png(tmp_path / f.split("/")[-1])
        assert h == 16 and 0 < w <= 110


# ---- evaluation_cloud -------------------------------------------------------
def test_evaluation_cloud_equals_jax():
    rng = np.random.default_rng(3)
    n = 500
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    semantic = rng.choice([0, 10, 40, 44, 48, 50, 72], n).astype(np.uint16)
    instance = rng.integers(0, 5, n).astype(np.uint16)
    gt = rng.integers(0, 4, n).astype(np.uint32)
    det = rng.integers(0, 4, n).astype(np.uint32)
    ground = rng.random(n) < 0.5
    has_det = rng.random(n) < 0.9
    got = evaluation_to_cloud(xyz, semantic, instance, gt, det, ground, has_det)
    want = jax_cloud(xyz, semantic, instance, gt, det, ground, has_det)
    assert got.dtype == want.dtype == EVALUATION_DTYPE
    assert got.tobytes() == want.tobytes()
    assert set(np.unique(got["ground_point_evaluation"])) == {0, 1, 2, 3, 4}


# ---- plot_workload ----------------------------------------------------------
@needs_gxx
def test_plot_workload_reads_the_facade():
    pipe = small_facade()
    assert pipe.workload.samples and "device_step" in pipe.stats.summary()
    report = plot_workload.report(pipe)
    assert report == jax_plot_workload.report(pipe)
    parsed = json.loads(report)
    assert set(parsed) == {"workload", "stage_timing"}
    assert set(parsed["workload"]) == set(pipe.workload.stages)
    csv_text = plot_workload.samples_csv(pipe)
    assert csv_text == jax_plot_workload.samples_csv(pipe)
    lines = csv_text.strip().splitlines()
    assert lines[0].split(",") == list(pipe.workload.stages)
    assert len(lines) == 1 + len(pipe.workload.samples)
