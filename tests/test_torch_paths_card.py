"""The port's paths on the card against the sequential oracle, the same
stream on the CPU (the plain twins), or themselves.

Marked ``cuda``: skips without a CUDA device or ``g++``.  Imports nothing of
JAX or of the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_paths_card.py

32 x 220 streams (oracle, serpentine ribbon, 8-row staging, checkpoint);
the KITTI configuration (64 x 2200, firing batch 384) for host and device
insertion, the periodic runner, three streams in one step and the KITTI
demo.  Each test asserts the launches of the kernels it drives
(``utils/stats.LAUNCHES``): K1 and K2 once a step where it counts steps.
Tolerances are in each test: partitions exact against the CPU, >= 0.995
against the oracle, >= 0.99 after a resume.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from continuous_clustering_tpu_torch.tools.cc_windows import _facade
from continuous_clustering_tpu_torch.utils.stats import LAUNCHES, reset_launch_counts

pytestmark = pytest.mark.cuda

ROWS, COLS, BATCH = 64, 2200, 384      # the KITTI configuration's main path
EYE = np.eye(4)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")
    return torch.device("cuda", 0)


def _launched(steps=None) -> None:
    """K1, K2 and ground segmentation launched; K1 and K2 once a step."""
    assert all(LAUNCHES[k] > 0 for k in ("edge_bits", "window_cc", "ground_segment")), LAUNCHES
    if steps is not None:
        assert LAUNCHES["edge_bits"] == LAUNCHES["window_cc"] == steps, (LAUNCHES, steps)


def _small_config():
    from continuous_clustering_tpu_torch.config import kitti_config

    cfg = kitti_config()
    return cfg.replace(
        range_image=dataclasses.replace(cfg.range_image, num_columns=220,
                                        ring_buffer_revolutions=4),
        clustering=dataclasses.replace(cfg.clustering, stop_after_association_enabled=False))


def _two_frames(rows, seed):
    """Two ray-casts of one 8-box scene at ``rows`` x 220."""
    from continuous_clustering_tpu_torch.evaluation.synthetic import (frame_to_firings,
                                                                      make_scene, raycast_frame)

    scene = make_scene(num_boxes=8, seed=seed, spread=20.0)
    return [f for k in range(2) for f in frame_to_firings(
        raycast_frame(scene, num_rows=rows, num_columns=220, seed=seed + k)[0], frame_index=k)]


def _collect(pipe, labels, ground=None, clusters=None):
    """Record each published point's cluster id (and ground label) and each
    published cluster's size."""

    def on_col(a, b, ground_only):
        if ground_only:
            return
        cloud = pipe.get_columns(a, b)
        ok = cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max
        uidx = cloud["globally_unique_point_index"][ok].tolist()
        labels.update(zip(uidx, cloud["id"][ok].tolist()))
        if ground is not None:
            ground.update(zip(uidx, cloud["ground_point_label"][ok].tolist()))

    pipe.set_finished_column_callback(on_col)
    if clusters is not None:
        pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append(len(pts)))


def _stream(cfg, rows, firings, device, batch, stop_after=None, insertion="host"):
    """(labels, ground labels, cluster sizes, facade) of ``firings`` streamed
    and flushed; with ``stop_after``, the labels of the columns published
    before the firing of that index."""
    pipe = _facade(cfg, rows, batch, device, insertion)
    labels, ground, clusters = {}, {}, []
    _collect(pipe, labels, ground, clusters)
    for k, f in enumerate(firings):
        if k == stop_after:
            labels = dict(labels)   # the callback goes on filling the old dict
        pipe.add_firing(f, EYE)
    pipe.flush()
    return labels, ground, clusters, pipe


def _agree(cpu_labels, labels, least):
    """Every point the CPU published is published on the card, with the
    same partition."""
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement

    assert len(cpu_labels) > least and cpu_labels.keys() <= labels.keys()
    assert partition_agreement(cpu_labels, {k: labels[k] for k in cpu_labels}) == 1.0


def test_facade_on_the_card_matches_the_oracle():
    dev = _card()
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
    from continuous_clustering_tpu_torch.ops.oracle import OracleContinuousClustering

    cfg, firings = _small_config(), _two_frames(32, 1)
    oracle = OracleContinuousClustering(cfg, 32)
    oracle.set_transform_robot_from_sensor(EYE)
    o_labels, o_ground = {}, {}

    def on_oracle_col(a, b, ground_only):
        for g in range(a, b + 1) if not ground_only else ():
            for c in oracle.cells[g % cfg.ring_buffer_max_columns]:
                if c.globally_unique_point_index != -1:
                    o_labels[c.globally_unique_point_index] = c.id
                    o_ground[c.globally_unique_point_index] = c.ground_point_label

    oracle.finished_column_callback = on_oracle_col
    for f in firings:
        oracle.add_firing(f, EYE)
    reset_launch_counts()
    labels, ground, clusters, _ = _stream(cfg, 32, firings, dev, 64)
    _launched()
    common = set(o_labels) & set(labels)
    assert len(common) > 0.9 * len(o_labels)
    assert all(o_ground[k] == ground[k] for k in common)
    assert partition_agreement(o_labels, labels) >= 0.995
    assert clusters and all(n > 20 for n in clusters)


def _serpentine_firings():
    """Two revolutions of a two-cell-thick zigzag ribbon at 6 m, all round."""
    from continuous_clustering_tpu_torch.evaluation.synthetic import frame_to_firings

    R, C = 32, 220
    inc = np.deg2rad(np.linspace(2.0, -24.8, R))
    az = np.pi - np.arange(C) * (2.0 * np.pi / C)
    xyz = np.full((C, R, 3), np.nan, np.float32)
    for c in range(C):
        ph = c % 24
        for row in {min(R - 1, 2 + min(ph, 24 - ph) + dr) for dr in (0, 1)}:
            xyz[c, row] = 6.0 * np.array([np.cos(inc[row]) * np.cos(az[c]),
                                          np.cos(inc[row]) * np.sin(az[c]), np.sin(inc[row])])
    return frame_to_firings(xyz, frame_index=0) + frame_to_firings(xyz, frame_index=1)


def test_serpentine_on_the_card_converges_into_one_component():
    dev = _card()
    reset_launch_counts()
    labels, _, _, _ = _stream(_small_config(), 32, _serpentine_firings(), dev, 48)
    _launched()
    assert len(labels) > 300 and len(set(labels.values()) - {0}) <= 2


def test_few_rows_host_insertion_on_the_card_equals_the_cpu():
    """8 rows: fields and scalars in one upload, the pose rows in a second."""
    dev = _card()
    from continuous_clustering_tpu_torch.ops.ingest import N_SPLIT_PLANES

    cfg, firings = _small_config(), _two_frames(8, 4)
    reset_launch_counts()
    labels, ground, clusters, pipe = _stream(cfg, 8, firings, dev, 64)
    _launched()
    assert pipe._staging.shape[0] == N_SPLIT_PLANES
    c_labels, c_ground, c_clusters, _ = _stream(cfg, 8, firings, "cpu", 64)
    assert labels.keys() == c_labels.keys()
    _agree(c_labels, labels, 300)
    assert ground == c_ground
    assert clusters and sorted(clusters) == sorted(c_clusters)


@pytest.mark.parametrize("insertion", ["host", "device"])
def test_insertion_at_full_size_on_the_card_equals_the_cpu(insertion):
    dev = _card()
    from continuous_clustering_tpu_torch.config import kitti_config
    from continuous_clustering_tpu_torch.tools.cc_windows import stream_firings

    # revolutions on the card: 5 on host insertion, 3 on device insertion
    cfg, firings = kitti_config(), stream_firings(ROWS, COLS, 5 if insertion == "host" else 3)
    reset_launch_counts()
    labels, _, clusters, pipe = _stream(cfg, ROWS, firings, dev, BATCH, insertion=insertion)
    torch.cuda.synchronize()
    _launched(pipe.n_steps)
    assert clusters and pipe.state.device == dev
    assert (pipe._host_ins is None) == (insertion == "device")
    n = 2 * COLS
    cpu_labels, _, _, _ = _stream(cfg, ROWS, firings[:n], "cpu", BATCH, stop_after=n - BATCH,
                                  insertion=insertion)
    _agree(cpu_labels, labels, 10000)


def test_checkpoint_resume_on_the_card(tmp_path):
    dev = _card()
    from continuous_clustering_tpu_torch.evaluation.partition import partition_agreement
    from continuous_clustering_tpu_torch.models.checkpoint import load_state, save_state

    cfg, firings = _small_config(), _two_frames(32, 1)
    reset_launch_counts()
    ref_labels, _, _, _ = _stream(cfg, 32, firings, dev, 64)
    half, labels = len(firings) // 2, {}
    first = _facade(cfg, 32, 64, dev)
    _collect(first, labels)
    for f in firings[:half]:
        first.add_firing(f, EYE)
    save_state(first, tmp_path / "checkpoint.npz")
    resumed = _facade(cfg, 32, 64, dev)
    load_state(resumed, tmp_path / "checkpoint.npz")
    assert resumed.state.device == dev and resumed._host_ins is None
    _collect(resumed, labels)
    for f in firings[half:]:
        resumed.add_firing(f, EYE)
    resumed.flush()
    _launched()
    assert len(set(ref_labels) & set(labels)) > 0.9 * len(ref_labels)
    assert partition_agreement(ref_labels, labels) >= 0.99


@pytest.mark.parametrize("scene", ["standard", "near_field", "clutter"])
def test_periodic_runner_on_the_card(scene):
    dev = _card()
    from continuous_clustering_tpu_torch.tools import bench_setup

    cfg, pipe = bench_setup.make_bench_pipe(num_rows=ROWS, num_cols=COLS, ring_revs=10,
                                            batch=BATCH, nth=1, device=dev)
    firings, n_points = bench_setup.make_bench_scene(ROWS, COLS, scene)
    captured = bench_setup.capture_revolution(pipe, firings, COLS)
    reset_launch_counts()
    runs = [bench_setup.measure_periodic_rate(cfg, pipe, captured, COLS, n_points, N=1, pairs=2,
                                              slab_cols=pipe._slab_W, slab_head=pipe._slab_W1)
            for _ in range(2 if scene == "standard" else 1)]
    _launched(sum(res["k0"] for res in runs))
    assert len({res["checksum"] for res in runs}) == 1
    for res in runs:
        assert not res["overflow"] and not res["cc_failed"]
        assert int(res["state"].first_unpublished) > (res["k0"] // res["per_rev"] - 3) * COLS


def test_three_streams_in_one_step_on_the_card_equal_each_stream_alone():
    dev = _card()
    from continuous_clustering_tpu_torch.config import kitti_config
    from continuous_clustering_tpu_torch.models.step import (META_CC_FAILED, META_NUM_NEW,
                                                             META_OVERFLOW, EgoCalibration,
                                                             pipeline_step)
    from continuous_clustering_tpu_torch.models.throughput import stack_batches
    from continuous_clustering_tpu_torch.ops.insertion import make_firing_batch
    from continuous_clustering_tpu_torch.ops.state import init_state
    from continuous_clustering_tpu_torch.parallel.multi_sensor import (make_sharded_step,
                                                                       stacked_init)
    from continuous_clustering_tpu_torch.tools.cc_windows import stream_firings

    from .test_torch_halo_card import assert_states_equal

    cfg, S = kitti_config(), 3
    streams = [stream_firings(ROWS, COLS, 2, seed=5 + s, num_boxes=14 + s) for s in range(S)]
    batches = [[make_firing_batch(f[k:k + BATCH], [EYE] * len(f[k:k + BATCH]), BATCH, ROWS, dev)
                for k in range(0, len(f), BATCH)] for f in streams]
    n_steps = len(batches[0])
    ref = _facade(cfg, ROWS, BATCH, dev, insertion="device")
    B, W, W1, calib = ref._batch_B, ref._slab_W, ref._slab_W1, ref._make_calib()
    scalib = EgoCalibration(*[torch.stack([t] * S) for t in calib])
    run = make_sharded_step(cfg, B, device=dev, slab_cols=W, slab_head=W1)
    state, infos = stacked_init(cfg, ROWS, S, dev), []
    reset_launch_counts()
    for k in range(n_steps):
        state, info = run(state, stack_batches([b[k] for b in batches]), scalib)
        infos.append(info)
    _launched(n_steps)
    metas = torch.stack([i.meta for i in infos]).cpu()       # (steps, streams, lanes)
    assert not bool(metas[:, :, [META_OVERFLOW, META_CC_FAILED]].any())
    assert int(metas[:, :, META_NUM_NEW].sum(dim=0).min()) > 0
    for s in range(S):
        st = init_state(cfg, ROWS, dev)
        for k in range(n_steps):
            # the meta, publish slab and tail: what the facade publishes from
            st, info = pipeline_step(cfg, st, batches[s][k], calib, B, W, W1)
            assert all(torch.equal(a, b[s]) for a, b in zip(info, infos[k])), (s, k)
        assert_states_equal(type(st)(**{n: t[s] for n, t in vars(state).items()}), st)


def test_kitti_demo_on_the_card_equals_the_cpu(tmp_path, monkeypatch):
    dev = _card()
    from continuous_clustering_tpu_torch.tools import gt_label_generator
    from continuous_clustering_tpu_torch.tools.kitti_demo import KittiDemo
    from continuous_clustering_tpu_torch.tools.make_synthetic_dataset import write_sequence

    class RecordingDemo(KittiDemo):
        """The demo, recording each published point's cluster id."""

        def _on_finished_columns(self, pipe, from_gcol, to_gcol):
            cloud = pipe.get_columns(from_gcol, to_gcol)
            ok = cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max
            self.partition.update(zip(cloud["globally_unique_point_index"][ok].tolist(),
                                      cloud["id"][ok].tolist()))
            super()._on_finished_columns(pipe, from_gcol, to_gcol)

    root = tmp_path / "kitti"
    write_sequence(root, "00", num_frames=3, num_boxes=10, seed=0, num_rows=ROWS,
                   num_columns=COLS, speed_mps=5.0)
    gt_label_generator.main([str(root), "00"])
    monkeypatch.chdir(tmp_path)
    demos = {}
    for device in (dev, "cpu"):
        demo = RecordingDemo(evaluate=True, delay_between_columns=0, device=device,
                             num_rows=ROWS, num_columns=COLS)
        demo.partition = {}
        reset_launch_counts()
        demo.run(root, ["00"])
        if device == dev:
            torch.cuda.synchronize()
            _launched(demo.last_pipe.n_steps)
        demos[str(device)] = demo
    card, cpu = demos[str(dev)], demos["cpu"]
    assert card.last_pipe.state.x.device == dev and card.last_pipe._host_ins is not None
    frames = [dataclasses.astuple(r) for r in card.evaluation.per_sequence[-1]]
    assert len(frames) == 3 and frames == [dataclasses.astuple(r)
                                           for r in cpu.evaluation.per_sequence[-1]]
    _agree(cpu.partition, card.partition, 10000)
    table = card.evaluation.generate_evaluation_results()
    assert table == cpu.evaluation.generate_evaluation_results()
    pooled = [line for line in table.splitlines() if "All (**Ours**)" in line][0]
    assert float(pooled.split("|")[2].split("/")[0]) > 90.0


def test_html_viewer_on_the_card(tmp_path):
    dev = _card()
    import base64
    import json
    import re

    from continuous_clustering_tpu_torch.tools import html_viewer

    out = tmp_path / "viewer.html"
    reset_launch_counts()
    rc = html_viewer.main([str(out), "--rows", "32", "--columns", "220", "--device", str(dev)])
    torch.cuda.synchronize()
    _launched()
    data = json.loads(re.search(r"const DATA = (\{.*?\});\n", out.read_text(), re.S).group(1))
    n_pts = len(base64.b64decode(data["xyz_b64"])) // 12
    assert rc == 0 and data["n"] == n_pts > 0 and data["kinds"].count("cluster") > 0
