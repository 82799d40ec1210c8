"""The port's streaming facade on the CPU against the sequential oracle and
against the JAX facade.

Firings go through ``ContinuousClustering.add_firing`` (native host
insertion, then the port's step with the kernels' plain twins).  Tolerance:
partition agreement with the oracle >= 0.995 and ground labels exact (the
JAX facade's own bar, tests/test_pipeline.py); partition agreement with the
JAX facade 1.0; async mode equal to sync mode.  These tests need ``g++`` to
build the native library and skip without it.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from continuous_clustering_tpu.evaluation.partition import partition_agreement
from continuous_clustering_tpu_torch.convert import config_from_dataclass
from continuous_clustering_tpu_torch.io.point_cloud import ProcessingStage
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering

from .test_pipeline import NUM_ROWS, collect_oracle, collect_pipeline, make_stream, small_config
from .test_torch_step import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")


def collect_port(cfg, firings, poses, batch=64, pipe_out=None):
    pipe = ContinuousClustering(config_from_dataclass(cfg), firing_batch_size=batch,
                                device="cpu")
    pipe.reset(NUM_ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    labels, ground, clusters = {}, {}, []

    def on_col(a, b, ground_only):
        if ground_only:
            return
        cloud = pipe.get_columns(a, b)
        valid = cloud["globally_unique_point_index"] != np.iinfo(np.uint64).max
        for u, i, g in zip(cloud["globally_unique_point_index"][valid],
                           cloud["id"][valid], cloud["ground_point_label"][valid]):
            labels[int(u)] = int(i)
            ground[int(u)] = int(g)

    pipe.set_finished_column_callback(on_col)
    pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append((pts, stamp)))
    for f, p in zip(firings, poses):
        pipe.add_firing(f, p)
    pipe.flush()
    if pipe_out is not None:
        pipe_out.append(pipe)
    return labels, ground, clusters


def test_port_facade_matches_oracle_and_jax_facade():
    cfg = small_config(stop_after_association=False)
    firings, poses = make_stream()
    o_labels, o_ground = collect_oracle(cfg, firings, poses)
    p_labels, p_ground, clusters = collect_port(cfg, firings, poses)
    assert len(p_labels) > 1000
    common = set(o_labels) & set(p_labels)
    assert len(common) > 0.9 * len(o_labels)
    assert np.mean([o_ground[k] == p_ground[k] for k in common]) == 1.0
    assert partition_agreement(o_labels, p_labels) >= 0.995
    assert clusters
    for pts, stamp in clusters:
        assert len(pts) > 20 and np.all(pts["id"] == pts["id"][0]) and stamp > 0

    j_labels, j_ground, j_clusters = collect_pipeline(cfg, firings, poses)
    common = set(j_labels) & set(p_labels)
    assert len(common) > 0.9 * len(j_labels)
    assert partition_agreement(j_labels, p_labels) == 1.0
    assert all(j_ground[k] == p_ground[k] for k in common)
    assert sorted(len(p) for p, _ in clusters) == sorted(len(p) for p, _ in j_clusters)


def test_port_async_mode_matches_sync():
    cfg = small_config(stop_after_association=False)
    firings, poses = make_stream(seed=7)
    s_labels, s_ground, s_clusters = collect_port(cfg, firings, poses)
    acfg = cfg.replace(general=dataclasses.replace(cfg.general, is_single_threaded=False))
    a_labels, a_ground, a_clusters = collect_port(acfg, firings, poses)
    assert s_labels == a_labels and s_ground == a_ground
    assert [len(p) for p, _ in s_clusters] == [len(p) for p, _ in a_clusters]


def test_get_columns_other_stage_agrees_with_native_assembly():
    """The numpy readout path (any stage but the last) reads the same
    fields as the native assembly."""
    cfg = small_config(stop_after_association=False)
    firings, poses = make_stream(num_frames=1)
    pipes = []
    collect_port(cfg, firings[:150], poses[:150], pipe_out=pipes)
    pipe = pipes[0]
    lo = max(pipe.first_unpublished_global_column_index - 40, 0)
    full = pipe.get_columns(lo, lo + 29)
    seg = pipe.get_columns(lo, lo + 29, ProcessingStage.GROUND_POINT_SEGMENTATION)
    assert len(seg) == len(full) == 30 * NUM_ROWS
    for name in seg.dtype.names:
        np.testing.assert_array_equal(seg[name], full[name], err_msg=name)


@pytest.mark.parametrize("flag,match", [("cc_failed", "did not converge"),
                                        ("overflow", "Ring buffer overflow")])
def test_cc_failed_and_overflow_raise_distinct_errors(flag, match):
    cfg = small_config(stop_after_association=False)
    firings, poses = make_stream(num_frames=1)
    pipe = ContinuousClustering(config_from_dataclass(cfg), firing_batch_size=64, device="cpu")
    pipe.reset(NUM_ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    for f, p in zip(firings[:64], poses[:64]):
        pipe.add_firing(f, p)
    setattr(pipe.state, flag, torch.tensor(True))
    other = "overflow" if flag == "cc_failed" else "Connected-components"
    with pytest.raises(RuntimeError, match=match) as err:
        for f, p in zip(firings[64:], poses[64:]):
            pipe.add_firing(f, p)
    assert other not in str(err.value)


def test_azimuth_rebase_keeps_the_partition():
    """Rebasing the stored azimuths every rotation (instead of every 256)
    publishes the same clusters."""
    cfg = small_config(stop_after_association=False)
    firings, poses = make_stream(num_frames=3, seed=11)
    base, _, _ = collect_port(cfg, firings, poses)
    pipe = ContinuousClustering(config_from_dataclass(cfg), firing_batch_size=64,
                                rebase_after_rotations=0,
                                device="cpu")
    pipe.reset(NUM_ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    labels = {}

    def on_col(a, b, ground_only):
        if not ground_only:
            cloud = pipe.get_columns(a, b)
            for u, i in zip(cloud["globally_unique_point_index"], cloud["id"]):
                labels[int(u)] = int(i)

    pipe.set_finished_column_callback(on_col)
    for f, p in zip(firings, poses):
        pipe.add_firing(f, p)
    pipe.flush()
    assert int(pipe.state.origin_rot) >= 1
    labels.pop(int(np.iinfo(np.uint64).max), None)
    assert labels.keys() == base.keys()
    assert partition_agreement(base, labels) == 1.0
