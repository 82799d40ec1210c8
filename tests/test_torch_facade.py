"""The port's streaming facade on the CPU against the sequential oracle and
against the JAX facade.

Firings go through ``ContinuousClustering.add_firing`` (native host
insertion, then the port's step with the kernels' plain twins).  Tolerance:
partition agreement with the oracle >= 0.995 and ground labels exact (the
JAX facade's own bar, tests/test_pipeline.py); partition agreement with the
JAX facade 1.0; async mode equal to sync mode.  Below 15 rows (8) host
insertion stages each block in two buffers; there every step equals the JAX
``pipeline_step_block`` fed the same captured buffers, cell for cell (the
tolerance of ``tests/test_torch_step.py``), and the partition holds the
oracle bar above.  These tests need ``g++`` to build the native library and
skip without it.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from continuous_clustering_tpu.evaluation.partition import partition_agreement
from continuous_clustering_tpu.evaluation.synthetic import frame_to_firings, make_scene, raycast_frame
from continuous_clustering_tpu.models.step import SegPoses as JaxSegPoses
from continuous_clustering_tpu.models.step import pipeline_step_block as jax_step
from continuous_clustering_tpu.ops.ingest import unpack_block as jax_unpack_block
from continuous_clustering_tpu.ops.oracle import OracleContinuousClustering
from continuous_clustering_tpu.ops.state import init_state as jax_init
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.io.point_cloud import ProcessingStage
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
from continuous_clustering_tpu_torch.ops.ingest import N_BLOCK_FIELDS, N_BLOCK_SCALARS

from .test_pipeline import NUM_COLS, NUM_ROWS, collect_oracle, collect_pipeline, make_stream, small_config
from .test_torch_step import assert_slabs_equal, assert_states_equal, jax_state_numpy
from .test_torch_step import one_torch_thread  # noqa: F401

FEW_ROWS = 8


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native insertion library")


def collect_port(cfg, firings, poses, batch=64, pipe_out=None, num_rows=NUM_ROWS):
    pipe = ContinuousClustering(config_from_dataclass(cfg), firing_batch_size=batch,
                                device="cpu")
    pipe.reset(num_rows)
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


def few_rows_stream(num_frames=2, seed=1, speed=0.0):
    """Firings and poses of ``num_frames`` revolutions at 8 rows; with
    ``speed`` the sensor moves along x by that many metres a revolution."""
    scene = make_scene(num_boxes=8, seed=seed, spread=20.0)
    firings, poses = [], []
    for f in range(num_frames):
        xyz, _ = raycast_frame(scene, num_rows=FEW_ROWS, num_columns=NUM_COLS, seed=seed + f)
        fr = frame_to_firings(xyz, frame_index=f)
        firings += fr
        for k in range(len(fr)):
            pose = np.eye(4)
            pose[0, 3] = speed * (f + k / len(fr))
            poses.append(pose)
    return firings, poses


def test_host_insertion_below_15_rows_matches_jax_step_every_step():
    """At 8 rows each block goes up as fields + scalars and a separate
    (B, 15) pose buffer; the JAX step fed the same buffers agrees after every
    step on every state field, the meta and the publish slab."""
    cfg = small_config(stop_after_association=False)
    firings, poses = few_rows_stream(seed=4, speed=0.5)
    pipe = ContinuousClustering(config_from_dataclass(cfg), firing_batch_size=64, device="cpu")
    pipe.reset(FEW_ROWS)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    B, W, W1 = pipe._batch_B, pipe._slab_W, pipe._slab_W1
    jstep = jax.jit(lambda s, f, sc, sp, h: jax_step(
        cfg, s, jax_unpack_block(f, sc),
        JaxSegPoses(sensor_pos=sp[:, 0:3], ego_rot=sp[:, 3:12].reshape(B, 3, 3),
                    ego_trans=sp[:, 12:15]),
        h, B, slab_cols=W, slab_head=W1))
    js = {"state": jax_init(cfg, FEW_ROWS), "steps": 0}
    run_port = pipe._run_block

    def run_both(staged):
        buf, segp = staged
        assert segp is not None and buf.shape == (N_BLOCK_FIELDS + 1, B, FEW_ROWS)
        fields = jnp.asarray(buf[:N_BLOCK_FIELDS].copy())
        scalars = jnp.asarray(buf[N_BLOCK_FIELDS].reshape(-1)[:N_BLOCK_SCALARS].copy())
        jsegp = jnp.asarray(segp.copy())
        info = run_port(staged)
        js["state"], jinfo = jstep(js["state"], fields, scalars, jsegp,
                                   jnp.float32(float(pipe._hsg())))
        where = f"step {js['steps']}"
        assert_states_equal(jax_state_numpy(js["state"]), state_to_numpy(pipe.state), where)
        np.testing.assert_array_equal(info.meta.numpy(), np.asarray(jinfo.meta),
                                      err_msg=f"{where}: meta")
        for part in ("slab", "slab_ext"):
            assert_slabs_equal(np.asarray(getattr(jinfo, part)), getattr(info, part).numpy(),
                               f"{where} {part}")
        js["steps"] += 1
        return info

    pipe._run_block = run_both
    clusters = []
    pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append(len(pts)))
    for f, p in zip(firings, poses):
        pipe.add_firing(f, p)
    pipe.flush()
    assert js["steps"] >= 8 and clusters


def test_host_insertion_below_15_rows_matches_oracle():
    """The 8-row stream's partition against the sequential oracle, at the
    bar of the facade tests above (>= 0.995, ground labels exact)."""
    cfg = small_config(stop_after_association=False)
    firings, poses = few_rows_stream(seed=4)
    oracle = OracleContinuousClustering(cfg, FEW_ROWS)
    oracle.set_transform_robot_from_sensor(np.eye(4))
    o_labels, o_ground = {}, {}

    def on_oracle_col(a, b, ground_only):
        if ground_only:
            return
        for g in range(a, b + 1):
            for r in range(FEW_ROWS):
                c = oracle.cells[g % cfg.ring_buffer_max_columns][r]
                if c.globally_unique_point_index != -1:
                    o_labels[c.globally_unique_point_index] = c.id
                    o_ground[c.globally_unique_point_index] = c.ground_point_label

    oracle.finished_column_callback = on_oracle_col
    for f, p in zip(firings, poses):
        oracle.add_firing(f, p)
    p_labels, p_ground, clusters = collect_port(cfg, firings, poses, num_rows=FEW_ROWS)
    common = set(o_labels) & set(p_labels)
    assert len(p_labels) > 300 and len(common) > 0.9 * len(o_labels)
    assert all(o_ground[k] == p_ground[k] for k in common)
    assert partition_agreement(o_labels, p_labels) >= 0.995
    assert clusters
