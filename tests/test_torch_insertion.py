"""The port's device insertion (``insert_firings``), ``pipeline_step`` and the
device-insertion facade against the JAX package on the CPU, and insertion
against the sequential oracle.

Inputs are raycast scenes made from a seed with numpy; both packages get the
same firings.  Comparison rule, fixed before the first comparison:

* integer and boolean fields, every scalar, the per-firing frontier, the
  meta vector and the partition: exact.  A cell in another column than the
  JAX package put it is counted and shown (the ``gcol`` plane is exact, so
  the count must be 0);
* f32 fields: exact where both compute the same f32 operations (x, y, z,
  distance: the port evaluates the multiply-adds that XLA's CPU build fuses
  as fused multiply-adds too); within ``F32_ULPS`` ulp where an f32
  transcendental enters: ``azimuth`` (XLA's f32 arctan2 is up to 1 ulp from
  the correctly rounded value the port computes) and ``inclination`` (XLA's
  f32 arcsin, up to 2 ulp).  The azimuth's ulp carries into
  ``cont_az = 2 pi k + (pi - azimuth)`` and on into ``finish_az`` and
  ``slot_finish`` as an absolute error, which the subtraction from pi can
  make many ulp of a small result: those three fields hold within one ulp
  of pi plus ``F32_ULPS`` ulp of the field's largest magnitude.  Likewise
  the segmentation's carry ``incl_diffs``, a difference of two
  inclinations: within twice the inclination's bound, in ulp of pi / 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from continuous_clustering_tpu.config import kitti_config
from continuous_clustering_tpu.evaluation.synthetic import frame_to_firings, make_scene, raycast_frame
from continuous_clustering_tpu.models.continuous_clustering import (
    ContinuousClustering as JaxContinuousClustering)
from continuous_clustering_tpu.models.step import EgoCalibration as JaxEgoCalibration
from continuous_clustering_tpu.models.step import pipeline_step as jax_pipeline_step
from continuous_clustering_tpu.ops.insertion import FiringBatch as JaxFiringBatch
from continuous_clustering_tpu.ops.insertion import insert_firings as jax_insert
from continuous_clustering_tpu.ops.oracle import OracleContinuousClustering
from continuous_clustering_tpu.ops.state import init_state as jax_init
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.models.continuous_clustering import ContinuousClustering
from continuous_clustering_tpu_torch.models.step import EgoCalibration, pipeline_step
from continuous_clustering_tpu_torch.ops.insertion import FiringBatch, insert_firings
from continuous_clustering_tpu_torch.ops.state import init_state

from .test_pipeline import make_stream
from .test_pipeline import small_config as pipeline_config
from .test_torch_step import jax_state_numpy, one_torch_thread, ulp_diff  # noqa: F401

NUM_ROWS, NUM_COLS = 32, 220
F32_ULPS = {"azimuth": 1, "inclination": 2, "cont_az": 1, "finish_az": 2, "slot_finish": 2}
AZIMUTH_ABS = ("cont_az", "finish_az", "slot_finish")
EXACT_F32 = ("x", "y", "z", "distance")


def small_config():
    cfg = kitti_config()
    return cfg.replace(range_image=dataclasses.replace(
        cfg.range_image, num_columns=NUM_COLS, ring_buffer_revolutions=4))


def torch_batch(firings, poses, size=None) -> FiringBatch:
    """The port's FiringBatch of ``firings`` padded to ``size`` invalid
    firings (identity poses), built with numpy."""
    F, R = size or len(firings), NUM_ROWS
    xyz = np.full((F, R, 3), np.nan, np.float32)
    stamp = np.zeros((F, R), np.uint64)
    uidx = np.full((F, R), np.iinfo(np.uint64).max, np.uint64)
    inten = np.zeros((F, R), np.int32)
    fidx = np.zeros(F, np.int32)
    pose = np.tile(np.eye(4)[:3], (F, 1, 1)).astype(np.float32)
    for i, (f, p) in enumerate(zip(firings, poses)):
        xyz[i], stamp[i], uidx[i] = f["xyz"], f["stamp"], f["uidx"]
        inten[i], fidx[i], pose[i] = f["intensity"], f["firing_index"], p[:3, :]

    def u32(a):
        return torch.from_numpy((a & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))

    return FiringBatch(
        xyz=torch.from_numpy(xyz), pose=torch.from_numpy(pose),
        stamp_lo=u32(stamp), stamp_hi=u32(stamp >> np.uint64(32)),
        uidx_lo=u32(uidx), uidx_hi=u32(uidx >> np.uint64(32)),
        intensity=torch.from_numpy(inten), firing_index=torch.from_numpy(fidx),
        valid=torch.from_numpy(np.arange(F) < len(firings)))


def to_jax(batch: FiringBatch) -> JaxFiringBatch:
    """The same batch as the JAX package's, through numpy (u32 bits as u32)."""
    u32 = ("stamp_lo", "stamp_hi", "uidx_lo", "uidx_hi")
    return JaxFiringBatch(**{
        name: jnp.asarray(t.numpy().view(np.uint32) if name in u32 else t.numpy())
        for name, t in zip(FiringBatch._fields, batch)})


def compare_states(js: dict, ts: dict, where: str) -> None:
    """Every field by the module's rule; the column placement first."""
    moved = int(np.sum(js["gcol"] != ts["gcol"]))
    assert moved == 0, f"{where}: {moved} cells in another column than the JAX package's"
    for name, ja in js.items():
        ta = ts[name]
        assert ta.shape == ja.shape, f"{where}: {name} shape"
        if name == "incl_diffs":
            bound = 2 * F32_ULPS["inclination"] * np.spacing(np.float32(np.pi / 2))
            np.testing.assert_array_equal(np.isnan(ta), np.isnan(ja), err_msg=f"{where}: {name}")
            err = float(np.nanmax(np.abs(ta - ja), initial=0.0))
            assert err <= bound, f"{where}: {name} differs by {err} > {bound}"
        elif name in AZIMUTH_ABS:
            np.testing.assert_array_equal(np.isnan(ta), np.isnan(ja), err_msg=f"{where}: {name}")
            fin = np.isfinite(ja)
            top = np.float32(np.abs(ja[fin]).max()) if fin.any() else np.float32(0)
            tol = np.spacing(np.float32(np.pi)) + F32_ULPS[name] * np.spacing(top)
            err = float(np.abs(ta[fin] - ja[fin]).max()) if fin.any() else 0.0
            assert err <= tol, f"{where}: {name} differs by {err} > {tol}"
            np.testing.assert_array_equal(ta[~fin], ja[~fin], err_msg=f"{where}: {name}")
        elif ja.dtype.kind == "f" and name not in EXACT_F32:
            u = ulp_diff(ja, ta)
            assert u <= F32_ULPS.get(name, 0), f"{where}: {name} differs by {u} ulp"
        else:
            np.testing.assert_array_equal(ta, ja.astype(ta.dtype), err_msg=f"{where}: {name}")


def moving_poses(n, step=0.005, yaw=0.0004):
    """odom_from_sensor poses of a sensor driving forward and turning slowly."""
    out = []
    for i in range(n):
        p = np.eye(4)
        c, s = np.cos(i * yaw), np.sin(i * yaw)
        p[:2, :2] = [[c, -s], [s, c]]
        p[0, 3] = i * step
        out.append(p)
    return out


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_insert_firings_matches_jax_and_oracle(jitter):
    """One revolution (the scene of tests/test_insertion.py) in one batch:
    every field and scalar against JAX, the frontier after every firing, and
    the occupancy, columns and frontier against the oracle."""
    cfg = small_config()
    scene = make_scene(num_boxes=6, seed=1, spread=20.0)
    xyz, _ = raycast_frame(scene, num_rows=NUM_ROWS, num_columns=NUM_COLS,
                           azimuth_jitter=jitter, seed=7)
    firings = frame_to_firings(xyz)
    poses = [np.eye(4)] * len(firings)

    batch = torch_batch(firings, poses)
    jres = jax.jit(lambda s, b: jax_insert(cfg, s, b))(jax_init(cfg, NUM_ROWS), to_jax(batch))
    tcfg = config_from_dataclass(cfg)
    tres = insert_firings(tcfg, init_state(tcfg, NUM_ROWS, "cpu"), batch)
    compare_states(jax_state_numpy(jres.state), state_to_numpy(tres.state), f"jitter {jitter}")
    np.testing.assert_array_equal(tres.rearmost_per_firing.numpy(),
                                  np.asarray(jres.rearmost_per_firing))
    assert not bool(tres.state.reset_required)

    oracle = OracleContinuousClustering(cfg, NUM_ROWS)
    oracle.set_transform_robot_from_sensor(np.eye(4))
    oracle._segment_column = lambda gcol, pose: None
    for f, p in zip(firings, poses):
        oracle.add_firing(f, p)
    s = tres.state
    assert int(s.prev_rearmost) == oracle.prev_rearmost
    assert int(s.prev_foremost) == oracle.prev_foremost
    assert int(s.first_unfinished) == oracle.first_unfinished
    assert int(s.first_unpublished) == oracle.first_unpublished
    rc = cfg.ring_buffer_max_columns
    o_gcol = np.array([[oracle.cells[lc][r].global_column_index for lc in range(rc)]
                       for r in range(NUM_ROWS)])
    o_dist = np.array([[oracle.cells[lc][r].distance for lc in range(rc)]
                       for r in range(NUM_ROWS)], np.float32)
    np.testing.assert_array_equal(s.gcol.numpy(), o_gcol)
    filled = ~np.isnan(o_dist)
    np.testing.assert_array_equal(~np.isnan(s.distance.numpy()), filled)
    np.testing.assert_allclose(s.distance.numpy()[filled], o_dist[filled], rtol=1e-6)


def test_half_rotation_reset_flag():
    """A first firing spanning more than half a rotation flags a reset, and
    the firings after it in the batch are ignored: both packages agree."""
    cfg = small_config()
    xyz = np.full((NUM_ROWS, 3), np.nan, np.float32)
    xyz[0] = [-10, 0.01, -1.7]
    xyz[1] = [10, -1.0, -1.7]
    scene = make_scene(num_boxes=4, seed=2, spread=15.0)
    later = frame_to_firings(raycast_frame(scene, num_rows=NUM_ROWS, num_columns=NUM_COLS)[0])
    first = dict(later[0], xyz=xyz, firing_index=0)
    firings = [first] + later[1:8]
    poses = [np.eye(4)] * len(firings)
    batch = torch_batch(firings, poses)
    jres = jax.jit(lambda s, b: jax_insert(cfg, s, b))(jax_init(cfg, NUM_ROWS), to_jax(batch))
    tcfg = config_from_dataclass(cfg)
    tres = insert_firings(tcfg, init_state(tcfg, NUM_ROWS, "cpu"), batch)
    assert bool(tres.state.reset_required) and bool(jres.state.reset_required)
    compare_states(jax_state_numpy(jres.state), state_to_numpy(tres.state), "reset")
    # the flagging firing's own two points are written; the later firings are not
    assert int(np.sum(~np.isnan(tres.state.distance.numpy()))) == 2


def test_pipeline_step_matches_jax_every_step():
    """Two revolutions at firing batch 55 with a moving sensor, through a
    step of 48 columns: every step finishes more columns than it holds (a
    full step, ``n_cols == batch_cols``) and an empty batch drains the
    surplus, as the facade does.  Every state field and meta lane after
    every step (cc_rounds included: the CPU port runs the same schedule)."""
    cfg = small_config()
    tcfg = config_from_dataclass(cfg)
    F, B = 55, 48
    scene = make_scene(num_boxes=5, seed=4, spread=15.0)
    firings = []
    for rev in range(2):
        xyz, _ = raycast_frame(scene, num_rows=NUM_ROWS, num_columns=NUM_COLS, seed=4 + rev)
        firings += frame_to_firings(xyz, frame_index=rev)
    poses = moving_poses(len(firings))
    ego = np.eye(4)
    ego[2, 3] = 1.7
    hsg = np.float32(-1.7)
    jcal = JaxEgoCalibration(ego_from_sensor=jnp.asarray(ego[:3], jnp.float32),
                             height_sensor_to_ground=jnp.asarray(hsg))
    tcal = EgoCalibration(ego_from_sensor=torch.tensor(ego[:3], dtype=torch.float32),
                          height_sensor_to_ground=torch.tensor(hsg))
    jstep = jax.jit(lambda s, b: jax_pipeline_step(cfg, s, b, jcal, B))
    js, ts = jax_init(cfg, NUM_ROWS), init_state(tcfg, NUM_ROWS, "cpu")
    full = drained = published = 0
    for k in range(0, len(firings), F):
        chunk, cposes = firings[k:k + F], poses[k:k + F]
        while True:
            batch = torch_batch(chunk, cposes, F)
            js, jinfo = jstep(js, to_jax(batch))
            ts, tinfo = pipeline_step(tcfg, ts, batch, tcal, B)
            where = f"firing {k}, {'drain' if not chunk else 'batch'}"
            compare_states(jax_state_numpy(js), state_to_numpy(ts), where)
            np.testing.assert_array_equal(tinfo.meta.numpy(), np.asarray(jinfo.meta),
                                          err_msg=f"{where}: meta")
            published += int(tinfo.num_new_clusters) > 0
            drained += not chunk
            if int(tinfo.n_cols) != B:
                break
            full += 1
            # the empty batch carries the last firing's pose, as the facade's
            chunk, cposes = [], [cposes[-1]] * F
    assert full > 0 and drained > 0 and published > 0


@pytest.mark.parametrize("single_threaded", [True, False])
def test_device_insertion_facade_matches_jax_facade(monkeypatch, single_threaded):
    """Both facades on device insertion, synchronous and asynchronous: the
    published label of every point is the same id."""
    monkeypatch.setenv("CCT_HOST_INSERT", "0")
    cfg = pipeline_config(stop_after_association=False)
    cfg = cfg.replace(general=dataclasses.replace(cfg.general, is_single_threaded=single_threaded))
    firings, poses = make_stream(seed=3)

    def collect(pipe):
        pipe.reset(NUM_ROWS)
        pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
        labels, clusters = {}, []

        def on_col(a, b, ground_only):
            if not ground_only:
                cloud = pipe.get_columns(a, b)
                for u, i in zip(cloud["globally_unique_point_index"], cloud["id"]):
                    labels[int(u)] = int(i)

        pipe.set_finished_column_callback(on_col)
        pipe.set_finished_cluster_callback(lambda pts, stamp: clusters.append((len(pts), stamp)))
        for f, p in zip(firings, poses):
            pipe.add_firing(f, p)
        pipe.flush()
        labels.pop(int(np.iinfo(np.uint64).max), None)
        return labels, clusters, pipe

    j_labels, j_clusters, jpipe = collect(JaxContinuousClustering(cfg, firing_batch_size=64))
    assert jpipe._host_ins is None
    t_labels, t_clusters, tpipe = collect(ContinuousClustering(
        config_from_dataclass(cfg), firing_batch_size=64, device="cpu", insertion="device"))
    assert tpipe._host_ins is None
    assert len(t_labels) > 1000 and t_clusters
    assert t_labels == j_labels
    assert t_clusters == j_clusters
    assert tpipe._h_cluster_counter == jpipe._h_cluster_counter
