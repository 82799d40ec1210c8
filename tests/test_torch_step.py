"""The port's ``pipeline_step_block`` against the JAX step, step by step.

The same dense ``ColumnBlock`` stream (built from raycast frames with numpy,
as ``__graft_entry__._synthetic_blocks`` builds it, without the native
insertion engine) goes through the JAX step and the port's step on the CPU.  After every step the two states
must agree on every field, and the meta vector, the join tables and the
publish slab must agree.

Tolerance: integer and boolean fields, labels, the meta vector (cc_rounds
included: the CPU port runs the same Jacobi schedule) and the join tables
exactly; f32 fields exactly, except the ones derived from
``mad = arcsin(max_d / dist)`` (association.py:335): ``finish_az`` and
``slot_finish`` within ``ASIN_ULPS`` ulp, because XLA's f32 arcsin differs
from the correctly rounded value the port uses by up to 2 ulp.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from continuous_clustering_tpu.config import kitti_config
from continuous_clustering_tpu.evaluation.synthetic import make_scene, raycast_frame
from continuous_clustering_tpu.models.step import SegPoses as JaxSegPoses
from continuous_clustering_tpu.models.step import pipeline_step_block as jax_step
from continuous_clustering_tpu.ops.ground_segmentation import SegmentInputs, ground_segment_columns
from continuous_clustering_tpu.ops.ingest import ColumnBlock as JaxColumnBlock
from continuous_clustering_tpu.ops.ingest import ingest_columns
from continuous_clustering_tpu.ops.state import init_state as jax_init
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.models.step import SegPoses, pipeline_step_block
from continuous_clustering_tpu_torch.ops.ingest import ColumnBlock
from continuous_clustering_tpu_torch.ops.readout import FETCH_ORDER
from continuous_clustering_tpu_torch.ops.state import init_state

ASIN_ULPS = 2
MAD_FIELDS = ("finish_az", "slot_finish")
HSG = np.float32(-1.5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops run on small tensors: one intra-op thread per
    test process avoids oversubscribing the cores shared by parallel test
    workers (OpenMP worker threads spin while they wait)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(num_cols=220):
    cfg = kitti_config()
    return cfg.replace(range_image=dataclasses.replace(
        cfg.range_image, num_columns=num_cols, ring_buffer_revolutions=4))


def scene_frames(num_rows, num_cols, n_rev, seed=3, num_boxes=4):
    """(R, C, 3) f32 frames of one raycast scene, one per revolution."""
    scene = make_scene(num_boxes=num_boxes, seed=seed, spread=15.0)
    return [np.asarray(raycast_frame(scene, num_rows=num_rows, num_columns=num_cols,
                                     seed=seed + rev)[0], np.float32).transpose(1, 0, 2)
            for rev in range(n_rev)]


def serpentine_frames(num_rows=32, num_cols=220, n_rev=2):
    """One two-cell-thick zigzag ribbon at 6 m spanning the whole rotation
    (the adversarial CC input of tests/test_cc_pallas.py)."""
    inc = np.deg2rad(np.linspace(2.0, -24.8, num_rows))
    az = np.pi - np.arange(num_cols) * (2.0 * np.pi / num_cols)
    xyz = np.full((num_rows, num_cols, 3), np.nan, np.float32)
    for c in range(num_cols):
        ph = c % 24
        r = 2 + (ph if ph < 12 else 24 - ph)
        for dr in (0, 1):
            row = min(num_rows - 1, r + dr)
            xyz[row, c] = 6.0 * np.array([np.cos(inc[row]) * np.cos(az[c]),
                                          np.cos(inc[row]) * np.sin(az[c]),
                                          np.sin(inc[row])])
    return [xyz] * n_rev


def column_blocks(frames, batch):
    """Dense JAX (ColumnBlock, SegPoses) steps of consecutive revolutions,
    as ``__graft_entry__._synthetic_blocks`` builds them."""
    num_rows, num_cols = frames[0].shape[:2]
    az_w = 2.0 * math.pi / num_cols
    steps = []
    for rev, xyz in enumerate(frames):
        for c0 in range(0, num_cols, batch):
            n = min(batch, num_cols - c0)
            g0 = rev * num_cols + c0
            sl = np.full((num_rows, batch, 3), np.nan, np.float32)
            sl[:, :n] = xyz[:, c0:c0 + n]
            x, y, z = sl[..., 0], sl[..., 1], sl[..., 2]
            dist = np.sqrt(x * x + y * y + z * z)
            cont = (g0 + np.arange(batch, dtype=np.float32))[None, :] * az_w
            zeros_u = jnp.zeros((num_rows, batch), jnp.uint32)
            blk = JaxColumnBlock(
                gcol0=jnp.int32(g0), n_cols=jnp.int32(n),
                x=jnp.asarray(x), y=jnp.asarray(y), z=jnp.asarray(z),
                distance=jnp.asarray(dist),
                azimuth=jnp.asarray(np.arctan2(y, x).astype(np.float32)),
                inclination=jnp.asarray(np.arctan2(z, np.hypot(x, y)).astype(np.float32)),
                cont_az=jnp.asarray(np.broadcast_to(cont, dist.shape).astype(np.float32)),
                stamp_lo=zeros_u, stamp_hi=zeros_u,
                uidx_lo=jnp.asarray(np.arange(num_rows * batch, dtype=np.uint32).reshape(
                    num_rows, batch) + np.uint32(g0 * num_rows)),
                uidx_hi=zeros_u,
                intensity=jnp.zeros((num_rows, batch), jnp.int32),
                firing_index=jnp.zeros((num_rows, batch), jnp.int32),
                prev_rearmost=jnp.int32(g0 + n), prev_foremost=jnp.int32(g0 + n),
                first_unfinished=jnp.int32(g0 + n),
                first_unpublished_init=jnp.int32(0 if g0 == 0 else -1),
                reset_required=jnp.asarray(False),
            )
            segp = JaxSegPoses(
                sensor_pos=jnp.zeros((batch, 3), jnp.float32),
                ego_rot=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (batch, 3, 3)),
                ego_trans=jnp.zeros((batch, 3), jnp.float32),
            )
            steps.append((blk, segp))
    return steps


def jax_pre_association(cfg, frames, batch, k):
    """The JAX state after k full steps plus the ingest and segmentation of
    step k, and step k's block: the input of association at step k."""
    steps = column_blocks(frames, batch)
    js = jax_init(cfg, frames[0].shape[0])
    jstep = jax.jit(lambda s, b, p: jax_step(cfg, s, b, p, jnp.float32(HSG), batch))
    for blk, segp in steps[:k]:
        js, _ = jstep(js, blk, segp)
    blk, segp = steps[k]

    @jax.jit
    def pre(s):
        s = ingest_columns(cfg, s, blk, batch)
        return ground_segment_columns(cfg, s, SegmentInputs(
            gcol0=blk.gcol0, n_cols=blk.n_cols, sensor_pos=segp.sensor_pos,
            ego_rot=segp.ego_rot, ego_trans=segp.ego_trans,
            height_sensor_to_ground=jnp.float32(HSG)), batch)

    return pre(js), blk


def stream_states(cfg, num_rows, batch, n_steps):
    """Numpy JAX states after each of the first ``n_steps`` steps."""
    steps = column_blocks(scene_frames(num_rows, cfg.range_image.num_columns, 2), batch)
    js = jax_init(cfg, num_rows)
    jstep = jax.jit(lambda s, b, p: jax_step(cfg, s, b, p, jnp.float32(HSG), batch))
    out = []
    for blk, segp in steps[:n_steps]:
        js, _ = jstep(js, blk, segp)
        out.append(jax_state_numpy(js))
    return out


def jax_state_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def to_torch_block(blk, segp):
    """A JAX (ColumnBlock, SegPoses) pair as the port's, through numpy."""
    kw = {}
    for name in ColumnBlock._fields:
        a = np.asarray(getattr(blk, name))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        kw[name] = torch.from_numpy(np.array(a))
    seg = SegPoses(*[torch.from_numpy(np.array(np.asarray(a))) for a in segp])
    return ColumnBlock(**kw), seg


def ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units in the last place between two f32 arrays
    (NaN == NaN, +-inf exact)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    both_nan = np.isnan(a) & np.isnan(b)
    if np.any(np.isnan(a) != np.isnan(b)):
        return 2**31
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(2**31) - ia, ia)
    ib = np.where(ib < 0, -(2**31) - ib, ib)
    d = np.where(both_nan, 0, np.abs(ia - ib))
    return int(d.max()) if d.size else 0


def assert_states_equal(js: dict, ts: dict, where: str) -> None:
    for name, ja in js.items():
        ta = ts[name]
        assert ta.shape == ja.shape, f"{where}: {name} shape"
        if name in MAD_FIELDS:
            u = ulp_diff(ja, ta)
            assert u <= ASIN_ULPS, f"{where}: {name} differs by {u} ulp"
        elif ja.dtype.kind == "f":
            np.testing.assert_array_equal(ta, ja, err_msg=f"{where}: {name}")
        else:
            np.testing.assert_array_equal(ta, ja.astype(ta.dtype), err_msg=f"{where}: {name}")


def assert_slabs_equal(jslab: np.ndarray, tslab: np.ndarray, where: str) -> None:
    assert jslab.shape == tslab.shape, f"{where}: slab shape"
    fin = FETCH_ORDER.index("finish_az")
    for i, name in enumerate(FETCH_ORDER):
        if i == fin:
            u = ulp_diff(jslab[i].view(np.float32), tslab[i].view(np.float32))
            assert u <= ASIN_ULPS, f"{where}: slab {name} differs by {u} ulp"
        else:
            np.testing.assert_array_equal(tslab[i], jslab[i], err_msg=f"{where}: slab {name}")


def run_both(cfg, frames, batch, slab_cols=0, slab_head=0):
    """Stream the blocks of ``frames`` through both steps, comparing after
    every step; returns the number of steps that published a cluster."""
    steps = column_blocks(frames, batch)
    num_rows = frames[0].shape[0]
    js = jax_init(cfg, num_rows)
    tcfg = config_from_dataclass(cfg)
    ts = init_state(tcfg, num_rows, "cpu")
    jstep = jax.jit(lambda s, b, p: jax_step(cfg, s, b, p, jnp.float32(HSG), batch,
                                             slab_cols=slab_cols, slab_head=slab_head))
    published = 0
    for k, (blk, segp) in enumerate(steps):
        js, jinfo = jstep(js, blk, segp)
        tblk, tseg = to_torch_block(blk, segp)
        ts, tinfo = pipeline_step_block(tcfg, ts, tblk, tseg, torch.tensor(HSG), batch,
                                        slab_cols=slab_cols, slab_head=slab_head)
        where = f"step {k}"
        assert_states_equal(jax_state_numpy(js), state_to_numpy(ts), where)
        np.testing.assert_array_equal(tinfo.meta.numpy(), np.asarray(jinfo.meta),
                                      err_msg=f"{where}: meta")
        for part in ("slab", "slab_ext"):
            assert_slabs_equal(np.asarray(getattr(jinfo, part)),
                               getattr(tinfo, part).numpy(), f"{where} {part}")
        published += int(tinfo.num_new_clusters) > 0
    return published


@pytest.mark.parametrize("stream,num_rows,slab", [
    ("scene", 32, (128, 64)), ("scene", 64, (0, 0)), ("serpentine", 32, (128, 0))])
def test_step_matches_jax_every_step(stream, num_rows, slab):
    """Two revolutions at 32 rows (publish slab split into head and tail),
    at 64 rows, and of the serpentine: every state field after every step."""
    cfg = small_cfg()
    if stream == "scene":
        frames = scene_frames(num_rows, cfg.range_image.num_columns, 2)
    else:
        frames = serpentine_frames(num_rows)
    published = run_both(cfg, frames, 48, slab_cols=slab[0], slab_head=slab[1])
    assert published > 0
