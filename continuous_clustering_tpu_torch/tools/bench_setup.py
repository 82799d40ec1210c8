"""Set-up and timing of the throughput measurement (port of
``continuous_clustering_tpu/tools/bench_setup.py``).

Builds the KITTI-shaped configuration the throughput runs use (64 x 2200
stream, host insertion, the periodic block runner) and measures the steady
rate of the streaming step on the card.  The host clock around every timed
call ends in ``torch.cuda.synchronize()``; on a CPU device the same code
runs (the tests drive it there at a small size) but no rate it gives is a
device figure.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import RangeImageConfig, kitti_config
from ..evaluation.synthetic import frame_to_firings, make_scene, raycast_frame
from ..models.continuous_clustering import ContinuousClustering
from ..models.throughput import make_periodic_block_scan_runner, stack_batches
from ..ops.state import copy_state

# (num_boxes, spread, min_radius) of the throughput scenes: the standard
# scene, a near-field-heavy one (wide wedges, many edges) and a clutter-heavy
# one (many components, slot-table churn)
SCENES = {
    "standard": (24, 35.0, 5.0),
    "near_field": (24, 12.0, 3.0),
    "clutter": (96, 30.0, 4.0),
}
HSG = np.float32(-1.7)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_bench_pipe(num_rows=64, num_cols=2200, ring_revs=10, batch=256, nth=1024,
                    device=None):
    """A host-insertion facade configured like the throughput runs, on
    ``device`` (the card unless named).  Returns (cfg, pipe)."""
    cfg = kitti_config(single_threaded=False)
    cfg = cfg.replace(
        range_image=RangeImageConfig(num_columns=num_cols, ring_buffer_revolutions=ring_revs),
        clustering=dataclasses.replace(cfg.clustering,
                                       cluster_point_trees_every_nth_column=nth),
    )
    pipe = ContinuousClustering(cfg, firing_batch_size=batch, device=device)
    pipe.reset(num_rows)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    return cfg, pipe


def make_bench_scene(num_rows=64, num_cols=2200, scene="standard"):
    """One synthetic KITTI-shaped revolution of a ``SCENES`` entry.  Returns
    (firings, number of finite points)."""
    boxes, spread, min_radius = SCENES[scene]
    sc = make_scene(num_boxes=boxes, seed=0, spread=spread, min_radius=min_radius)
    xyz, _ = raycast_frame(sc, num_rows=num_rows, num_columns=num_cols, seed=0)
    n_points = int(np.sum(~np.isnan(xyz[..., 0])))
    return frame_to_firings(xyz, start_stamp=0, end_stamp=10**8), n_points


def _insert_revolution(pipe, firings, num_cols):
    """Host-insert one revolution; its finished column blocks on the device
    as lists of (ColumnBlock, SegPoses)."""
    ins = pipe._host_ins
    if ins is None:
        raise RuntimeError("the throughput runs need the host-insertion facade")
    blocks, seg_poses = [], []
    first, end, reset = ins.add_firings(firings, [np.eye(4)] * len(firings))
    while first < end:
        staged, n = pipe._stage_block(first, end, reset)
        blk, sp = pipe._upload_block(staged)
        blocks.append(blk)
        seg_poses.append(sp)
        first += n
    ins.clear_before(end - num_cols)
    return blocks, seg_poses


def capture_revolution(pipe, firings, num_cols):
    """ONE revolution of host-inserted blocks, stacked on the device: the
    periodic block runner replays it with per-revolution offsets.  Returns
    (blocks0, seg_poses0, per_rev, hsg)."""
    blocks, seg_poses = _insert_revolution(pipe, firings, num_cols)
    if not blocks:
        raise RuntimeError("no complete columns produced by host insertion")
    hsg = torch.tensor(HSG, device=pipe.state.device)
    return stack_batches(blocks), stack_batches(seg_poses), len(blocks), hsg


def measure_periodic_rate(cfg, pipe, scene, num_cols, n_points, N=8, pairs=3,
                          slab_cols=0, slab_head=0, state=None, k0=0):
    """Steady-state rate of the streaming step through the periodic runner,
    from the difference of a 2N-revolution and an N-revolution call, which
    cancels the per-call fixed cost.

    ``scene`` is ``capture_revolution``'s result.  Starts from a copy of
    ``pipe.state`` unless (state, k0) continue an earlier call's stream.
    Returns a dict with the rate (points/s), ms per revolution, the raw 2N
    rate, ``diff_ok`` (the difference lies in a sane window; otherwise the
    raw rate is reported), the per-call times, the error flags, the checksum
    of the last call's steps, and the advanced ``state``/``k0``."""
    blocks0, segp0, per_rev, hsg = scene
    dev = hsg.device
    if state is None:
        state = copy_state(pipe.state)

    def mk(n):
        return make_periodic_block_scan_runner(cfg, pipe._batch_B, num_cols, n * per_rev,
                                               slab_cols=slab_cols, slab_head=slab_head)

    r1, r2 = mk(N), mk(2 * N)
    chk = None

    def call(r, n_steps):
        nonlocal state, k0, chk
        _sync(dev)
        t0 = time.perf_counter()
        state, chk = r(state, blocks0, segp0, hsg, k0)
        _sync(dev)
        dt = time.perf_counter() - t0
        k0 += n_steps
        return dt

    call(r1, N * per_rev)  # warm-up: allocations, kernel builds and loads
    call(r2, 2 * N * per_rev)
    t1s, t2s = [], []
    for _ in range(pairs):
        t1s.append(call(r1, N * per_rev))
        t2s.append(call(r2, 2 * N * per_rev))
    diff = sum(t2s) - sum(t1s)
    raw = pairs * 2 * N * n_points / sum(t2s)
    diff_ok = 0.25 * sum(t2s) < diff < 0.75 * sum(t2s)
    rate = (pairs * N * n_points / diff) if diff_ok else raw
    return {
        "pts_per_s": rate,
        "raw_2n_pts_per_s": raw,
        "diff_ok": diff_ok,
        "fixed_call_s": max(0.0, (2 * sum(t1s) - sum(t2s)) / pairs),
        "ms_per_rev": n_points / rate * 1000.0,
        "t1s_ms": [t * 1000 for t in t1s],
        "t2s_ms": [t * 1000 for t in t2s],
        "overflow": bool(state.overflow),
        "cc_failed": bool(state.cc_failed),
        "checksum": int(chk.to(torch.int64).sum()),
        "n_steps_n": N * per_rev,
        "per_rev": per_rev,
        "state": state,
        "k0": k0,
    }


def measure_single_rate(cfg, pipe, scene, num_cols, n_points, N=12, calls=2,
                        fixed_s=0.0, slab_cols=0, slab_head=0):
    """One N-revolution periodic call timed ``calls`` times after a warm-up,
    less a per-call fixed cost ``fixed_s`` measured once with
    ``measure_periodic_rate`` (for ordering sweeps; report headline rates
    with ``measure_periodic_rate``)."""
    blocks0, segp0, per_rev, hsg = scene
    dev = hsg.device
    state = copy_state(pipe.state)
    r = make_periodic_block_scan_runner(cfg, pipe._batch_B, num_cols, N * per_rev,
                                        slab_cols=slab_cols, slab_head=slab_head)
    k0, ts = 0, []
    for i in range(calls + 1):
        _sync(dev)
        t0 = time.perf_counter()
        state, _ = r(state, blocks0, segp0, hsg, k0)
        _sync(dev)
        if i > 0:  # call 0 is the warm-up
            ts.append(time.perf_counter() - t0)
        k0 += N * per_rev
    tot = sum(ts)
    f = max(0.0, min(fixed_s, 0.4 * min(ts)))  # clip runaway calibrations
    rate = calls * N * n_points / (tot - calls * f)
    return {
        "pts_per_s": rate,
        "raw_pts_per_s": calls * N * n_points / tot,
        "fixed_sub_ms": f * 1000,
        "ms_per_rev": n_points / rate * 1000.0,
        "t_ms": [t * 1000 for t in ts],
        "overflow": bool(state.overflow),
        "cc_failed": bool(state.cc_failed),
    }


def prepare_rev_blocks(pipe, firings, n_rev, num_cols):
    """Host-insert ``n_rev + 1`` revolutions and stack their column blocks per
    revolution.  Returns (revs, hsg), revs[k] = (blocks, seg_poses).

    Replaying these stacks cyclically is invalid past one pass: a revolution
    whose columns the frontier already passed degenerates to a near no-op
    step.  Use ``capture_revolution`` + ``measure_periodic_rate`` for long
    runs."""
    blocks, seg_poses = [], []
    for _ in range(n_rev + 1):
        b, s = _insert_revolution(pipe, firings, num_cols)
        blocks += b
        seg_poses += s
    per_rev = len(blocks) // (n_rev + 1)
    revs = [(stack_batches(blocks[k * per_rev:(k + 1) * per_rev]),
             stack_batches(seg_poses[k * per_rev:(k + 1) * per_rev]))
            for k in range(n_rev + 1)]
    return revs, torch.tensor(HSG, device=pipe.state.device)
