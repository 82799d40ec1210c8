"""The port's device-insertion multi-sensor step on a mesh whose ring columns
are split over sp (``parallel/multi_sensor.py::make_sharded_step`` with
``mesh``, ``parallel/halo.py::insertion_sharded_step``) against the port's
one-device multi-sensor step, on the CPU.

The firing batches are those of ``tests/test_parallel.py`` (16 x 110, a ring
of 4 revolutions = 440 columns, F = 55 firings a step, a scene per stream),
11 steps (13 where a step takes 40 columns), so the ring wraps.  ``tests/test_torch_halo.py::
test_multi_sensor_step_on_a_dp_mesh_matches_jax`` holds the dp 2 x sp 4
step against the JAX ``make_sharded_step``; these cases cover sp 8, several
dp rows, deferred columns in another shard than the batch, a ring small
enough that insertion writes into the range the chunk clear is clearing, a
batch with no valid firing, a reset, the placement after a step, and a
claim that shifts across a shard boundary and across the ring's end.

Tolerance, fixed before the first comparison: exact.  Every step's meta,
slab and slab tail, and after the run every field of ``gather_state``
(f32 fields bit for bit, NaN where NaN), equal the one-device step's: both
run the same ops on the same values.
"""

from __future__ import annotations

import dataclasses
from typing import List

import pytest
import torch

from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_to_numpy
from continuous_clustering_tpu_torch.models.step import META_NCOLS, META_RESET
from continuous_clustering_tpu_torch.ops.insertion import FiringBatch
from continuous_clustering_tpu_torch.ops.state import CELL_FIELDS
from continuous_clustering_tpu_torch.parallel.mesh import gather_state, shard_pytree
from continuous_clustering_tpu_torch.parallel.multi_sensor import (make_sharded_step,
                                                                   stacked_init)

from .test_parallel import F, NUM_ROWS, make_batches, small_cfg
from .test_torch_halo import assert_exact, cpu_mesh
from .test_torch_multi_sensor import stack, to_torch, torch_calib
from .test_torch_step import one_torch_thread  # noqa: F401

N_STEPS = 11


def port_cfg(revolutions: int = 4):
    cfg = small_cfg()
    return config_from_dataclass(cfg.replace(range_image=dataclasses.replace(
        cfg.range_image, ring_buffer_revolutions=revolutions)))


def streams(n: int, n_steps: int = N_STEPS) -> List[List[FiringBatch]]:
    return [[to_torch(b) for b in make_batches(seed=7 + s, n_steps=n_steps)] for s in range(n)]


def no_firing(batch: FiringBatch) -> FiringBatch:
    """``batch`` with every firing invalid and every point missing."""
    return batch._replace(xyz=torch.full_like(batch.xyz, float("nan")),
                          valid=torch.zeros_like(batch.valid))


def spanning(batch: FiringBatch, far: FiringBatch) -> FiringBatch:
    """``batch`` whose first firing takes its lower half of rows from the
    firing of ``far`` 27 columns on: a first firing spanning more than half
    a rotation, which flags a reset."""
    xyz = batch.xyz.clone()
    xyz[0, NUM_ROWS // 2:] = far.xyz[27, NUM_ROWS // 2:]
    return batch._replace(xyz=xyz)


def drive(cfg, mesh, per_stream, batch_cols, slab=(0, 0), state0=None):
    """Run the step on ``mesh`` and the one-device step on the same stacked
    batches, every step's meta, slab and tail held equal; returns (sharded
    state, one-device state, the one-device metas, and after each step the
    one-device ``prev_rearmost``, ``ring_start`` and ``gcol``)."""
    S = len(per_stream)
    one = stacked_init(cfg, NUM_ROWS, S, "cpu") if state0 is None else state0
    sharded = shard_pytree(mesh, one, stacked=True)
    run = make_sharded_step(cfg, batch_cols, slab_cols=slab[0], slab_head=slab[1], mesh=mesh)
    one_run = make_sharded_step(cfg, batch_cols, slab_cols=slab[0], slab_head=slab[1],
                                device="cpu")
    cal = stack([torch_calib()] * S)
    metas, after = [], []
    for k in range(len(per_stream[0])):
        batch = stack([st[k] for st in per_stream])
        sharded, info = run(sharded, batch, cal)
        one, oinfo = one_run(one, batch, cal)
        for part in ("meta", "slab", "slab_ext"):
            assert torch.equal(getattr(info, part), getattr(oinfo, part)), f"step {k}: {part}"
        metas.append(oinfo.meta)
        after.append((one.prev_rearmost.clone(), one.ring_start.clone(), one.gcol.clone()))
    assert_exact(state_to_numpy(one), state_to_numpy(gather_state(sharded)),
                 f"mesh {mesh.shape} vs one device")
    return sharded, one, torch.stack(metas), after


CASES = {
    # name: (dp, sp, streams, batch columns, ring revolutions, slab)
    "dp1-sp8": (1, 8, 2, F + 32, 4, (0, 0)),
    "dp2-sp8-slab": (2, 8, 2, F + 32, 4, (128, 64)),
    "dp4-sp2": (4, 2, 4, F + 32, 4, (0, 0)),
    "deferred-sp8": (1, 8, 2, 40, 4, (0, 0)),
    "small-ring-sp4": (1, 4, 2, 40, 2, (0, 0)),
    "empty-and-reset-sp4": (2, 4, 2, F + 32, 4, (0, 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_column_sharded_insertion_equals_the_one_device_step(case):
    dp, nsp, S, B, revs, slab = CASES[case]
    cfg = port_cfg(revs)
    rc = cfg.ring_buffer_max_columns
    w = rc // nsp
    per_stream = streams(S, n_steps=N_STEPS + 2 if B < F else N_STEPS)
    if case.startswith("empty-and-reset"):
        per_stream[0][2] = no_firing(per_stream[0][2])
        per_stream[1][0] = spanning(per_stream[1][0], per_stream[1][1])
    sharded, one, metas, after = drive(cfg, cpu_mesh(dp, nsp), per_stream, B, slab)
    gcol0, n_cols = metas[..., 0], metas[..., META_NCOLS]
    assert not bool(one.cc_failed.any())
    if case.startswith("empty-and-reset"):
        assert int(n_cols[2, 0]) == 0 and int(n_cols[1, 0]) > 0
        assert bool(metas[0, 1, META_RESET]) and int(n_cols[:, 1].sum()) == 0
        return
    assert int(one.ring_start.min()) > 0 and int(gcol0.max()) + B > rc, "no ring wrap"
    if B < F:
        # columns were deferred: in some step the newest finished column
        # lies in another shard than every column of the batch
        assert int(n_cols.max()) == B
        end = gcol0 + n_cols
        assert any(int(rear[s]) > int(end[k, s]) and
                   (int(rear[s]) - 1) % rc // w != (int(end[k, s]) - 1) % rc // w
                   for k, (rear, _, _) in enumerate(after) for s in range(S))
    if case.startswith("small-ring"):
        # cells in the range a step's chunk clear passed that hold a column a
        # ring ahead of the one the clear expects: the gcol gate kept them
        kept = sum(int((gcol[s][:, g % rc] > g).sum())
                   for (_, rs_old, _), (_, rs_new, gcol) in zip(after, after[1:])
                   for s in range(S) for g in range(max(int(rs_old[s]), 0), int(rs_new[s])))
        assert kept > 0, "the gate never kept a cell"


def test_sharded_insertion_step_is_actually_sharded():
    """After a step every shard's ring tensors hold rc / sp columns of its dp
    row's streams, on its mesh device, in a storage of their own (no
    full-width ring field stays behind); the other fields hold the row's
    streams."""
    cfg = port_cfg()
    mesh = cpu_mesh(2, 4)
    S, w = 4, cfg.ring_buffer_max_columns // 4
    sharded = drive(cfg, mesh, streams(S, n_steps=1), F + 32)[0]
    for i, row in enumerate(sharded.shards):
        for j, shard in enumerate(row):
            for name in CELL_FIELDS:
                t = getattr(shard, name)
                assert t.shape == (S // 2, NUM_ROWS, w), (i, j, name)
                assert t.device == mesh.devices[i][j]
                assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), name
            assert shard.slot_parent.shape[0] == S // 2 and shard.ring_start.shape == (S // 2,)
    assert int(sharded.shards[1][0].first_unpublished[1]) >= 0


@pytest.mark.parametrize("where", ["shard-boundary", "ring-end"])
def test_a_shifted_claim_crosses_the_shard_boundary(where):
    """A firing whose cell is taken moves its points to the next column
    (reference …cpp:190-202).  Plant taken cells in the last column of
    shard 0 (109 -> 110, a shard boundary) or of the ring (439 -> 0, the
    ring's end and a shard boundary), one stream over sp 4: the shifted
    points must land in the next shard, as in the one-device step."""
    cfg = port_cfg()
    rc, w = cfg.ring_buffer_max_columns, cfg.ring_buffer_max_columns // 4
    P = w - 1 if where == "shard-boundary" else rc - 1
    n_steps = P // F + 2
    per_stream = streams(1, n_steps)
    plain = drive(cfg, cpu_mesh(1, 1), per_stream, F + 32)[1]
    state0 = stacked_init(cfg, NUM_ROWS, 1, "cpu")
    for name, value in (("distance", 4.0), ("x", 1.0), ("y", 4.0), ("z", -1.0), ("gcol", P)):
        getattr(state0, name)[0, :, P] = value
    planted = drive(cfg, cpu_mesh(1, 4), per_stream, F + 32, state0=state0)[1]
    # the firing that took column P without the plant took column P + 1 with it
    hit = plain.gcol[0, :, P] == P
    assert int(hit.sum()) > 0
    nxt = (P + 1) % rc
    assert torch.equal(planted.firing_index[0, hit, nxt], plain.firing_index[0, hit, P])
    assert bool((planted.gcol[0, hit, nxt] == P + 1).all())
