"""Column-sharded execution with a halo window (port of
``continuous_clustering_tpu/parallel/halo.py``).

The ring stays sharded by columns over the mesh's ``sp`` axis
(``mesh.shard_pytree``); every other field of the state is replicated.
Each step, as in the JAX module:

1. **Window.**  Every shard contributes the window columns it owns (the JAX
   module's one masked ``psum``; exactly one shard owns each column), which
   assembles one (F, R, WS) i32 scratch ring, WS = H + B + 8, on the step's
   device: scratch slot t holds global column g_t == t (mod WS) of
   [gcol0 - H, gcol0 - H + WS).  f32 fields travel as their bits.
2. **Step.**  The unchanged ``pipeline_step_block`` parts run on the
   scratch ring with ``ring_capacity`` = the real ring's columns and
   ``skip_clear``, once per distinct device of the mesh (once on one card),
   K1 and K2 launched once for every stream that device runs
   (``ops/association.py::window_kernels``).  The outputs are replicated by
   construction, so every shard on a device takes that device's result.
3. **Finish.**  The representatives of slots allocated this step are
   translated from scratch to real ring coordinates; each shard writes back
   the batch columns it owns, then applies the bounded chunk clear with the
   gcol gate of ``ops.state.clear_columns_chunk``.
4. **Slab.**  With ``slab_cols``, a second gather assembles the post-step
   publish window on a scratch ring of ``slab_cols + 8`` columns and the
   unchanged packed readout runs on it; the join tables ride the meta.

``stacked`` adds a leading sensor axis, split over ``dp``: a device runs
the streams of every dp row it holds a shard of, the port's counterpart of
the JAX module's ``jax.vmap`` of the shard body.  Nothing is read back to
the host inside a step.  On one card every shard lives on the card, which
saves no memory but runs the same arithmetic as a mesh of several.

The scratch states own their ring tensors (fresh gathers) and share the
shards' other fields, which the ops re-bind and never write in place; the
shards' ring tensors are written in place only after every device's step
has read its window.

``make_halo_sharded_step`` takes host-inserted column blocks, which step 2
ingests into the scratch ring.  ``insertion_sharded_step`` (the
multi-sensor step of ``parallel/multi_sensor.py`` on a mesh with sp > 1)
inserts firing batches first: a firing may land anywhere within half a
revolution of the frontier, and deferred columns stay in the ring, so
insertion cannot run on the window.  It runs the firing loop on each
stream's ``distance`` plane gathered whole, routes each winner's write to
the shard that owns its column, and then runs steps 1-4 with nothing to
ingest.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..models.step import (META_FU_OLD, EgoCalibration, SegPoses, StepInfo, _publish_slab,
                           block_segment_inputs, finish_step, frontier_and_poses)
from ..ops.association import complete_association, window_arrays, window_kernels
from ..ops.ground_segmentation import SegmentInputs, ground_segment_columns
from ..ops.ingest import ColumnBlock, ingest_columns
from ..ops.insertion import CARRIED, FiringBatch, apply_claims, claim_firings
from ..ops.readout import join_tables
from ..ops.state import CELL_FIELDS, CLEAR_VALUES, RingState
from .mesh import FIELDS, Mesh, ShardedState, _pick, _to, stream_state

I32 = torch.int32
WS_PAD = 8
NON_CELL_FIELDS = tuple(n for n in FIELDS if n not in CLEAR_VALUES)


def _to_i32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == I32:
        return t
    if t.dtype == torch.bool:
        return t.to(I32)
    return t.view(I32)


def _from_i32(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == I32:
        return t
    if dtype == torch.bool:
        return t != 0
    return t.view(dtype)


def _gather_window(shards: Sequence[RingState], g0: torch.Tensor, width: int,
                   device: torch.device) -> torch.Tensor:
    """(F, R, width) i32 cell fields, on ``device``, of the global columns
    [g0, g0 + width), column g at slot g mod width, from one stream's
    column shards (shard j holds ring columns [j w, (j + 1) w))."""
    w = shards[0].ring_cols
    rc = w * len(shards)
    t = torch.arange(width, dtype=I32, device=device)
    lcol = torch.remainder(g0 + torch.remainder(t - g0, width), rc)
    owner = lcol // w
    li = lcol - owner * w
    win = None
    for j, sh in enumerate(shards):
        idx = li.to(sh.device, torch.int64)
        part = torch.stack([_to_i32(getattr(sh, n)[:, idx]) for n in CELL_FIELDS]).to(device)
        win = part if win is None else torch.where(owner == j, part, win)
    return win


def _with_cells(base: RingState, cells: torch.Tensor, device: torch.device) -> RingState:
    """A scratch ``RingState`` on ``device``: ring fields from ``cells``, the
    other fields those of ``base``."""
    kw = {n: _from_i32(cells[i], getattr(base, n).dtype) for i, n in enumerate(CELL_FIELDS)}
    kw.update({n: getattr(base, n).to(device) for n in NON_CELL_FIELDS})
    return RingState(**kw)


class HaloResult(NamedTuple):
    """One stream's step on one device."""

    state: RingState            # non-ring fields: the step's result
    cells: torch.Tensor         # (F, R, WS) i32 scratch ring after the step
    info: StepInfo              # without the slab
    ring_start_old: torch.Tensor
    gcol0: torch.Tensor
    n_cols: torch.Tensor


def halo_step_local(config: Config, streams: Sequence[Sequence[RingState]],
                    blocks: Sequence[Optional[ColumnBlock]], seg_ins: Sequence[SegmentInputs],
                    batch_cols: int, device: torch.device) -> List[HaloResult]:
    """Steps 1-2 and the slot translation of step 3 for ``streams`` (each a
    list of column shards, shard j owning ring columns [j w, (j + 1) w)) on
    ``device``, K1 and K2 launched once for all of them.  Each stream's
    window is ingested from its host ``ColumnBlock``, or, where the block is
    None, holds cells the device insertion already wrote into the shards;
    then its columns ``seg_ins`` names are segmented.  Inputs are on
    ``device``.  Reads the shards, writes nothing to them.

    Unlike the JAX function of this name, which is the body of one shard
    inside ``shard_map`` (one local shard in, that shard's new state out),
    this takes whole streams of shards and a device, and leaves the
    write-back to its caller."""
    H = config.clustering.max_steps_in_row
    B = batch_cols
    WS = H + B + WS_PAD
    pre = []
    for shards, blk, seg_in in zip(streams, blocks, seg_ins):
        st = _with_cells(shards[0], _gather_window(shards, seg_in.gcol0 - H, WS, device), device)
        if blk is not None:
            st = ingest_columns(config, st, blk, B)
        st = ground_segment_columns(config, st, seg_in, B)
        win = window_arrays(config, st, seg_in.gcol0, seg_in.n_cols, B)
        pre.append((shards, seg_in, st, st.cluster_counter, win))
    ccs = window_kernels(config, [p[4] for p in pre])
    out = []
    for (shards, seg_in, st, counter_old, win), cc in zip(pre, ccs):
        base = shards[0]
        rc = base.ring_cols * len(shards)
        gcol0, n_cols = seg_in.gcol0, seg_in.n_cols
        cres = complete_association(config, st, gcol0, n_cols, B, win, cc,
                                    ring_capacity=rc, skip_clear=True)
        st, info = finish_step(config, cres, gcol0, n_cols, counter_old, 0, 0)
        # representatives of slots allocated this step are scratch-ring glids
        # (row * WS + slot); translate them to the real ring's
        win0 = gcol0 - H
        new_alloc = st.slot_live & ~base.slot_live.to(device)
        rep = st.slot_rep
        g_rep = win0 + torch.remainder(torch.remainder(rep, WS) - win0, WS)
        rep_real = (rep // WS) * rc + torch.remainder(g_rep, rc)
        st.slot_rep = torch.where(new_alloc & (rep >= 0), rep_real, rep).to(I32)
        cells = torch.stack([_to_i32(getattr(st, n)) for n in CELL_FIELDS])
        out.append(HaloResult(st, cells, info, base.ring_start.to(device), gcol0, n_cols))
    return out


def _write_back(shard: RingState, j: int, nsp: int, res: HaloResult, WS: int) -> None:
    """Step 3 on one column shard, in place: the batch columns it owns from
    the scratch ring, then the chunk clear of [ring_start_old, ring_start)
    gated on the stored gcol, as ``ops.state.clear_columns_chunk`` does."""
    dev = shard.device
    w = shard.ring_cols
    rc = w * nsp
    gcol0, n_cols = res.gcol0.to(dev), res.n_cols.to(dev)
    rs_old, rs_new = res.ring_start_old.to(dev), res.state.ring_start.to(dev)
    cells = res.cells.to(dev)
    gl = j * w + torch.arange(w, dtype=I32, device=dev)
    boff = torch.remainder(gl - torch.remainder(gcol0, rc), rc)
    is_batch = boff < n_cols
    sb = torch.remainder(gcol0 + boff, WS).long()
    new = {}
    for i, n in enumerate(CELL_FIELDS):
        loc = getattr(shard, n)
        new[n] = torch.where(is_batch, _from_i32(cells[i][:, sb], loc.dtype), loc)
    coff = torch.remainder(gl - torch.remainder(torch.clamp_min(rs_old, 0), rc), rc)
    cmask = (coff < rs_new - rs_old)[None, :] & (new["gcol"] <= (rs_old + coff)[None, :])
    for n, v in CLEAR_VALUES.items():
        getattr(shard, n).copy_(new[n].masked_fill_(cmask, v))


def _stream_shards(state: ShardedState, i: int) -> List[List[RingState]]:
    """The streams of dp row ``i``, each as its list of column shards (views
    of the row's shards when stacked)."""
    row = state.shards[i]
    if not state.stacked:
        return [row]
    return [[stream_state(sh, k) for sh in row] for k in range(row[0].x.shape[0])]


def _streams(state: ShardedState):
    """(streams of each dp row as lists of column shards, stream ids of each
    dp row, and for each distinct device the streams of every dp row it
    holds a shard of, by id).  A replicated state is one stream, id 0."""
    mesh = state.mesh
    rows = [_stream_shards(state, i) for i in range(len(mesh.devices))]
    ids = [[i * len(r) + k for k in range(len(r))] if state.stacked else [0]
           for i, r in enumerate(rows)]
    jobs: Dict[torch.device, Dict[int, List[RingState]]] = {}
    for dev in mesh.distinct_devices():
        mine = jobs.setdefault(dev, {})
        for i, dev_row in enumerate(mesh.devices):
            if dev in dev_row:
                for s, shards in zip(ids[i], rows[i]):
                    mine.setdefault(s, shards)
    return rows, ids, jobs


StreamInputs = Callable[[torch.device, int], Tuple[Optional[ColumnBlock], SegmentInputs]]


def _step_sharded(config: Config, state: ShardedState, inputs: StreamInputs, batch_cols: int,
                  slab_cols: int, slab_head: int) -> StepInfo:
    """Steps 1-4 of the module docstring on every stream of ``state``, in
    place; ``inputs(device, s)`` gives stream ``s``'s block (None: its cells
    are in the shards already) and segmentation inputs on ``device``.
    Returns the ``StepInfo`` (stacked: with the sensor axis) on the mesh's
    first device."""
    mesh = state.mesh
    nsp = mesh.shape["sp"]
    WS = config.clustering.max_steps_in_row + batch_cols + WS_PAD
    out_dev = mesh.devices[0][0]
    rows, ids, jobs = _streams(state)
    # 1-2: every device steps the streams of each dp row it holds a shard of
    results: Dict[torch.device, Dict[int, HaloResult]] = {}
    for dev, streams in jobs.items():
        blocks, seg_ins = zip(*[inputs(dev, s) for s in streams])
        res = halo_step_local(config, list(streams.values()), blocks, seg_ins, batch_cols, dev)
        results[dev] = dict(zip(streams, res))
    # 3: every shard takes its device's results
    for i, dev_row in enumerate(mesh.devices):
        for j, dev in enumerate(dev_row):
            mine = [results[dev][s] for s in ids[i]]
            for shards, r in zip(rows[i], mine):
                _write_back(shards[j], j, nsp, r, WS)
            for n in NON_CELL_FIELDS:
                t = (torch.stack([getattr(r.state, n) for r in mine]) if state.stacked
                     else getattr(mine[0].state, n))
                setattr(state.shards[i][j], n, t.to(dev))
    # 4: the publish slab, from the written-back shards
    infos: Dict[int, StepInfo] = {}
    for i, dev_row in enumerate(mesh.devices):
        dev = dev_row[0]
        for s, shards in zip(ids[i], rows[i]):
            if s in infos:
                continue
            r = results[dev][s]
            info = r.info
            if slab_cols:
                fu_old = info.meta[META_FU_OLD]
                cells = _gather_window(shards, torch.clamp_min(fu_old, 0), slab_cols + WS_PAD, dev)
                slab, slab_ext = _publish_slab(config, _with_cells(r.state, cells, dev),
                                               fu_old, slab_cols, slab_head)
                info = StepInfo(meta=torch.cat([info.meta, join_tables(r.state).reshape(-1)]),
                                slab=slab, slab_ext=slab_ext)
            infos[s] = StepInfo(*[t.to(out_dev) for t in info])
    if not state.stacked:
        return infos[0]
    return StepInfo(*[torch.stack(xs) for xs in zip(*[infos[s] for s in sorted(infos)])])


def make_halo_sharded_step(config: Config, mesh: Mesh, batch_cols: int, stacked: bool = False,
                           slab_cols: int = 0, slab_head: int = 0):
    """The column-sharded step: ``run(state, block, seg_poses, hsg) ->
    (state, StepInfo)`` with ``state`` a ``ShardedState`` on ``mesh``
    (``mesh.shard_pytree(mesh, state, stacked)``, the JAX module's
    ``place_state``), updated in place.  ``stacked`` adds a leading sensor
    axis split over dp to the state, the block, the poses, ``hsg`` and the
    returned ``StepInfo``.  The ``StepInfo`` lives on the mesh's first
    device.  ``slab_cols``/``slab_head`` add the publish slab, as
    ``pipeline_step_block`` takes them."""

    def run(state: ShardedState, block: ColumnBlock, segp: SegPoses, hsg: torch.Tensor):
        if state.mesh != mesh or state.stacked != stacked:
            raise ValueError("the state is not placed on this step's mesh "
                             f"(stacked={stacked}); use shard_pytree(mesh, state, stacked)")

        def inputs(dev: torch.device, s: int):
            blk, sp, h = ((_pick(block, s), _pick(segp, s), hsg[s]) if stacked
                          else (block, segp, hsg))
            blk = _to(blk, dev)
            return blk, block_segment_inputs(blk, _to(sp, dev), h.to(dev))

        return state, _step_sharded(config, state, inputs, batch_cols, slab_cols, slab_head)

    return run


def insertion_sharded_step(config: Config, state: ShardedState, batch: FiringBatch,
                           calib: EgoCalibration, batch_cols: int, slab_cols: int = 0,
                           slab_head: int = 0) -> StepInfo:
    """One device-insertion step (``pipeline_step``) of every stream of a
    stacked ``state`` whose ring columns are split over sp, in place; the
    batch and the calibration carry the sensor axis.  Per stream it computes
    exactly what ``pipeline_step`` computes on that stream alone.

    Insertion: every device gathers the ``distance`` plane of each stream it
    steps whole from the stream's shards (the one field ever assembled at
    full ring width, for the step's firing loop only) and runs the firing
    loop on it (``ops/insertion.py::claim_firings``); no shard is written
    until every device has read.  Each shard then takes back its columns of
    the plane, the winners whose column it owns (``apply_claims``, owner
    ``lcol // w``) and the carried scalars.  Then the frontier, the poses
    and steps 1-4 of the module docstring, with nothing to ingest.  Returns
    the stacked ``StepInfo`` on the mesh's first device."""
    mesh = state.mesh
    rows, ids, jobs = _streams(state)
    claimed = {}
    for dev, streams in jobs.items():
        for s, shards in streams.items():
            base = shards[0]
            b, cal = _to(_pick(batch, s), dev), _to(_pick(calib, s), dev)
            plane = torch.cat([sh.distance.to(dev) for sh in shards], dim=1)
            claims = claim_firings(config, base, plane, b)
            claims.scalars["first_unfinished"], seg_in = frontier_and_poses(
                base.first_unfinished.to(dev), claims.rearmost_per_firing,
                claims.scalars["first_unfinished"], claims.scalars["reset_required"], b.pose,
                cal, batch_cols)
            claimed[dev, s] = (plane, claims, seg_in)
    for i, dev_row in enumerate(mesh.devices):
        for j, dev in enumerate(dev_row):
            mine = [claimed[dev, s] for s in ids[i]]
            for shards, (plane, claims, _) in zip(rows[i], mine):
                sh = shards[j]
                w = sh.ring_cols
                sh.distance.copy_(plane[:, j * w:(j + 1) * w])
                apply_claims(sh, claims, j * w)
            for n in CARRIED:
                setattr(state.shards[i][j], n, torch.stack([c.scalars[n] for _, c, _ in mine]))
    return _step_sharded(config, state, lambda dev, s: (None, claimed[dev, s][2]), batch_cols,
                         slab_cols, slab_head)
