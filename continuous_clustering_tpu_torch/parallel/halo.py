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
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch

from ..config import Config
from ..models.step import (META_FU_OLD, SegPoses, StepInfo, _publish_slab, finish_step,
                           ingest_and_segment)
from ..ops.association import complete_association, window_arrays, window_kernels
from ..ops.ingest import ColumnBlock
from ..ops.readout import join_tables
from ..ops.state import CELL_FIELDS, CLEAR_VALUES, RingState
from .mesh import FIELDS, Mesh, ShardedState
from .multi_sensor import _pick, stream_state

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
                    blocks: Sequence[ColumnBlock], segps: Sequence[SegPoses],
                    hsgs: Sequence[torch.Tensor], batch_cols: int,
                    device: torch.device) -> List[HaloResult]:
    """Steps 1-2 and the slot translation of step 3 for ``streams`` (each a
    list of column shards, shard j owning ring columns [j w, (j + 1) w)) on
    ``device``, K1 and K2 launched once for all of them.  Reads the shards,
    writes nothing to them.

    Unlike the JAX function of this name, which is the body of one shard
    inside ``shard_map`` (one local shard in, that shard's new state out),
    this takes whole streams of shards and a device, and leaves the
    write-back to ``make_halo_sharded_step``."""
    H = config.clustering.max_steps_in_row
    B = batch_cols
    WS = H + B + WS_PAD
    pre = []
    for shards, blk, segp, hsg in zip(streams, blocks, segps, hsgs):
        blk = ColumnBlock(*[t.to(device) for t in blk])
        base = shards[0]
        st = _with_cells(base, _gather_window(shards, blk.gcol0 - H, WS, device), device)
        st = ingest_and_segment(config, st, blk, SegPoses(*[t.to(device) for t in segp]),
                                hsg.to(device), B)
        win = window_arrays(config, st, blk.gcol0, blk.n_cols, B)
        pre.append((shards, blk, st, st.cluster_counter, win))
    ccs = window_kernels(config, [p[4] for p in pre])
    out = []
    for (shards, blk, st, counter_old, win), cc in zip(pre, ccs):
        base = shards[0]
        rc = base.ring_cols * len(shards)
        cres = complete_association(config, st, blk.gcol0, blk.n_cols, B, win, cc,
                                    ring_capacity=rc, skip_clear=True)
        st, info = finish_step(config, cres, blk.gcol0, blk.n_cols, counter_old, 0, 0)
        # representatives of slots allocated this step are scratch-ring glids
        # (row * WS + slot); translate them to the real ring's
        win0 = blk.gcol0 - H
        new_alloc = st.slot_live & ~base.slot_live.to(device)
        rep = st.slot_rep
        g_rep = win0 + torch.remainder(torch.remainder(rep, WS) - win0, WS)
        rep_real = (rep // WS) * rc + torch.remainder(g_rep, rc)
        st.slot_rep = torch.where(new_alloc & (rep >= 0), rep_real, rep).to(I32)
        cells = torch.stack([_to_i32(getattr(st, n)) for n in CELL_FIELDS])
        out.append(HaloResult(st, cells, info, base.ring_start.to(device), blk.gcol0,
                              blk.n_cols))
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
    nsp = mesh.shape["sp"]
    WS = config.clustering.max_steps_in_row + batch_cols + WS_PAD
    devices = mesh.distinct_devices()
    out_dev = mesh.devices[0][0]

    def run(state: ShardedState, block: ColumnBlock, segp: SegPoses, hsg: torch.Tensor):
        if state.mesh != mesh or state.stacked != stacked:
            raise ValueError("the state is not placed on this step's mesh "
                             f"(stacked={stacked}); use shard_pytree(mesh, state, stacked)")
        rows = [_stream_shards(state, i) for i in range(len(mesh.devices))]

        def ids(i: int) -> List[int]:
            """Stream ids of dp row ``i`` (a replicated state is one stream)."""
            return [i * len(rows[i]) + k for k in range(len(rows[i]))] if stacked else [0]

        # 1-2: every device steps the streams of each dp row it holds a shard of
        results: Dict[torch.device, Dict[int, HaloResult]] = {}
        for dev in devices:
            jobs: Dict[int, List[RingState]] = {}
            for i, dev_row in enumerate(mesh.devices):
                if dev in dev_row:
                    for s, shards in zip(ids(i), rows[i]):
                        jobs.setdefault(s, shards)
            inputs = [(_pick(block, s), _pick(segp, s), hsg[s]) if stacked
                      else (block, segp, hsg) for s in jobs]
            res = halo_step_local(config, list(jobs.values()), *zip(*inputs), batch_cols, dev)
            results[dev] = dict(zip(jobs, res))
        # 3: every shard takes its device's results
        for i, dev_row in enumerate(mesh.devices):
            for j, dev in enumerate(dev_row):
                mine = [results[dev][s] for s in ids(i)]
                for shards, r in zip(rows[i], mine):
                    _write_back(shards[j], j, nsp, r, WS)
                for n in NON_CELL_FIELDS:
                    t = (torch.stack([getattr(r.state, n) for r in mine]) if stacked
                         else getattr(mine[0].state, n))
                    setattr(state.shards[i][j], n, t.to(dev))
        # 4: the publish slab, from the written-back shards
        infos: Dict[int, StepInfo] = {}
        for i, dev_row in enumerate(mesh.devices):
            dev = dev_row[0]
            for s, shards in zip(ids(i), rows[i]):
                if s in infos:
                    continue
                r = results[dev][s]
                info = r.info
                if slab_cols:
                    fu_old = info.meta[META_FU_OLD]
                    cells = _gather_window(shards, torch.clamp_min(fu_old, 0),
                                           slab_cols + WS_PAD, dev)
                    slab, slab_ext = _publish_slab(config, _with_cells(r.state, cells, dev),
                                                   fu_old, slab_cols, slab_head)
                    info = StepInfo(meta=torch.cat([info.meta, join_tables(r.state).reshape(-1)]),
                                    slab=slab, slab_ext=slab_ext)
                infos[s] = StepInfo(*[t.to(out_dev) for t in info])
        if not stacked:
            return state, infos[0]
        return state, StepInfo(*[torch.stack(xs) for xs in zip(*[infos[s] for s in sorted(infos)])])

    return run

