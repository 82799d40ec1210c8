"""Multi-step runners for bulk processing and throughput measurement (port
of ``continuous_clustering_tpu/models/throughput.py``).

Each runner is a plain loop over pipeline steps with the state resident on
the device; callbacks are not available, results are read from the state or
from the returned per-step outputs (as the reference's ``--evaluate-fast``
skips its publishers, src/tools/kitti_demo.cpp:474-482).  Each returns
``(state, stacked StepInfo)`` or, with ``reduce_infos``, ``(state, one i32
checksum per step)``.  The state is updated in place.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..config import Config
from ..ops.ingest import ColumnBlock
from ..ops.insertion import FiringBatch
from ..ops.state import RingState, rebase_azimuth
from .step import EgoCalibration, SegPoses, StepInfo, pipeline_step, pipeline_step_block

# one revolution is exactly 2 pi of continuous azimuth; the f32 literal makes
# the periodic runner's k * 2 pi offset match the host engine's unwrap step
_TWO_PI = np.float32(6.2831853071795864769)


def stack_batches(batches: Sequence[NamedTuple]):
    """Stack a sequence of ``FiringBatch`` (or any NamedTuple of tensors)
    along a new leading axis."""
    first = batches[0]
    return type(first)(*[torch.stack(xs) for xs in zip(*batches)])


def _pick(stacked: NamedTuple, j: int):
    return type(stacked)(*[t[j] for t in stacked])


def _stack_infos(infos: List[StepInfo]) -> StepInfo:
    return StepInfo(*[torch.stack(xs) for xs in zip(*infos)])


def step_checksum(info: StepInfo) -> torch.Tensor:
    """Sum of the meta vector and both slab pieces as an i32 that wraps, as
    the JAX runner's ``jnp.sum`` of i32 does; consuming it keeps every output
    of the step in the measured work."""
    total = info.meta.sum(dtype=torch.int64) + info.slab.sum(dtype=torch.int64) \
        + info.slab_ext.sum(dtype=torch.int64)
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


def make_scan_runner(config: Config, batch_cols: int):
    """Returns ``run(state, stacked_batches, calib) -> (state, stacked
    infos)``: ``pipeline_step`` over each firing batch of the stack."""

    def run(state: RingState, batches: FiringBatch, calib: EgoCalibration):
        infos = []
        for j in range(batches.xyz.shape[0]):
            state, info = pipeline_step(config, state, _pick(batches, j), calib, batch_cols)
            infos.append(info)
        return state, _stack_infos(infos)

    return run


def make_block_scan_runner(config: Config, batch_cols: int, slab_cols: int = 0,
                           slab_head: int = 0, reduce_infos: bool = False):
    """Returns ``run(state, blocks, seg_poses, hsg) -> (state, out)``:
    ``pipeline_step_block`` over each host-inserted column block of the
    stack.  ``slab_cols``/``slab_head`` include the publish-slab readout the
    streaming path pays every step; ``reduce_infos`` returns one checksum
    per step instead of the stacked infos."""

    def run(state: RingState, blocks: ColumnBlock, seg_poses: SegPoses, hsg):
        outs = []
        for j in range(blocks.gcol0.shape[0]):
            state, info = pipeline_step_block(
                config, state, _pick(blocks, j), _pick(seg_poses, j), hsg, batch_cols,
                slab_cols=slab_cols, slab_head=slab_head)
            outs.append(step_checksum(info) if reduce_infos else info)
        return state, (torch.stack(outs) if reduce_infos else _stack_infos(outs))

    return run


def make_periodic_block_scan_runner(config: Config, batch_cols: int, num_cols: int,
                                    n_steps: int, slab_cols: int = 0, slab_head: int = 0,
                                    reduce_infos: bool = True, rebase_every: int = 64):
    """Benchmark runner: ``n_steps`` pipeline steps over a PERIODIC
    one-revolution block stack resident on the device.

    The throughput scenes feed the same firings every revolution, so
    revolution 0's host-inserted blocks replayed with per-revolution offsets
    (global columns and the frontier scalars derived from them advanced by
    ``k * num_cols``, continuous azimuth by ``k * 2 pi``) form a valid,
    self-consistent stream with the scene's geometry every revolution.  The
    first-unpublished frontier initialiser is armed in revolution 0 only.

    Azimuth rebase: production keeps f32 azimuths small by shifting the
    origin every few hundred rotations (``ops.state.rebase_azimuth``); the
    runner applies the same shift every ``rebase_every`` revolutions, so a
    soak of any length stays inside f32 precision, and the replayed block's
    azimuth offset is then ``(rev - rebases applied) * 2 pi``.  The schedule
    is deterministic in the global step index, so it is kept on the host:
    after step ``k`` of revolution ``rev`` the origin has moved
    ``rebase_every * (rev // rebase_every)`` rotations since the capture,
    and a call that continues a stream (``k0 > 0``, the same
    ``rebase_every``) starts from the shift as of step ``k0 - 1``.  (The JAX
    runner starts from the shift as of step ``k0``, which skips the rebase
    of a call that starts exactly on a rebase revolution.)
    ``rebase_every=0`` disables it.

    Returns ``run(state, blocks0, seg_poses0, hsg, k0) -> (state, out)``
    where ``blocks0``/``seg_poses0`` hold one revolution (leading axis
    ``per_rev``) and ``k0`` is the global step index the call starts at;
    ``out`` is one checksum per step (``reduce_infos``) or the stacked
    infos."""

    def run(state: RingState, blocks0: ColumnBlock, seg_poses0: SegPoses, hsg, k0: int):
        per_rev = blocks0.gcol0.shape[0]
        k0 = int(k0)
        applied = 0
        if rebase_every and k0 > 0:  # the shift the earlier calls applied
            applied = rebase_every * (((k0 - 1) // per_rev) // rebase_every)
        outs = []
        for i in range(n_steps):
            k = k0 + i
            rev, j = divmod(k, per_rev)
            if rebase_every:
                needed = rebase_every * (rev // rebase_every)
                if applied < needed:
                    state, _ = rebase_azimuth(state, rebase_every)
                    applied += rebase_every
                az_rev = rev - needed
            else:
                az_rev = rev
            b, sp = _pick(blocks0, j), _pick(seg_poses0, j)
            off = rev * num_cols

            def shift(v):  # column-index scalars shift by off; -1 sentinels stay
                return torch.where(v >= 0, v + off, v)

            b = b._replace(
                gcol0=b.gcol0 + off,
                cont_az=b.cont_az + float(np.float32(az_rev) * _TWO_PI),
                prev_rearmost=shift(b.prev_rearmost),
                prev_foremost=shift(b.prev_foremost),
                first_unfinished=shift(b.first_unfinished),
                first_unpublished_init=b.first_unpublished_init if rev == 0
                else torch.full_like(b.first_unpublished_init, -1),
            )
            state, info = pipeline_step_block(config, state, b, sp, hsg, batch_cols,
                                              slab_cols=slab_cols, slab_head=slab_head)
            outs.append(step_checksum(info) if reduce_infos else info)
        return state, (torch.stack(outs) if reduce_infos else _stack_infos(outs))

    return run
