"""The streaming device step (port of ``continuous_clustering_tpu/models/step.py``).

Two variants:

* ``pipeline_step_block`` (host insertion): ingest a dense finished-column
  block -> ground segmentation -> association and completion;
* ``pipeline_step`` (device insertion): insert a firing batch, clamp the
  finished columns to the step's capacity, derive each column's trigger pose
  and the ego transform on the device, then the same stages.

Both end with the publish slab, join tables and the packed meta vector: the
step's scalars ride ONE i32 vector (``StepInfo.meta``) so that the host
reads them with a single device-to-host copy.

Each part records a span into the program's registry (``utils/stats.TRACE``):
``step.insertion``, ``step.frontier``, ``step.ingest``,
``step.ground_segmentation``, ``step.association`` (with
``step.association.cc`` around the kernels) and ``step.finish``.

``pipeline_step`` is ``insert_and_segment``, ``associate_and_complete`` and
``finish_step`` in order, ``pipeline_step_block`` the same with
``ingest_and_segment`` first; the multi-sensor step
(``parallel/multi_sensor.py``) and the column-sharded halo step
(``parallel/halo.py``) run the same parts per stream and launch the
association kernels once for all their streams between them.  The
column-sharded device-insertion step runs the insertion's two halves
(``ops/insertion.py``) itself and then ``frontier_and_poses``, the part of
``insert_and_segment`` between insertion and segmentation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config

from ..ops.association import CompleteResult, associate_and_complete
from ..ops.ground_segmentation import SegmentInputs, ground_segment_columns
from ..ops.ingest import ColumnBlock, ingest_columns
from ..ops.insertion import I32_MIN, FiringBatch, fma32, insert_firings
from ..ops.readout import join_tables, packed_readout, slab_rows
from ..ops.state import I32_MAX, RingState
from ..utils.stats import TRACE

# meta vector lanes
(META_GCOL0, META_NCOLS, META_FU_OLD, META_FU_NEW, META_NUM_NEW,
 META_COUNTER_OLD, META_RESET, META_OVERFLOW, META_CC_FAILED,
 META_CC_ROUNDS) = range(10)
N_META = 10


class StepInfo(NamedTuple):
    meta: torch.Tensor      # (N_META [+ 2K],) i32; join tables ride behind the lanes
    slab: torch.Tensor      # head: publish-window columns [fu_old, fu_old + head)
    slab_ext: torch.Tensor  # tail: columns [fu_old + head, fu_old + W)

    @property
    def gcol0(self):
        return self.meta[..., META_GCOL0]

    @property
    def n_cols(self):
        return self.meta[..., META_NCOLS]

    @property
    def fu_old(self):
        return self.meta[..., META_FU_OLD]

    @property
    def fu_new(self):
        return self.meta[..., META_FU_NEW]

    @property
    def num_new_clusters(self):
        return self.meta[..., META_NUM_NEW]

    @property
    def cluster_counter_old(self):
        return self.meta[..., META_COUNTER_OLD]

    @property
    def reset_required(self):
        return self.meta[..., META_RESET]

    @property
    def overflow(self):
        return self.meta[..., META_OVERFLOW]

    @property
    def cc_failed(self):
        return self.meta[..., META_CC_FAILED]

    @property
    def cc_rounds(self):
        return self.meta[..., META_CC_ROUNDS]


class EgoCalibration(NamedTuple):
    """Static-per-stream ego calibration, device-resident."""

    ego_from_sensor: torch.Tensor          # (3, 4) f32
    height_sensor_to_ground: torch.Tensor  # () f32


class SegPoses(NamedTuple):
    """Per-column trigger poses for segmentation (host-derived)."""

    sensor_pos: torch.Tensor  # (B, 3) f32
    ego_rot: torch.Tensor     # (B, 3, 3) f32
    ego_trans: torch.Tensor   # (B, 3) f32


def pack_meta(gcol0, n_cols, fu_old, fu_new, num_new, counter_old,
              reset_required, overflow, cc_failed, cc_rounds,
              join_tabs=None) -> torch.Tensor:
    vals = [gcol0, n_cols, fu_old, fu_new, num_new, counter_old,
            reset_required, overflow, cc_failed, cc_rounds]
    head = torch.stack([torch.as_tensor(v).reshape(()).to(torch.int32) for v in vals])
    if join_tabs is None:
        return head
    return torch.cat([head, join_tabs.reshape(-1)])


def _publish_slab(config: Config, state: RingState, fu_old, slab_cols: int, head_cols: int):
    """Packed readout of [fu_old, fu_old + slab_cols), split at ``head_cols``;
    the ``nbr_stats`` row trails when ``record_neighbor_stats`` is on."""
    R = state.num_rows
    with_nbr = config.clustering.record_neighbor_stats
    empty = torch.zeros((slab_rows(with_nbr), R, 0), dtype=torch.int32, device=state.device)
    if not slab_cols:
        return empty, empty
    full = packed_readout(state, fu_old.clamp_min(0) % state.ring_cols, slab_cols, with_nbr)
    if head_cols <= 0 or head_cols >= slab_cols:
        return full, empty
    return full[:, :, :head_cols], full[:, :, head_cols:]


def pipeline_step_block(config: Config, state: RingState, block: ColumnBlock,
                        seg_poses: SegPoses, hsg: torch.Tensor, batch_cols: int,
                        slab_cols: int = 0, slab_head: int = 0):
    """Ingest a dense finished-column block, then segmentation, association
    and completion.  Updates ``state`` in place; returns (state, StepInfo)."""
    state = ingest_and_segment(config, state, block, seg_poses, hsg, batch_cols)
    counter_old = state.cluster_counter
    with TRACE.span("step.association", state.device):
        cres = associate_and_complete(config, state, block.gcol0, block.n_cols, batch_cols)
    return finish_step(config, cres, block.gcol0, block.n_cols, counter_old, slab_cols,
                       slab_head)


def ingest_and_segment(config: Config, state: RingState, block: ColumnBlock,
                       seg_poses: SegPoses, hsg: torch.Tensor, batch_cols: int) -> RingState:
    """The part of ``pipeline_step_block`` before association: ingest the
    block and segment the ground.  Updates ``state`` in place."""
    with TRACE.span("step.ingest", state.device):
        state = ingest_columns(config, state, block, batch_cols)
    with TRACE.span("step.ground_segmentation", state.device):
        return ground_segment_columns(config, state,
                                      block_segment_inputs(block, seg_poses, hsg), batch_cols)


def block_segment_inputs(block: ColumnBlock, seg_poses: SegPoses,
                         hsg: torch.Tensor) -> SegmentInputs:
    """The segmentation inputs of a host-inserted block's columns."""
    return SegmentInputs(
        gcol0=block.gcol0, n_cols=block.n_cols,
        sensor_pos=seg_poses.sensor_pos, ego_rot=seg_poses.ego_rot,
        ego_trans=seg_poses.ego_trans, height_sensor_to_ground=hsg,
    )


def finish_step(config: Config, cres: CompleteResult, gcol0, n_cols, counter_old,
                slab_cols: int, slab_head: int):
    """The publish slab, join tables and packed meta of a step whose
    association returned ``cres``; returns (state, StepInfo)."""
    state = cres.state
    with TRACE.span("step.finish", state.device):
        slab, slab_ext = _publish_slab(config, state, cres.fu_old, slab_cols, slab_head)
        meta = pack_meta(
            gcol0, n_cols, cres.fu_old, cres.fu_new, cres.num_new_clusters,
            counter_old, state.reset_required, state.overflow, state.cc_failed,
            cres.cc_rounds, join_tabs=join_tables(state) if slab_cols else None,
        )
    return state, StepInfo(meta=meta, slab=slab, slab_ext=slab_ext)


def _mat_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` over a leading batch axis, m (..., 3, 3), v (..., 3), as
    elementwise f32 multiply-adds in the order XLA's CPU build evaluates the
    JAX step's ``precision="highest"`` einsum (no matmul, so no TF32)."""
    return fma32(m[..., 2], v[..., None, 2],
                 fma32(m[..., 1], v[..., None, 1], m[..., 0] * v[..., None, 0]))


def pipeline_step(config: Config, state: RingState, batch: FiringBatch,
                  ego: EgoCalibration, batch_cols: int, slab_cols: int = 0,
                  slab_head: int = 0):
    """Process one firing batch end to end on the device; updates ``state``
    in place and returns (state, StepInfo).

    ``batch_cols`` is the static column capacity of the step, normally
    ``F + slack``.  If more columns finish than fit, the surplus is deferred
    to the next step (the insertion frontier is rolled back accordingly)."""
    state, gcol0, n_cols = insert_and_segment(config, state, batch, ego, batch_cols)
    counter_old = state.cluster_counter
    with TRACE.span("step.association", state.device):
        cres = associate_and_complete(config, state, gcol0, n_cols, batch_cols)
    return finish_step(config, cres, gcol0, n_cols, counter_old, slab_cols, slab_head)


def insert_and_segment(config: Config, state: RingState, batch: FiringBatch,
                       ego: EgoCalibration, batch_cols: int):
    """The part of ``pipeline_step`` before association: insert the firing
    batch, clamp the finished columns to the step's capacity, derive each
    column's trigger pose and the ego transform, and segment the ground.
    Updates ``state`` in place; returns (state, gcol0, n_cols)."""
    fu_before = state.first_unfinished  # -1 before the first data
    dev = state.device
    with TRACE.span("step.insertion", dev):
        res = insert_firings(config, state, batch)
    state = res.state
    with TRACE.span("step.frontier", dev):
        state.first_unfinished, seg_in = frontier_and_poses(
            fu_before, res.rearmost_per_firing, state.first_unfinished, state.reset_required,
            batch.pose, ego, batch_cols)
    with TRACE.span("step.ground_segmentation", dev):
        state = ground_segment_columns(config, state, seg_in, batch_cols)
    return state, seg_in.gcol0, seg_in.n_cols


def frontier_and_poses(fu_before, rearmost, fu_after, reset_required, pose: torch.Tensor,
                       ego: EgoCalibration, batch_cols: int):
    """What ``pipeline_step`` derives from an insertion, touching no ring
    cell: the step's columns [gcol0, gcol0 + n_cols), clamped to
    ``batch_cols``, the insertion frontier rolled back to them (surplus
    columns are deferred to the next step), and each column's trigger pose
    and ego transform.  ``fu_before``/``fu_after`` are ``first_unfinished``
    before and after the insertion, ``rearmost`` its ``prev_rearmost`` after
    each firing, ``pose`` the batch's (F, 3, 4) poses.  Returns
    (first_unfinished, SegmentInputs)."""
    F = pose.shape[0]
    B = batch_cols
    dev = pose.device

    first_valid = torch.where(rearmost >= 0, rearmost, I32_MAX).amin()
    gcol0 = torch.where(fu_before >= 0, fu_before, first_valid).to(torch.int32)
    n_cols = torch.clamp(fu_after - gcol0, 0, B)
    has_work = (fu_after >= 0) & (n_cols > 0) & ~reset_required
    n_cols = torch.where(has_work, n_cols, 0).to(torch.int32)
    # defer surplus columns: roll the insertion frontier back to what is segmented
    first_unfinished = torch.where(has_work, gcol0 + n_cols, fu_after).to(torch.int32)

    # per-column trigger pose: the first firing whose rearmost passes the column
    cols = gcol0 + torch.arange(B, dtype=torch.int32, device=dev)
    rm_key = torch.where(rearmost >= 0, rearmost, I32_MIN).contiguous()
    trig = torch.clamp(torch.searchsorted(rm_key, cols, right=True), 0, F - 1)
    pose_cols = pose[trig]                             # (B, 3, 4)
    sensor_pos = pose_cols[:, :, 3]

    # ego_from_odom = ego_from_sensor @ inverse(odom_from_sensor)
    rinv = pose_cols[:, :, :3].transpose(1, 2)        # (B, 3, 3)
    tinv = -_mat_vec(rinv, sensor_pos)
    er = ego.ego_from_sensor[:, :3]
    etr = ego.ego_from_sensor[:, 3]
    ego_rot = torch.stack([_mat_vec(er, rinv[:, :, k]) for k in range(3)], dim=2)
    ego_trans = _mat_vec(er, tinv) + etr

    return first_unfinished, SegmentInputs(
        gcol0=gcol0, n_cols=n_cols, sensor_pos=sensor_pos, ego_rot=ego_rot,
        ego_trans=ego_trans, height_sensor_to_ground=ego.height_sensor_to_ground,
    )
