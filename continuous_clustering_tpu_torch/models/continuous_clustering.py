"""The streaming facade (port of
``continuous_clustering_tpu/models/continuous_clustering.py``).

Public API as the JAX facade and the reference class: ``reset(num_rows)``,
``set_configuration``, ``set_transform_robot_frame_from_sensor_frame``,
``add_firing``, ``flush``, the finished-column and finished-cluster
callbacks and ``get_columns``.  ``device`` defaults to ``cuda``; a CPU run is
asked for with ``device="cpu"``.

Two insertion paths, chosen by the ``insertion`` argument:

* ``"host"`` (default): per firing batch the native C++ engine inserts the
  firings on the host; each finished column block goes to the device as ONE
  merged i32 buffer (one host-to-device copy; below 15 rows two: fields and
  scalars, then the (B, 15) pose rows) and runs ``pipeline_step_block``.
  The native library is required: when it cannot be built, ``reset``
  raises.
* ``"device"``: the firing batch goes to the device and ``pipeline_step``
  inserts it there.  A step that finished more columns than it holds
  defers the surplus; empty batches drain it.

Either way the host reads the packed meta vector with ONE device-to-host
copy per step (one step late in async mode, ``is_single_threaded=False``),
and cluster emission reads the publish slab that rode the step's outputs.

Each layer records a span into the program's registry (``utils/stats.TRACE``):
``facade.batch`` around one firing batch, inside it ``facade.host_insertion``,
``facade.stage``, ``facade.upload``, the step's own spans (``models/step.py``),
``facade.meta_wait``, ``facade.emit`` (its ``facade.callbacks``) and
``facade.rebase``; every device-to-host read goes through ``to_host`` and
every upload through ``to_device``, which count them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..io.point_cloud import ProcessingStage, combine_u64, stage_dtype

from ..io import native_readout
from ..ops.ingest import (MERGED_MIN_ROWS, N_BLOCK_FIELDS, N_BLOCK_SCALARS, N_MERGED_PLANES,
                          N_SPLIT_PLANES, split_fields, split_merged, unpack_block)
from ..ops.insertion import FiringBatch, make_firing_batch
from ..ops.readout import join_tables, packed_readout, unpack_slab
from ..ops.state import RingState, init_state, rebase_azimuth
from ..utils.stats import TRACE, StageTimer, WorkloadRecorder, to_device, to_host
from .host_insertion import HostInsertion
from .step import (META_CC_FAILED, META_CC_ROUNDS, META_COUNTER_OLD, META_FU_NEW,
                   META_FU_OLD, META_GCOL0, META_NCOLS, META_NUM_NEW, META_OVERFLOW,
                   META_RESET, N_META, EgoCalibration, SegPoses, StepInfo, pipeline_step,
                   pipeline_step_block)

TWO_PI = 2.0 * math.pi
INSERTION_PATHS = ("host", "device")


class ContinuousClustering:
    """Streaming continuous clustering on a torch device."""

    def __init__(self, config: Config = Config(), firing_batch_size: int = 256,
                 rebase_after_rotations: int = 256, device=None,
                 insertion: str = "host"):
        if insertion not in INSERTION_PATHS:
            raise ValueError(f"insertion must be one of {INSERTION_PATHS}, got {insertion!r}")
        self._config = config
        # the card unless the caller names another device; no fallback
        self._device = torch.device("cuda" if device is None else device)
        self._insertion = insertion
        self._batch_F = firing_batch_size
        self._rebase_after = rebase_after_rotations
        self._num_rows: Optional[int] = None
        self._state: Optional[RingState] = None
        self._ego_from_sensor: Optional[np.ndarray] = None
        self._hsg_dev: Optional[torch.Tensor] = None
        self._calib: Optional[EgoCalibration] = None
        self._reset_required = False
        self.finished_column_callback: Optional[Callable[[int, int, bool], None]] = None
        self.finished_cluster_callback: Optional[Callable[[np.ndarray, int], None]] = None
        self._fifo: List[Dict[str, np.ndarray]] = []
        self._fifo_poses: List[np.ndarray] = []
        # observability (reference recordJobQueueWorkload analog)
        self.stats = StageTimer()
        self.workload = WorkloadRecorder()
        # decode-queue depth, fed by the owning node when a sensor decode
        # thread runs (ClusteringNode._on_new_firing)
        self._sensor_depth = 0

    # ------------------------------------------------------------------ API
    def set_configuration(self, config: Config) -> None:
        if self._config.reset_required_vs(config):
            self._reset_required = True
        self._config = config
        self._hsg_dev = None
        self._calib = None
        if self._num_rows is not None:
            self._setup_widths()

    def reset_required(self) -> bool:
        return self._reset_required

    def set_transform_robot_frame_from_sensor_frame(self, tf: np.ndarray) -> None:
        self._ego_from_sensor = np.asarray(tf, dtype=np.float64)
        self._hsg_dev = None
        self._calib = None

    def has_transform_robot_frame_from_sensor_frame(self) -> bool:
        return self._ego_from_sensor is not None

    def set_finished_column_callback(self, cb) -> None:
        self.finished_column_callback = cb

    def set_finished_cluster_callback(self, cb) -> None:
        self.finished_cluster_callback = cb

    def reset(self, num_rows: int) -> None:
        host = self._insertion == "host"
        self._num_rows = num_rows
        self._state = init_state(self._config, num_rows, self._device)
        self._reset_required = False
        self._fifo.clear()
        self._fifo_poses.clear()
        self._host_ins = HostInsertion(self._config, num_rows) if host else None
        # host mirrors of device scalars (no syncs on the hot path)
        self._h_first_unfinished = -1
        self._h_first_unpublished = -1
        self._h_cluster_counter = 1
        self._h_origin_rot = 0
        self._pending_infos: List[StepInfo] = []
        # device insertion: the last firing's pose (empty drain batches carry
        # it) and the column count of the last consumed step
        self._last_pose = np.eye(4)
        self._last_ncols = 0
        # publish-slab cache: (lo, hi, head, tail, join tables) of the last
        # consumed step; its host copy is made on first touch
        self._slab = None
        self._slab_np = None
        # (lo, hi, records) of the last native full-window assembly
        self._cloud_cache = None
        self.last_cc_rounds = 0
        self.n_steps = 0
        self._staging = None
        self._setup_widths()

    def _setup_widths(self) -> None:
        cfg = self._config
        # column capacity per step: firings per batch + slack for uneven
        # column completion
        self._batch_B = self._batch_F + 32
        nth = cfg.clustering.cluster_point_trees_every_nth_column
        win = (cfg.range_image.num_columns + self._batch_B
               + 2 * cfg.clustering.max_steps_in_row + (2 * nth if nth > 1 else 0))
        if win > cfg.ring_buffer_max_columns:
            raise ValueError(
                f"ring buffer too small: {cfg.ring_buffer_max_columns} columns "
                f"< worst-case live window {win} (num_columns + "
                f"firing_batch_size + 32 + 2*max_steps_in_row + 2*nth). "
                f"Increase ring_buffer_revolutions, or reduce the firing "
                f"batch size or cluster_point_trees_every_nth_column.")
        rc = cfg.ring_buffer_max_columns
        # publish slab riding every step: the whole window W, split into a
        # static head the host copies when it reads the slab and a tail it
        # copies only for a window wider than the head
        self._slab_W = min(1 << (2 * self._batch_B - 1).bit_length(), rc)
        self._slab_W1 = self._slab_W // 2

    def add_firing(self, firing: Dict[str, np.ndarray], odom_from_sensor: np.ndarray) -> None:
        if self._num_rows is None:
            raise RuntimeError("reset(num_rows) must be called before add_firing")
        if firing["xyz"].shape[0] != self._num_rows:
            raise RuntimeError(
                "The number of points in a firing has changed. This is probably a bug!")
        self._fifo.append(firing)
        self._fifo_poses.append(np.asarray(odom_from_sensor, dtype=np.float64))
        if len(self._fifo) >= self._batch_F:
            with TRACE.span("facade.batch"):
                self._process_batch()

    def flush(self) -> None:
        """Process buffered firings, drain deferred results, then run the
        finalization kicks (empty steps release clusters held one round)."""
        if self._fifo:
            with TRACE.span("facade.batch"):
                self._process_batch()
        self._drain_pending()
        if self._host_ins is None:
            # stream end: drain surplus finished columns beyond step capacity
            # (the host-insertion path drains inline)
            while self._last_ncols == self._batch_B and not self._reset_required:
                self._last_ncols = 0
                self._run_step(self._empty_batch(), self._make_calib())
                self._drain_pending()
        if self._h_first_unfinished >= 0 and not self._reset_required:
            for _ in range(3):
                fu_before = self._h_first_unpublished
                if self._host_ins is not None:
                    fu = self._h_first_unfinished
                    with TRACE.span("facade.stage"):
                        staged, _ = self._stage_block(fu, fu, False)
                    self._consume_info(self._run_block(staged))
                else:
                    self._run_step(self._empty_batch(), self._make_calib())
                self._drain_pending()
                if self._h_first_unpublished == fu_before:
                    break

    # ---------------------------------------------------------------- internals
    def _stage_block(self, first: int, end: int, reset: bool):
        """The staging buffers for columns [first, first + B).  Returns
        ((buffer, seg poses), n_cols).  With R >= 15 rows the buffer is the
        merged one (field planes, seg-pose plane, scalar plane) and the seg
        poses are None; below, the buffer holds the field planes and the
        scalar plane and the seg poses are a (B, 15) f32 array of their own.
        One host buffer suffices: the upload copies it before returning."""
        B, R = self._batch_B, self._num_rows
        merged = R >= MERGED_MIN_ROWS
        shape = (N_MERGED_PLANES if merged else N_SPLIT_PLANES, B, R)
        if self._staging is None or self._staging.shape != shape:
            self._staging = np.zeros(shape, np.int32)
        buf = self._staging
        _, scalars, trig = self._host_ins.fetch_block_packed(
            first, end, B, self._h_origin_rot, reset, out=buf)
        segp = self._seg_poses_packed(trig)
        if merged:
            buf[N_BLOCK_FIELDS, :, :15].view(np.float32)[...] = segp
            buf[N_BLOCK_FIELDS + 1, 0, :N_BLOCK_SCALARS] = scalars
            segp = None
        else:
            buf[N_BLOCK_FIELDS].reshape(-1)[:N_BLOCK_SCALARS] = scalars
        return (buf, segp), int(scalars[1])

    def _seg_poses_packed(self, trig_poses: np.ndarray) -> np.ndarray:
        """(B, 15) f32 rows [sensor_pos | ego_rot (9) | ego_trans]."""
        B = self._batch_B
        ego = self._ego_from_sensor
        n = len(trig_poses)
        out = np.zeros((B, 15), np.float32)
        if n:
            rot = trig_poses[:, :3, :3]
            t = trig_poses[:, :3, 3]
            out[:n, 0:3] = t
            rinv = np.swapaxes(rot, 1, 2)
            tinv = -np.einsum("bij,bj->bi", rinv, t)
            out[:n, 3:12] = np.einsum("ij,bjk->bik", ego[:3, :3], rinv).reshape(n, 9)
            out[:n, 12:15] = np.einsum("ij,bj->bi", ego[:3, :3], tinv) + ego[:3, 3]
        return out

    def _make_batch(self, firings, poses) -> FiringBatch:
        """The firing batch on the device, padded to the batch size."""
        with TRACE.span("facade.upload"):
            return make_firing_batch(firings, poses, self._batch_F, self._num_rows,
                                     self._device)

    def _empty_batch(self) -> FiringBatch:
        """A batch of no firings; it carries the last firing's pose, so that
        the columns it drains get their real trigger pose."""
        with TRACE.span("facade.upload"):
            empty = make_firing_batch([], [], self._batch_F, self._num_rows, self._device)
            pose = to_device(self._last_pose[:3, :], self._device, torch.float32)
            return empty._replace(pose=pose.expand_as(empty.pose).contiguous())

    def _make_calib(self) -> EgoCalibration:
        if self._ego_from_sensor is None:
            raise RuntimeError("Transform robot frame from sensor frame was not set yet!")
        if self._calib is None:
            ego = self._ego_from_sensor
            self._calib = EgoCalibration(
                ego_from_sensor=to_device(ego[:3, :], self._device, torch.float32),
                height_sensor_to_ground=self._hsg())
        return self._calib

    def _run_step(self, batch: FiringBatch, calib: EgoCalibration) -> int:
        """Run one device-insertion step.  In async mode the step's meta is
        consumed one step later, so the host handles step k's callbacks while
        the device runs step k + 1.  Returns n_cols of the step whose meta
        was consumed (0 if it was deferred)."""
        self.n_steps += 1
        TRACE.step(self.n_steps)
        self._state, info = pipeline_step(
            self._config, self._state, batch, calib, self._batch_B,
            slab_cols=self._slab_W, slab_head=self._slab_W1)
        if self._config.general.is_single_threaded:
            return self._consume_info(info)
        self._pending_infos.append(info)
        if len(self._pending_infos) > 1:
            return self._consume_info(self._pending_infos.pop(0))
        return 0

    def _hsg(self) -> torch.Tensor:
        """Device scalar: sensor height over ground."""
        if self._hsg_dev is None:
            self._hsg_dev = to_device(
                np.float32(-self._ego_from_sensor[2, 3]
                           + self._config.ground_segmentation.height_ref_to_ground),
                self._device)
        return self._hsg_dev

    def _upload_block(self, staged):
        """``_stage_block``'s buffers on the device as the step's
        (ColumnBlock, SegPoses): one host-to-device copy, or two below 15
        rows."""
        B = self._batch_B
        buf, segp = staged
        dev_buf = to_device(buf, self._device)
        if segp is None:
            fields, scalars, segp = split_merged(dev_buf)
        else:
            fields, scalars = split_fields(dev_buf)
            segp = to_device(segp, self._device)
        seg = SegPoses(sensor_pos=segp[:, 0:3], ego_rot=segp[:, 3:12].reshape(B, 3, 3),
                       ego_trans=segp[:, 12:15])
        return unpack_block(fields, scalars), seg

    def _run_block(self, staged) -> StepInfo:
        """Upload one block's staging buffers and run the step on it."""
        self.n_steps += 1
        TRACE.step(self.n_steps)
        with TRACE.span("facade.upload"):
            block, seg = self._upload_block(staged)
        self._state, info = pipeline_step_block(
            self._config, self._state, block, seg, self._hsg(), self._batch_B,
            slab_cols=self._slab_W, slab_head=self._slab_W1)
        return info

    def _process_batch(self) -> None:
        firings, poses = self._fifo, self._fifo_poses
        self._fifo, self._fifo_poses = [], []
        calib = self._make_calib()
        # queue-depth sampling across the four stages (reference
        # recordJobQueueWorkload, …cpp:1147-1159): sensor = packets awaiting
        # decode (set by the node when a decode thread runs), fifo = buffered
        # firings, device = dispatched-but-unconsumed steps, publish =
        # finished-but-unpublished column backlog
        self.workload.record(
            sensor=self._sensor_depth,
            fifo=len(firings),
            device=len(self._pending_infos),
            publish=max(0, self._h_first_unfinished - self._h_first_unpublished),
        )
        # "device_step" times the enqueue of the batch's steps (and, in
        # async mode, the meta read and emission of the step before each),
        # not the device's work: no synchronisation is added for it.  The
        # registry's spans inside it (facade.*, step.*) split it.
        if self._host_ins is not None:
            with self.stats.track("device_step"):
                self._process_batch_host(firings, poses)
            return
        self._last_pose = poses[-1]
        with self.stats.track("host_batch_prep"):
            batch = self._make_batch(firings, poses)
        with self.stats.track("device_step"):
            n_cols = self._run_step(batch, calib)
        # a step that clamped at its column capacity may leave finished
        # columns behind; empty batches re-advance the frontier from the
        # persistent prev_rearmost and drain them
        while n_cols == self._batch_B and not self._reset_required:
            n_cols = self._run_step(self._empty_batch(), calib)
        self._maybe_rebase()

    def _process_batch_host(self, firings, poses) -> None:
        ins = self._host_ins
        with TRACE.span("facade.host_insertion"):
            first, end, reset = ins.add_firings(firings, poses)
        if reset:
            self._reset_required = True
            return
        while True:
            with TRACE.span("facade.stage"):
                staged, n = self._stage_block(first, end, reset)
            info = self._run_block(staged)
            if self._config.general.is_single_threaded:
                self._consume_info(info)
            else:
                self._pending_infos.append(info)
                if len(self._pending_infos) > 1:
                    self._consume_info(self._pending_infos.pop(0))
            first += n
            if first >= end or n == 0:
                break
        with TRACE.span("facade.host_insertion"):
            ins.clear_before(self._h_first_unpublished - self._config.range_image.num_columns)
        self._maybe_rebase()

    def _drain_pending(self) -> None:
        while self._pending_infos:
            self._consume_info(self._pending_infos.pop(0))

    def _consume_info(self, info: StepInfo) -> int:
        """Read the step's meta (its one device-to-host copy), raise on its
        error flags, run the callbacks; returns the step's n_cols."""
        with TRACE.span("facade.meta_wait"):
            m = to_host(info.meta).numpy()
        TRACE.resolve()
        if m[META_RESET]:
            self._reset_required = True
            return 0
        if m[META_CC_FAILED]:
            raise RuntimeError(
                "Connected-components labeling did not converge within the "
                "64-round cap (labels still changing). This is a correctness "
                "failure, not a throughput one: slowing the input stream "
                "cannot help.")
        if m[META_OVERFLOW]:
            raise RuntimeError(
                "Ring buffer overflow: a column was not cleared before reuse. "
                "The clustering cannot keep up with the input rate; slow down "
                "the stream or adjust parameters (reference throws the same "
                "way, src/clustering/continuous_clustering.cpp:337-344).")
        n_cols = int(m[META_NCOLS])
        self._last_ncols = n_cols
        self.last_cc_rounds = int(m[META_CC_ROUNDS])
        TRACE.count("step.cc_rounds", self.last_cc_rounds)
        gcol0 = int(m[META_GCOL0])
        fu_old, fu_new = int(m[META_FU_OLD]), int(m[META_FU_NEW])
        if n_cols == 0 and fu_new == fu_old:
            return 0
        if n_cols > 0:
            self._h_first_unfinished = gcol0 + n_cols
        counter_old = int(m[META_COUNTER_OLD])
        num_new = int(m[META_NUM_NEW])
        self._h_cluster_counter = counter_old + num_new
        self._h_first_unpublished = fu_new

        if fu_old >= 0:
            hi = max(gcol0 + n_cols if n_cols > 0 else fu_new, fu_new)
            tabs = m[N_META:].reshape(2, -1)
            self._slab = (fu_old, min(fu_old + self._slab_W, hi), info.slab,
                          info.slab_ext, tabs)
            self._slab_np = None
            self._cloud_cache = None

        if n_cols > 0 and self.finished_column_callback:
            self.finished_column_callback(gcol0, gcol0 + n_cols - 1, True)
        if num_new > 0 and self.finished_cluster_callback:
            with TRACE.span("facade.emit"):
                self._emit_clusters(fu_old, max(gcol0 + n_cols, fu_new),
                                    counter_old, counter_old + num_new)
        if fu_new > fu_old and self.finished_column_callback:
            self.finished_column_callback(fu_old, fu_new - 1, False)
        return n_cols

    def _emit_clusters(self, from_gcol: int, to_gcol: int, counter_old: int,
                       counter_new: int) -> None:
        slab, off, tabs = self._fetch_slab(from_gcol, to_gcol - from_gcol)
        groups, full = native_readout.emit_clusters(
            slab, tabs, off, to_gcol - from_gcol, from_gcol, self._state.ring_cols,
            TWO_PI * self._h_origin_rot, counter_old, counter_new,
            self._config.clustering.use_last_point_for_cluster_stamp)
        if full is not None:
            self._cloud_cache = (from_gcol, to_gcol, full)
        with TRACE.span("facade.callbacks"):
            for group, stamp in groups:
                self.finished_cluster_callback(group, stamp)

    def _maybe_rebase(self) -> None:
        rot = self._h_first_unpublished // self._config.range_image.num_columns
        if rot - self._h_origin_rot > self._rebase_after:
            with TRACE.span("facade.rebase"):
                # cached and in-flight slabs hold azimuths relative to the
                # old origin: consume everything first, then drop the caches
                self._drain_pending()
                self._slab = None
                self._slab_np = None
                self._cloud_cache = None
                rot = self._h_first_unpublished // self._config.range_image.num_columns
                delta = rot - self._h_origin_rot
                self._state, _ = rebase_azimuth(self._state, delta)
                self._h_origin_rot += delta

    # ---------------------------------------------------------------- access
    def _fetch_slab(self, from_gcol: int, n: int):
        """(slab numpy (rows, R, W), column offset, join tables) covering
        [from_gcol, from_gcol + n): from the last step's publish slab when it
        covers the range (its head, or head + tail, copied once), else one
        on-demand packed readout of the current state."""
        if self._slab is not None:
            lo, hi, head, tail, tabs = self._slab
            if from_gcol >= lo and from_gcol + n <= hi:
                need = from_gcol - lo + n
                if self._slab_np is None or self._slab_np.shape[2] < need:
                    both = head if need <= head.shape[2] else torch.cat([head, tail], dim=2)
                    self._slab_np = to_host(both).numpy()
                return self._slab_np, from_gcol - lo, tabs
        rc = self._state.ring_cols
        bucket = min(max(8, 1 << max(0, n - 1).bit_length()), rc)
        if bucket < n:
            raise ValueError(f"column range of {n} exceeds the ring's {rc} columns")
        slab = to_host(packed_readout(self._state, from_gcol % rc, bucket,
                                      self._config.clustering.record_neighbor_stats)).numpy()
        return slab, 0, to_host(join_tables(self._state)).numpy()

    @property
    def state(self) -> RingState:
        return self._state

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def first_unpublished_global_column_index(self) -> int:
        return self._h_first_unpublished

    def get_columns(self, from_gcol: int, to_gcol: int,
                    stage: ProcessingStage = ProcessingStage.CONTINUOUS_CLUSTERING) -> np.ndarray:
        """Columns [from_gcol, to_gcol] as a structured point cloud, flattened
        column-major (reference columnToPointCloud)."""
        rc = self._state.ring_cols
        R = self._num_rows
        n = to_gcol + 1 - from_gcol
        if stage == ProcessingStage.CONTINUOUS_CLUSTERING:
            cc = self._cloud_cache
            if cc is not None and cc[0] <= from_gcol and to_gcol < cc[1]:
                return cc[2][(from_gcol - cc[0]) * R:(to_gcol + 1 - cc[0]) * R]
            slab, off, tabs = self._fetch_slab(from_gcol, n)
            cloud = native_readout.assemble_cloud(slab, tabs, off, n, from_gcol, rc,
                                                  TWO_PI * self._h_origin_rot)
            self._cloud_cache = (from_gcol, to_gcol + 1, cloud)
            return cloud

        slab, off, tabs = self._fetch_slab(from_gcol, n)
        f = unpack_slab(slab, off, n, from_gcol, tabs)
        lcols = np.arange(from_gcol, to_gcol + 1) % rc
        out = np.zeros(R * n, dtype=stage_dtype(stage))
        origin_az = TWO_PI * self._h_origin_rot

        def put(name, vals):
            if name in out.dtype.names:
                out[name] = np.asarray(vals).T.reshape(-1)

        put("x", f["x"])
        put("y", f["y"])
        put("z", f["z"])
        put("firing_index", f["firing_index"])
        put("intensity", np.clip(f["intensity"], 0, 255).astype(np.uint8))
        put("globally_unique_point_index", combine_u64(f["uidx_hi"], f["uidx_lo"]))
        stamps = combine_u64(f["stamp_hi"], f["stamp_lo"])
        put("time_sec", (stamps // np.uint64(1_000_000_000)).astype(np.uint32))
        put("time_nsec", (stamps % np.uint64(1_000_000_000)).astype(np.uint32))
        put("distance", f["distance"])
        put("azimuth_angle", f["azimuth"])
        put("inclination_angle", f["inclination"])
        put("continuous_azimuth_angle", f["cont_az"].astype(np.float64) + origin_az)
        put("global_column_index", f["gcol"].astype(np.int64))
        put("local_column_index", np.broadcast_to(lcols[None, :], (R, n)).astype(np.uint16))
        put("row_index", np.broadcast_to(np.arange(R)[:, None], (R, n)).astype(np.uint16))
        put("ground_point_label", f["ground_label"].astype(np.uint8))
        put("debug_ground_point_label", f["debug_label"].astype(np.uint8))
        put("height_over_ground", np.full((R, n), np.nan, np.float32))
        put("ignore_for_clustering", f["is_ignored"].astype(np.uint8))
        put("finished_at_continuous_azimuth_angle",
            f["finish_az"].astype(np.float64) + origin_az)
        # profiling counters (written when clustering.record_neighbor_stats;
        # reference …cpp:725 / ros_utils.cpp:291-295): the CC formulation has
        # no tree children, so the edges found stand in for them
        put("number_of_visited_neighbors", (f["nbr_stats"] & 0xFFFF).astype(np.uint32))
        put("num_child_points", (f["nbr_stats"] >> 16).astype(np.uint16))
        put("id", f["cell_cid"].astype(np.uint64))
        rep = np.maximum(f["cell_rep"], 0)
        put("tree_id", rep.astype(np.uint64))
        put("tree_root_row_index", (rep // rc).astype(np.uint16))
        put("tree_root_column_index", (rep % rc).astype(np.int64))
        return out
