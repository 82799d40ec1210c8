# FROZEN COPY of ``continuous_clustering_tpu_torch/ops/oracle.py`` at commit cce7c49ab9acd93ca72165a17ff47a74717926ce.
#
# Part of the benchmark's yardstick: later changes to the program do not
# edit this file, so the benchmark measures every commit with the same
# code.  Only imports were changed, so that nothing here imports the
# program or the JAX package.  The original's docstring follows.

"""Exact sequential oracle of the reference continuous-clustering semantics.

This is a deliberately *slow*, plain-Python/NumPy re-derivation of the
reference pipeline (``src/clustering/continuous_clustering.cpp`` of the reference
implementation) used as the golden model for the port's tests and smoke run.  It follows the
reference's single-threaded execution order: every firing runs
insertion -> (per finished column) ground segmentation -> association ->
tree combination -> publishing, synchronously inline
(``utils/thread_pool.hpp:58-67`` sequential mode).

Float behaviour mirrors the C++ reference: ``np.float32`` where the reference
uses ``float``, Python floats (f64) where it uses ``double``.

Reference pointers (file:line in the reference implementation) are cited
inline so parity can be audited without copying any code.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .config import Config
from .constants import (
    DBG_DARKRED,
    DBG_GRAY,
    DBG_GREEN,
    DBG_LIGHTGRAY,
    DBG_ORANGE,
    DBG_RED,
    DBG_VIOLET,
    DBG_WHITE,
    DBG_YELLOW,
    DBG_YELLOWGREEN,
    GP_EGO_VEHICLE,
    GP_FOG,
    GP_GROUND,
    GP_OBSTACLE,
    GP_UNKNOWN,
)

F32 = np.float32
NAN32 = np.float32(np.nan)


@dataclass
class OracleCell:
    """One range-image cell (reference ``struct Point``,
    clustering/continuous_clustering.hpp:126-161)."""

    x: np.float32 = NAN32
    y: np.float32 = NAN32
    z: np.float32 = NAN32
    firing_index: int = 0
    intensity: int = 0
    distance: np.float32 = NAN32
    azimuth_angle: np.float32 = NAN32
    inclination_angle: np.float32 = NAN32
    continuous_azimuth_angle: float = math.nan
    global_column_index: int = -1
    local_column_index: int = -1
    row_index: int = -1
    stamp: int = 0
    globally_unique_point_index: int = -1

    ground_point_label: int = GP_UNKNOWN
    debug_label: int = DBG_WHITE

    is_ignored: bool = False
    number_of_visited_neighbors: int = 0
    finished_at_continuous_azimuth_angle: float = 0.0
    child_points: List[Tuple[int, int]] = field(default_factory=list)
    associated_trees: Set[Tuple[int, int]] = field(default_factory=set)
    tree_root: Tuple[int, int] = (0, -1)  # (row, local column); -1 col = none
    tree_num_points: int = 0
    cluster_width: int = 0
    tree_id: int = 0
    id: int = 0
    visited_at_continuous_azimuth_angle: float = -1.0
    belongs_to_finished_cluster: bool = False

    def reset(self) -> None:
        self.__init__()  # reuse defaults (mirrors clearColumns, …cpp:1094-1145)


class OracleContinuousClustering:
    """Sequential reference-exact pipeline (single-threaded mode only)."""

    def __init__(self, config: Config, num_rows: int):
        self.config = config
        self.num_rows = num_rows
        self.num_columns = config.range_image.num_columns
        self.ring_cols = config.ring_buffer_max_columns
        self.az_width = F32(2.0 * math.pi) / F32(self.num_columns)  # …cpp:16
        self.max_distance_squared = F32(config.clustering.max_distance) * F32(
            config.clustering.max_distance
        )

        self.cells: List[List[OracleCell]] = [
            [OracleCell() for _ in range(num_rows)] for _ in range(self.ring_cols)
        ]

        # srig state (…cpp:29-36)
        self.ring_start = -1
        self.ring_end = -1
        self.prev_rearmost = 0
        self.prev_foremost = -1
        self.first_unfinished = -1
        self.reset_required = False
        self.sensor_position = np.zeros(3)

        # sgps state
        self.ego_from_sensor: Optional[np.ndarray] = None  # 4x4
        self.inclination_diffs = np.full(num_rows, np.nan, dtype=np.float32)

        # sc state (…cpp:41-46)
        self.first_unpublished = -1
        self.min_required_indices: List[int] = []
        self.unfinished_trees: List[Tuple[int, int]] = []
        self.cluster_counter = 1

        self.finished_column_callback: Optional[Callable[[int, int, bool], None]] = None
        self.finished_cluster_callback: Optional[Callable[[list, int], None]] = None

    # -- helpers ----------------------------------------------------------
    def cell(self, row: int, lcol: int) -> OracleCell:
        return self.cells[lcol][row]

    def set_transform_robot_from_sensor(self, tf: np.ndarray) -> None:
        self.ego_from_sensor = np.asarray(tf, dtype=np.float64)

    # -- stage A: insertion (…cpp:105-292) --------------------------------
    def add_firing(self, firing: Dict[str, np.ndarray], odom_from_sensor: np.ndarray) -> None:
        pose = np.asarray(odom_from_sensor, dtype=np.float64)
        self.sensor_position = pose[:3, 3].copy()
        xyz = np.asarray(firing["xyz"], dtype=np.float32)
        assert xyz.shape[0] == self.num_rows

        foremost = -1
        rearmost = -1
        prev_rot = self.prev_rearmost // self.num_columns  # …cpp:121
        clockwise = self.config.range_image.sensor_is_clockwise

        for row in range(self.num_rows):
            p = xyz[row].astype(np.float64)
            if np.isnan(p[0]):
                continue
            p_odom = pose[:3, :3] @ p + pose[:3, 3]
            p_rel = p_odom - self.sensor_position

            azimuth = F32(math.atan2(F32(p[1]), F32(p[0])))  # sensor frame, …cpp:142
            inc_az = F32(-azimuth + F32(math.pi)) if clockwise else F32(azimuth + F32(math.pi))

            col_in_rot = int(inc_az / self.az_width)  # …cpp:151
            gcol = prev_rot * self.num_columns + col_in_rot
            col_prev = self.prev_rearmost % self.num_columns
            diff = col_in_rot - col_prev
            half = self.num_columns // 2
            rot_off = 0
            if diff < -half:  # …cpp:161
                gcol += self.num_columns
                rot_off = 1
            elif self.prev_rearmost > 0 and diff > half:  # …cpp:166
                gcol -= self.num_columns
                rot_off = -1

            lcol = gcol % self.ring_cols
            cell = self.cell(row, lcol)
            cont_az = (2.0 * math.pi) * float(prev_rot + rot_off) + float(inc_az)

            distance = F32(math.sqrt(float(p_rel @ p_rel)))  # double norm -> float
            # collision: move to next column if free (…cpp:190-202)
            if not np.isnan(cell.distance) and not np.isnan(distance):
                nlcol = lcol + 1
                if nlcol >= self.ring_cols:
                    nlcol -= self.ring_cols
                ncell = self.cell(row, nlcol)
                if np.isnan(ncell.distance):
                    cell = ncell
                    lcol = nlcol
                    gcol += 1
            # never overwrite nearer point (…cpp:205)
            if not np.isnan(cell.distance) and (np.isnan(distance) or distance >= cell.distance):
                continue

            laser_too_far_behind = (
                self.first_unfinished >= 0 and gcol < self.first_unfinished
            )  # …cpp:210
            if not laser_too_far_behind:
                cell.x, cell.y, cell.z = (
                    F32(p_odom[0]),
                    F32(p_odom[1]),
                    F32(p_odom[2]),
                )
                cell.firing_index = int(firing.get("firing_index", 0))
                cell.intensity = int(firing["intensity"][row]) if "intensity" in firing else 0
                cell.stamp = int(firing["stamp"][row]) if "stamp" in firing else 0
                cell.distance = distance
                cell.azimuth_angle = azimuth
                cell.inclination_angle = F32(math.asin(F32(p_rel[2]) / distance))
                cell.continuous_azimuth_angle = cont_az
                cell.global_column_index = gcol
                cell.local_column_index = lcol
                cell.row_index = row
                cell.globally_unique_point_index = (
                    int(firing["uidx"][row]) if "uidx" in firing else -1
                )

            if rearmost < 0 or gcol < rearmost:  # …cpp:241
                rearmost = gcol
            if foremost < 0 or gcol > foremost:
                foremost = gcol

        if rearmost >= 0 and foremost >= 0:
            if (foremost - rearmost) > self.num_columns // 2:  # …cpp:252
                self.reset_required = True
                return
            if rearmost > self.prev_rearmost:
                self.prev_rearmost = rearmost
            if foremost > self.prev_foremost:
                self.prev_foremost = foremost

        if self.prev_foremost < 0:
            return
        if self.ring_start == -1:  # …cpp:274
            self.ring_start = self.prev_rearmost
            self.first_unpublished = self.prev_rearmost
        if self.prev_foremost > self.ring_end:
            self.ring_end = self.prev_foremost
        if self.first_unfinished == -1:
            self.first_unfinished = self.prev_rearmost

        while self.first_unfinished < self.prev_rearmost:  # …cpp:289
            col = self.first_unfinished
            self.first_unfinished += 1
            self._segment_column(col, pose)

    # -- stage B: ground segmentation (…cpp:294-624) -----------------------
    def _segment_column(self, gcol: int, pose: np.ndarray) -> None:
        lcol = gcol % self.ring_cols
        c = self.config.ground_segmentation
        if self.ego_from_sensor is None:
            raise RuntimeError("Transform robot frame from sensor frame was not set yet!")
        ego_from_odom = self.ego_from_sensor @ np.linalg.inv(pose)
        height_sensor_to_ground = F32(
            -self.ego_from_sensor[2, 3] + c.height_ref_to_ground
        )  # …cpp:302

        sensor_pos32 = self.sensor_position.astype(np.float32)

        first_obstacle_detected = False
        first_point_found = False
        last_ground = np.array([0.0, 0.0, height_sensor_to_ground], dtype=np.float32)
        previous_pos = np.zeros(3, dtype=np.float32)
        previous_label = DBG_WHITE
        inclination_prev = F32(0.0)

        def to2d(p):
            # (xy length, z) in azimuth plane (continuous_clustering.hpp:229-232)
            return np.array(
                [F32(math.hypot(float(p[0]), float(p[1]))), p[2]], dtype=np.float32
            )

        for row in range(self.num_rows - 1, -1, -1):
            cell = self.cell(row, lcol)
            if cell.global_column_index not in (gcol, -1):  # …cpp:321 overflow guard
                raise RuntimeError(
                    "Ring buffer column not cleared (overflow): "
                    f"{cell.global_column_index} vs {gcol}"
                )
            cell.global_column_index = gcol  # refill omitted cells (…cpp:348)
            cell.local_column_index = lcol

            inc_cur = cell.inclination_angle
            diff = F32(inc_cur - inclination_prev)
            if not np.isnan(diff):
                self.inclination_diffs[row] = diff  # …cpp:356
            inclination_prev = inc_cur

            if np.isnan(cell.distance):
                if (
                    self.config.range_image.supplement_inclination_angle_for_nan_cells
                    and row < self.num_rows - 1
                ):
                    below = self.cell(row + 1, lcol)
                    cell.inclination_angle = F32(
                        below.inclination_angle + self.inclination_diffs[row]
                    )
                cell.continuous_azimuth_angle = (float(gcol) + 0.5) * float(self.az_width)
                continue

            if (
                c.fog_filtering_enabled
                and cell.intensity < c.fog_filtering_intensity_below
                and cell.distance < c.fog_filtering_distance_below
                and cell.inclination_angle > c.fog_filtering_inclination_above
            ):  # …cpp:377
                cell.ground_point_label = GP_FOG
                cell.debug_label = DBG_LIGHTGRAY
                continue

            cur = np.array([cell.x, cell.y, cell.z], dtype=np.float32)
            p_ego = ego_from_odom[:3, :3] @ cur.astype(np.float64) + ego_from_odom[:3, 3]
            if (
                p_ego[0] < c.length_ref_to_front_end
                and p_ego[0] > c.length_ref_to_rear_end
                and p_ego[1] < c.width_ref_to_left_mirror
                and p_ego[1] > c.width_ref_to_right_mirror
                and p_ego[2] < c.height_ref_to_maximum
                and p_ego[2] > c.height_ref_to_ground
            ):  # …cpp:394
                cell.ground_point_label = GP_EGO_VEHICLE
                cell.debug_label = DBG_VIOLET
                continue

            cur_rel = (cur - sensor_pos32).astype(np.float32)

            if not first_point_found:  # …cpp:409
                first_point_found = True
                hog = F32(cur_rel[2] - height_sensor_to_ground)
                if (
                    hog > c.first_ring_as_ground_min_allowed_z_diff
                    and hog < c.first_ring_as_ground_max_allowed_z_diff
                ):
                    cell.ground_point_label = GP_GROUND
                    cell.debug_label = DBG_GRAY
                    last_ground = cur_rel
                    first_obstacle_detected = False
                else:
                    cell.ground_point_label = GP_OBSTACLE
                    cell.debug_label = DBG_ORANGE
                    first_obstacle_detected = True
                previous_pos = cur_rel
                previous_label = cell.debug_label
                continue

            cur2d = to2d(cur_rel)
            prev2d = to2d(previous_pos)
            d_prev = cur2d - prev2d
            slope_prev = F32(d_prev[1] / d_prev[0]) if d_prev[0] != 0 else F32(np.inf)
            is_flat_prev = abs(slope_prev) < c.max_slope and d_prev[0] > 0  # …cpp:438
            if c.use_terrain:
                is_flat_prev = is_flat_prev and d_prev[0] < 5

            lg2d = to2d(last_ground)
            d_lg = cur2d - lg2d
            slope_lg = F32(d_lg[1] / d_lg[0]) if d_lg[0] != 0 else F32(np.inf)
            is_flat_lg = abs(slope_lg) < c.max_slope and d_lg[0] > 0  # …cpp:445

            if not first_obstacle_detected and is_flat_prev:  # …cpp:448
                cell.ground_point_label = GP_GROUND
                cell.debug_label = DBG_GREEN
            else:
                if not c.use_terrain:  # terrain path is stubbed in reference too
                    if first_obstacle_detected and is_flat_prev and is_flat_lg:
                        cell.ground_point_label = GP_GROUND
                        cell.debug_label = DBG_YELLOWGREEN
                    elif (
                        abs(d_lg[0]) < c.ground_because_close_to_last_certain_ground_max_dist_diff
                        and abs(d_lg[1]) < c.ground_because_close_to_last_certain_ground_max_z_diff
                    ):  # …cpp:497
                        cell.ground_point_label = GP_GROUND
                        cell.debug_label = DBG_YELLOW

            if cell.ground_point_label != GP_GROUND:  # …cpp:508
                cell.ground_point_label = GP_OBSTACLE
                cell.debug_label = DBG_RED
                # retroactive relabel of close lower ground points (…cpp:514-535)
                prev_row = row + 1
                while prev_row < self.num_rows:
                    lower = self.cell(prev_row, lcol)
                    lower_rel = (
                        np.array([lower.x, lower.y, lower.z], dtype=np.float32) - sensor_pos32
                    )
                    lower2d = to2d(lower_rel)
                    if lower.debug_label == DBG_YELLOW or (
                        lower.ground_point_label == GP_GROUND
                        and abs(cur2d[0] - lower2d[0])
                        < c.obstacle_because_next_certain_obstacle_max_dist_diff
                    ):
                        if lower.ground_point_label == GP_GROUND:
                            lower.ground_point_label = GP_OBSTACLE
                            lower.debug_label = DBG_DARKRED
                        prev_row += 1
                    else:
                        break

            first_obstacle_detected |= cell.ground_point_label == GP_OBSTACLE

            if cell.debug_label in (DBG_GREEN, DBG_YELLOWGREEN):  # …cpp:542
                if (
                    slope_prev > c.last_ground_point_slope_higher_than
                    and abs(d_prev[0]) < c.last_ground_point_distance_smaller_than
                    and previous_label != DBG_YELLOW
                ):
                    last_ground = cur_rel

            previous_pos = cur_rel
            previous_label = cell.debug_label

        # second pass: is_ignored flags (…cpp:567-616)
        cl = self.config.clustering
        for row in range(self.num_rows - 1, -1, -1):
            cell = self.cell(row, lcol)
            cell.is_ignored = False
            if np.isnan(cell.distance):
                cell.is_ignored = True
                continue
            if cell.ground_point_label != GP_OBSTACLE:
                cell.is_ignored = True
                continue
            if cell.distance < 1.0 * cl.max_distance:
                cell.is_ignored = True
                continue
            if (
                cl.ignore_points_with_too_big_inclination_angle_diff
                and row < self.num_rows - 1
                and F32(math.atan2(cl.max_distance, cell.distance))
                < self.inclination_diffs[row]
            ):
                cell.is_ignored = True
                continue
            if cl.ignore_points_in_chessboard_pattern:
                col_even = cell.global_column_index % 2 == 0
                row_even = row % 2 == 0
                if (col_even and not row_even) or (not col_even and row_even):
                    cell.is_ignored = True
                    continue

        if self.finished_column_callback:
            self.finished_column_callback(gcol, gcol, True)
        self._associate_column(gcol)

    # -- stage C: association (…cpp:638-835) -------------------------------
    def _check_condition(self, a: OracleCell, b: OracleCell) -> bool:
        dx = F32(a.x - b.x)
        dy = F32(a.y - b.y)
        dz = F32(a.z - b.z)
        return F32(dx * dx + dy * dy + dz * dz) < self.max_distance_squared

    def _associate_point_to_tree(
        self, cell: OracleCell, other: OracleCell, max_angle_diff: float
    ) -> None:
        root = self.cell(other.tree_root[0], other.tree_root[1])
        new_width = cell.global_column_index - root.global_column_index + 1
        if new_width <= self.num_columns and not root.belongs_to_finished_cluster:
            cell.tree_root = other.tree_root
            cell.tree_id = root.global_column_index * self.num_rows + root.row_index
            other.child_points.append((cell.row_index, cell.local_column_index))
            root.cluster_width = new_width
            root.finished_at_continuous_azimuth_angle = max(
                root.finished_at_continuous_azimuth_angle,
                cell.continuous_azimuth_angle + max_angle_diff,
            )
            root.tree_num_points += 1

    def _associate_tree_to_tree(self, cell: OracleCell, other: OracleCell) -> None:
        root = self.cell(cell.tree_root[0], cell.tree_root[1])
        other_root = self.cell(other.tree_root[0], other.tree_root[1])
        if not root.belongs_to_finished_cluster and not other_root.belongs_to_finished_cluster:
            root.associated_trees.add(other.tree_root)
            other_root.associated_trees.add(cell.tree_root)

    def _traverse_fov(
        self, cell: OracleCell, max_angle_diff: float, first_local_col: int
    ) -> None:
        cl = self.config.clustering
        steps_back = int(math.ceil(max_angle_diff / float(self.az_width)))
        steps_back = min(steps_back, cl.max_steps_in_row)
        other_col = cell.local_column_index
        for nsb in range(0, steps_back + 1):
            for direction in (-1, 1):
                if direction == 1 and nsb == 0:
                    continue  # don't go down in first column (…cpp:712)
                steps_v = 1 if (direction == 1 or nsb == 0) else 0
                other_row = (
                    cell.row_index + direction if (direction == 1 or nsb == 0) else cell.row_index
                )
                while 0 <= other_row < self.num_rows and steps_v <= cl.max_steps_in_column:
                    other = self.cell(other_row, other_col)
                    # profiling counter (…cpp:725): counts every visited
                    # cell, including the one that breaks the walk
                    cell.number_of_visited_neighbors += 1
                    if abs(
                        F32(other.inclination_angle) - F32(cell.inclination_angle)
                    ) > max_angle_diff:
                        break  # …cpp:728
                    if not other.is_ignored and (
                        cell.tree_root[1] == 0 or other.tree_root != cell.tree_root
                    ):
                        if self._check_condition(cell, other):
                            if cell.tree_root[1] == -1:
                                self._associate_point_to_tree(cell, other, max_angle_diff)
                            else:
                                self._associate_tree_to_tree(cell, other)
                    if (
                        cell.tree_root[1] != -1
                        and cl.stop_after_association_enabled
                        and steps_v >= cl.stop_after_association_min_steps
                    ):
                        break
                    other_row += direction
                    steps_v += 1
            if (
                cell.tree_root[1] != -1
                and cl.stop_after_association_enabled
                and nsb >= cl.stop_after_association_min_steps
            ):
                break
            if other_col == first_local_col:
                break
            other_col -= 1
            if other_col < 0:
                other_col += self.ring_cols

    def _associate_column(self, gcol: int) -> None:
        new_trees: List[Tuple[int, int]] = []
        current_min_az = math.inf
        first_local = self.first_unpublished % self.ring_cols
        lcol = gcol % self.ring_cols

        for row in range(self.num_rows):
            cell = self.cell(row, lcol)
            if cell.continuous_azimuth_angle < current_min_az:
                current_min_az = cell.continuous_azimuth_angle
            if cell.is_ignored:
                continue
            max_angle_diff = F32(
                math.asin(F32(self.config.clustering.max_distance) / cell.distance)
            )
            self._traverse_fov(cell, float(max_angle_diff), first_local)
            if cell.tree_root[1] == -1:  # new tree root (…cpp:811)
                cell.tree_root = (row, lcol)
                cell.tree_id = cell.global_column_index * self.num_rows + cell.row_index
                cell.finished_at_continuous_azimuth_angle = (
                    cell.continuous_azimuth_angle + float(max_angle_diff)
                )
                cell.cluster_width = 1
                cell.tree_num_points = 1
                new_trees.append((row, lcol))

        self._combine_trees(gcol, new_trees, current_min_az)

    # -- stage D: tree combination (…cpp:837-974) --------------------------
    def _combine_trees(
        self, gcol: int, new_trees: List[Tuple[int, int]], current_min_az: float
    ) -> None:
        self.unfinished_trees.extend(new_trees)
        if gcol % self.config.clustering.cluster_point_trees_every_nth_column != 0:
            return

        trees_per_cluster: List[List[Tuple[int, int]]] = []
        cluster_ids: List[int] = []

        for tree_index in list(self.unfinished_trees):
            root = self.cell(tree_index[0], tree_index[1])
            if root.visited_at_continuous_azimuth_angle == current_min_az:
                continue
            collected: List[Tuple[int, int]] = []
            to_visit: List[Tuple[int, int]] = [tree_index]
            min_col = math.inf
            max_col = 0
            num_points = 0
            has_unfinished = False
            while to_visit:
                cur_index = to_visit.pop(0)
                cur_root = self.cell(cur_index[0], cur_index[1])
                if cur_root.belongs_to_finished_cluster:  # …cpp:874
                    continue
                min_col = min(min_col, cur_root.global_column_index)
                max_col = max(
                    max_col, cur_root.global_column_index + cur_root.cluster_width
                )
                if cur_root.finished_at_continuous_azimuth_angle > current_min_az:
                    has_unfinished = True
                if cur_root.visited_at_continuous_azimuth_angle == current_min_az:
                    continue
                cur_root.visited_at_continuous_azimuth_angle = current_min_az
                collected.append(cur_index)
                num_points += cur_root.tree_num_points
                for other_index in cur_root.associated_trees:
                    other_root = self.cell(other_index[0], other_index[1])
                    if other_root.visited_at_continuous_azimuth_angle != current_min_az:
                        to_visit.append(other_index)

            exceeds_rotation = (max_col - min_col) >= self.num_columns  # …cpp:914
            if (not collected or has_unfinished) and not exceeds_rotation:
                continue
            for cur_index in collected:
                self.cell(cur_index[0], cur_index[1]).belongs_to_finished_cluster = True
            if num_points > 5:  # …cpp:936
                trees_per_cluster.append(collected)
                cluster_ids.append(self.cluster_counter)
                self.cluster_counter += 1

        # erase finished trees + min required column (…cpp:943-959)
        min_required = math.inf
        remaining = []
        for idx in self.unfinished_trees:
            root = self.cell(idx[0], idx[1])
            if root.global_column_index < min_required:
                min_required = root.global_column_index
            if not root.belongs_to_finished_cluster:
                remaining.append(idx)
        self.unfinished_trees = remaining
        if min_required == math.inf:
            min_required = gcol + 1
        min_required = int(min_required)
        self.min_required_indices.append(min_required)

        self._publish(gcol, min_required, cluster_ids, trees_per_cluster)

    # -- stage E: publishing (…cpp:976-1092) -------------------------------
    def _publish(
        self,
        gcol: int,
        min_required: int,
        cluster_ids: List[int],
        trees_per_cluster: List[List[Tuple[int, int]]],
    ) -> None:
        for cluster_id, tree_list in zip(cluster_ids, trees_per_cluster):
            cluster_points = []
            min_stamp = None
            max_stamp = None
            for root_index in tree_list:
                to_visit = [root_index]
                while to_visit:
                    idx = to_visit.pop(0)
                    cur = self.cell(idx[0], idx[1])
                    cur.id = cluster_id
                    # snapshot by value: the reference copies Points into the
                    # published vector (…cpp:1006); live cells are cleared later
                    cluster_points.append(copy.copy(cur))
                    if min_stamp is None or cur.stamp < min_stamp:
                        min_stamp = cur.stamp
                    if max_stamp is None or cur.stamp > max_stamp:
                        max_stamp = cur.stamp
                    to_visit.extend(cur.child_points)
            if len(cluster_points) > 20 and self.finished_cluster_callback:  # …cpp:1023
                if self.config.clustering.use_last_point_for_cluster_stamp:
                    stamp = max_stamp
                else:
                    stamp = min_stamp + (max_stamp - min_stamp) // 2
                self.finished_cluster_callback(cluster_points, stamp)

        # advance publish frontier (…cpp:1035-1091); single-threaded -> FIFO
        self.min_required_indices.remove(min_required)
        start_old = self.ring_start
        unpublished_old = self.first_unpublished
        if self.min_required_indices:
            self.first_unpublished = self.min_required_indices[0]
        else:
            self.first_unpublished = min_required
        if self.first_unpublished < unpublished_old:
            raise RuntimeError("publish frontier decreased")
        self.ring_start = max(0, self.first_unpublished - self.num_columns)
        if self.finished_column_callback:
            self.finished_column_callback(unpublished_old, self.first_unpublished - 1, False)
        for g in range(start_old, self.ring_start):
            lc = g % self.ring_cols
            for row in range(self.num_rows):
                self.cells[lc][row].reset()

    # -- convenience accessors for tests ----------------------------------
    def column_field(self, gcol: int, name: str):
        lc = gcol % self.ring_cols
        return [getattr(self.cells[lc][r], name) for r in range(self.num_rows)]
