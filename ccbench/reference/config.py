# FROZEN COPY of ``continuous_clustering_tpu_torch/config.py`` at commit cce7c49ab9acd93ca72165a17ff47a74717926ce.
#
# Part of the benchmark's yardstick: later changes to the program do not
# edit this file, so the benchmark measures every commit with the same
# code.  Only imports were changed, so that nothing here imports the
# program or the JAX package.  The original's docstring follows.

"""Configuration of the continuous clustering pipeline (the port's copy of
``continuous_clustering_tpu/config.py``; the port imports nothing of the JAX
package).

Mirrors the reference configuration surface (all 23 live-tunable parameters of
``cfg/ContinuousClustering.cfg`` and the nested groups of
``include/continuous_clustering/clustering/continuous_clustering.hpp:24-87``)
so that a user of the reference can carry their parameter set over unchanged.
Some parameter changes force a hard ``reset()``
(``src/clustering/continuous_clustering.cpp:66-81``), see
``Config.reset_required_vs``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class GeneralConfig:
    """General settings (reference: GeneralConfiguration)."""

    # Reference uses this to force deterministic synchronous execution
    # (thread pools with 0 workers). Here it disables the async host
    # pipeline so batches run strictly in order.
    is_single_threaded: bool = False


@dataclass(frozen=True)
class RangeImageConfig:
    """Continuous range image generation (reference: ContinuousRangeImageConfiguration)."""

    sensor_is_clockwise: bool = True
    num_columns: int = 1700
    supplement_inclination_angle_for_nan_cells: bool = True
    # Ring buffer headroom in revolutions (reference hardcodes 10:
    # src/clustering/continuous_clustering.cpp:17).
    ring_buffer_revolutions: int = 10


@dataclass(frozen=True)
class GroundSegmentationConfig:
    """Ground point segmentation (reference: ContinuousGroundSegmentationConfiguration)."""

    # General
    max_slope: float = 0.2
    first_ring_as_ground_max_allowed_z_diff: float = 0.4
    first_ring_as_ground_min_allowed_z_diff: float = -0.4

    # General advanced
    last_ground_point_slope_higher_than: float = -0.1
    last_ground_point_distance_smaller_than: float = 5.0
    ground_because_close_to_last_certain_ground_max_z_diff: float = 0.4
    ground_because_close_to_last_certain_ground_max_dist_diff: float = 2.0
    obstacle_because_next_certain_obstacle_max_dist_diff: float = 0.3

    # Segmentation by terrain (reference keeps this as a stub; we gate it too)
    use_terrain: bool = False
    terrain_max_allowed_z_diff: float = 0.4

    # Ego robot bounding box (coordinates w.r.t. the ego robot reference frame)
    height_ref_to_maximum: float = 0.0
    height_ref_to_ground: float = 0.0
    length_ref_to_front_end: float = 0.0
    length_ref_to_rear_end: float = 0.0
    width_ref_to_left_mirror: float = 0.0
    width_ref_to_right_mirror: float = 0.0

    # Fog filtering
    fog_filtering_enabled: bool = False
    fog_filtering_intensity_below: int = 2
    fog_filtering_distance_below: float = 18.0
    fog_filtering_inclination_above: float = -0.06


@dataclass(frozen=True)
class ClusteringConfig:
    """Clustering (reference: ContinuousClusteringConfiguration)."""

    max_distance: float = 0.7
    max_steps_in_row: int = 20
    max_steps_in_column: int = 20
    stop_after_association_enabled: bool = True
    stop_after_association_min_steps: int = 1
    ignore_points_in_chessboard_pattern: bool = True
    ignore_points_with_too_big_inclination_angle_diff: bool = True
    use_last_point_for_cluster_stamp: bool = False
    cluster_point_trees_every_nth_column: int = 1
    # Populate the per-point profiling counters (number_of_visited_neighbors,
    # reference …cpp:725, plus the CC edge degree standing in for
    # num_child_points) in the ring so debug clouds carry them.  Off by
    # default: the reconstruction costs a few extra vector ops per batch.
    record_neighbor_stats: bool = False
    # Device knob (no reference analog): capacity of the device-resident
    # component table.  Components (point trees in the reference) live from
    # first association until their ring columns are cleared one rotation
    # after publishing; exceeding the capacity raises the same overflow error
    # as a too-slow ring buffer.  The reference's equivalent state is the
    # unbounded per-cell tree links.
    max_active_components: int = 8192


@dataclass(frozen=True)
class Config:
    """Top-level configuration (reference: Configuration)."""

    general: GeneralConfig = GeneralConfig()
    range_image: RangeImageConfig = RangeImageConfig()
    ground_segmentation: GroundSegmentationConfig = GroundSegmentationConfig()
    clustering: ClusteringConfig = ClusteringConfig()

    @property
    def max_distance_squared(self) -> float:
        return self.clustering.max_distance * self.clustering.max_distance

    @property
    def azimuth_width_per_column(self) -> float:
        import math

        return (2.0 * math.pi) / float(self.range_image.num_columns)

    @property
    def ring_buffer_max_columns(self) -> int:
        return self.range_image.num_columns * self.range_image.ring_buffer_revolutions

    def replace(self, **groups) -> "Config":
        return dataclasses.replace(self, **groups)

    def reset_required_vs(self, other: "Config") -> bool:
        """Parameter changes that force a hard reset (reference
        ``setConfiguration``, src/clustering/continuous_clustering.cpp:66-81)."""
        return (
            self.general.is_single_threaded != other.general.is_single_threaded
            or self.range_image.sensor_is_clockwise != other.range_image.sensor_is_clockwise
            or self.range_image.num_columns != other.range_image.num_columns
        )


# ---------------------------------------------------------------------------
# Presets mirroring the reference launch files (launch/sensor_*.launch,
# launch/vehicle_*.launch, src/tools/kitti_demo.cpp:279-294).
# ---------------------------------------------------------------------------


def kitti_config(single_threaded: bool = True) -> Config:
    """Configuration used by the reference KITTI demo/evaluation
    (src/tools/kitti_demo.cpp:279-294 + launch/vehicle_kitti.launch)."""
    return Config(
        general=GeneralConfig(is_single_threaded=single_threaded),
        range_image=RangeImageConfig(num_columns=2200),
        ground_segmentation=GroundSegmentationConfig(
            height_ref_to_maximum=0.5,
            height_ref_to_ground=-1.7,
            length_ref_to_front_end=3.0,
            length_ref_to_rear_end=-3.0,
            width_ref_to_left_mirror=1.5,
            width_ref_to_right_mirror=-1.5,
        ),
        clustering=ClusteringConfig(
            max_distance=0.5,
            ignore_points_in_chessboard_pattern=False,
        ),
    )


def vls128_roof_config() -> Config:
    """VLS-128 roof sensor preset (launch/sensor_vls128_roof.launch:
    1700 columns, clockwise; ego box from launch/vehicle_touareg.launch)."""
    return Config(
        range_image=RangeImageConfig(num_columns=1700),
        ground_segmentation=GroundSegmentationConfig(
            height_ref_to_maximum=2.0,
            height_ref_to_ground=-1.0,
            length_ref_to_front_end=3.0,
            length_ref_to_rear_end=-2.0,
            width_ref_to_left_mirror=1.2,
            width_ref_to_right_mirror=-1.2,
        ),
    )


def ouster_os32_config(fog_filtering: bool = True) -> Config:
    """Tilted Ouster OS-32 preset (launch/sensor_os32_left.launch /
    sensor_os32_right.launch: 1024 columns, fog preset enabled)."""
    return Config(
        range_image=RangeImageConfig(num_columns=1024),
        ground_segmentation=GroundSegmentationConfig(
            fog_filtering_enabled=fog_filtering,
            height_ref_to_maximum=2.0,
            height_ref_to_ground=-1.0,
            length_ref_to_front_end=3.0,
            length_ref_to_rear_end=-2.0,
            width_ref_to_left_mirror=1.2,
            width_ref_to_right_mirror=-1.2,
        ),
    )


PRESETS = {
    "kitti": kitti_config,
    "vls128_roof": vls128_roof_config,
    "os32": ouster_os32_config,
}
