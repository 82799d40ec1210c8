"""Launch-tree analog: composable sensor/vehicle/demo presets (the port's
counterpart of ``continuous_clustering_tpu/launch.py``, with the
reference's values).

Mirrors the reference's launch-file cascade (launch/*.launch): a *sensor*
preset carries the per-sensor configuration + input wiring, a *vehicle*
preset carries the ego geometry written to the parameter server
(launch/vehicle_*.launch), and a *demo* composes one node per sensor
(launch/demo_touareg.launch:20-31).  ``make_node`` turns a description
into a runnable :class:`~continuous_clustering_tpu_torch.io.node.ClusteringNode`
on the card (``device="cpu"`` for a CPU run).

The OS-32 presets read the sensor's ``sensor_info`` JSON when their node is
made; ``metadata_path`` (or ``os32_metadata`` of ``demo_touareg``) names
it, as a path or as the parsed dict, and defaults to the reference's
calibration files under ``REFERENCE_CALIBRATIONS``.

Example::

    from continuous_clustering_tpu_torch import launch
    nodes = [launch.make_node(d) for d in launch.demo_touareg(os32_metadata=info)]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Union

from .config import (
    ClusteringConfig,
    Config,
    GeneralConfig,
    GroundSegmentationConfig,
    RangeImageConfig,
)

# the reference repository's ``calibrations/`` folder: the OS-32 presets'
# default sensor_info files.  Relative to the working directory unless
# CCT_REFERENCE_CALIBRATIONS names it.
REFERENCE_CALIBRATIONS = os.environ.get("CCT_REFERENCE_CALIBRATIONS", "calibrations")


@dataclasses.dataclass
class LaunchDescription:
    """One clustering node: config + sensor input wiring.

    ``sensor_frame`` / ``raw_data_topic`` mirror the reference's launch args
    (a middleware bridge maps topics onto ``ClusteringNode.on_raw_data``)."""

    name: str
    config: Config
    sensor_manufacturer: str
    sensor_kwargs: Dict
    sensor_frame: str
    raw_data_topic: str


# --------------------------------------------------------------------------
# vehicles (launch/vehicle_*.launch — exact parameter-server values)
# --------------------------------------------------------------------------

def vehicle_touareg() -> GroundSegmentationConfig:
    """launch/vehicle_touareg.launch:4-10."""
    return GroundSegmentationConfig(
        height_ref_to_maximum=1.9,
        height_ref_to_ground=-0.64,
        length_ref_to_front_end=2.3535,
        length_ref_to_rear_end=-2.4005,
        width_ref_to_left_mirror=1.1085,
        width_ref_to_right_mirror=-1.1085,
    )


def vehicle_kitti() -> GroundSegmentationConfig:
    """launch/vehicle_kitti.launch (vw_passat_b6)."""
    return GroundSegmentationConfig(
        height_ref_to_maximum=0.5,
        height_ref_to_ground=-1.7,
        length_ref_to_front_end=3.0,
        length_ref_to_rear_end=-3.0,
        width_ref_to_left_mirror=1.5,
        width_ref_to_right_mirror=-1.5,
    )


# --------------------------------------------------------------------------
# sensors (launch/sensor_*.launch)
# --------------------------------------------------------------------------

def sensor_vls128_roof(
    vehicle: Optional[GroundSegmentationConfig] = None,
    is_single_threaded: bool = False,
    calibration_path: Optional[str] = None,
) -> LaunchDescription:
    """launch/sensor_vls128_roof.launch: VLS-128, 1700 columns, 600 rpm."""
    gs = vehicle or vehicle_touareg()
    cfg = Config(
        general=GeneralConfig(is_single_threaded=is_single_threaded),
        range_image=RangeImageConfig(num_columns=1700),
        ground_segmentation=gs,
        clustering=ClusteringConfig(),
    )
    kwargs: Dict = {"num_lasers": 128, "decode_threads": 1}
    if calibration_path:
        from .sensors.velodyne_calibration import load_calibration

        kwargs.update(load_calibration(calibration_path))
    return LaunchDescription(
        name="vls128_roof",
        config=cfg,
        sensor_manufacturer="velodyne",
        sensor_kwargs=kwargs,
        sensor_frame="sensor/lidar/vls128_roof",
        raw_data_topic="/bus/vls128_roof/eth_scan/bus_to_host",
    )


def sensor_os32(
    position: str = "left",
    vehicle: Optional[GroundSegmentationConfig] = None,
    is_single_threaded: bool = False,
    metadata_path: Optional[Union[str, Dict]] = None,
) -> LaunchDescription:
    """launch/sensor_os32_left.launch / _right: tilted OS-32, 1024 columns,
    fog preset (intensity<3, distance<5, inclination>-0.17).
    ``metadata_path``: the sensor_info JSON's path, or the parsed dict."""
    gs = dataclasses.replace(
        vehicle or vehicle_touareg(),
        fog_filtering_enabled=True,
        fog_filtering_intensity_below=3,
        fog_filtering_distance_below=5.0,
        fog_filtering_inclination_above=-0.17,
    )
    cfg = Config(
        general=GeneralConfig(is_single_threaded=is_single_threaded),
        range_image=RangeImageConfig(num_columns=1024),
        ground_segmentation=gs,
        clustering=ClusteringConfig(
            ignore_points_in_chessboard_pattern=False,
            ignore_points_with_too_big_inclination_angle_diff=False,
        ),
    )
    meta = metadata_path or f"{REFERENCE_CALIBRATIONS}/touareg_os32_{position}.json"
    return LaunchDescription(
        name=f"os32_{position}",
        config=cfg,
        sensor_manufacturer="ouster",
        sensor_kwargs={"sensor_info": meta, "decode_threads": 1},
        sensor_frame=f"sensor/lidar/os32_{position}/os_sensor",
        raw_data_topic=f"/bus/os32_{position}/lidar_packets",
    )


def sensor_kitti(is_single_threaded: bool = True) -> LaunchDescription:
    """launch/sensor_kitti.launch: generic points input, 2200 columns."""
    cfg = Config(
        general=GeneralConfig(is_single_threaded=is_single_threaded),
        range_image=RangeImageConfig(num_columns=2200),
        ground_segmentation=vehicle_kitti(),
        clustering=ClusteringConfig(
            max_distance=0.5, ignore_points_in_chessboard_pattern=False
        ),
    )
    return LaunchDescription(
        name="kitti",
        config=cfg,
        sensor_manufacturer="generic_points",
        sensor_kwargs={},
        sensor_frame="velo_link",
        raw_data_topic="/kitti/velo/pointcloud",
    )


# --------------------------------------------------------------------------
# demos (launch/demo_*.launch)
# --------------------------------------------------------------------------

def demo_touareg(
    use_vls128_roof: bool = True,
    use_os32_left: bool = True,
    use_os32_right: bool = True,
    is_single_threaded: bool = False,
    os32_metadata: Optional[Union[str, Dict]] = None,
) -> List[LaunchDescription]:
    """launch/demo_touareg.launch:20-31 — one clustering node per sensor.
    ``os32_metadata`` (a path or a dict) goes to both OS-32 presets."""
    out: List[LaunchDescription] = []
    if use_vls128_roof:
        out.append(sensor_vls128_roof(is_single_threaded=is_single_threaded))
    for position, used in (("left", use_os32_left), ("right", use_os32_right)):
        if used:
            out.append(sensor_os32(position, is_single_threaded=is_single_threaded,
                                   metadata_path=os32_metadata))
    return out


def demo_kitti_folder(is_single_threaded: bool = True) -> LaunchDescription:
    """launch/demo_kitti_folder.launch — the kitti_demo CLI configuration."""
    return sensor_kitti(is_single_threaded=is_single_threaded)


def make_node(desc: LaunchDescription, firing_batch_size: int = 256, device=None):
    """Instantiate the ClusteringNode for a launch description, on
    ``device`` (the card unless the caller names the CPU)."""
    import numpy as np

    from .io.node import ClusteringNode

    return ClusteringNode(
        config=desc.config,
        sensor_manufacturer=desc.sensor_manufacturer,
        sensor_kwargs=desc.sensor_kwargs,
        ego_robot_frame_from_sensor_frame=np.eye(4),
        firing_batch_size=firing_batch_size,
        device=device,
    )
