"""Raw sensor packets of a synthetic scene, for driving the node from its
packet entry point (``ClusteringNode.on_raw_data``) without a sensor.

* ``velodyne_packets``: 1206-byte Velodyne data packets of ray-cast frames
  for a sensor of 32 or more lasers (VLS-128 class: four blocks of 32
  lasers under the bank flags ``0xEEFF``/``0xDDFF``/``0xCCFF``/``0xBBFF``
  make one firing, so a 12-block packet carries three), at the
  ``VelodyneInput`` defaults (vertical angles ``linspace(15, -25, R)``,
  2 mm distance ticks), and ``vlp16_packets`` for a VLP-16 (two firings of
  16 lasers a block, 24 a packet);
* ``os32_sensor_info`` and ``ouster_legacy_packets``: an OS-32 ``sensor_info``
  (LEGACY profile, 16 columns per packet, 32 beams spread evenly over the
  sensor's +-22.5 degree vertical field of view) and its lidar packets.

Frames come from ``evaluation.synthetic.raycast_frame`` at the decoder's
own beam inclinations, so every ray lands in the row it was cast for.
Packet ``p`` is stamped ``t0_ns`` plus the time its first firing (or
column) takes to come round at ``rpm``.  Used by the node tests, on the CPU
and on the card (``tests/test_torch_node_card.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..evaluation.synthetic import make_scene, raycast_frame

VELODYNE_BANKS = (0xEEFF, 0xDDFF, 0xCCFF, 0xBBFF)
VELODYNE_BLOCK = np.dtype([("flag", "<u2"), ("az", "<u2"),
                           ("ch", [("d", "<u2"), ("i", "u1")], (32,))])
ENCODER_TICKS_PER_REV = 90112
OUSTER_LEGACY_COLUMN_HEAD = np.dtype([("ts", "<u8"), ("mid", "<u2"), ("fid", "<u2"),
                                      ("enc", "<u4")])


def velodyne_inclinations(num_lasers: int) -> np.ndarray:
    """Top-to-bottom beam inclinations (radians) of ``VelodyneInput``'s
    default calibration for ``num_lasers`` other than 16."""
    return np.deg2rad(np.linspace(15, -25, num_lasers))


def column_azimuths(num_columns: int) -> np.ndarray:
    """Azimuth (radians, atan2(y, x)) of each column of ``raycast_frame``."""
    inc_az = (np.arange(num_columns) + 0.5) * (2.0 * math.pi / num_columns)
    return math.pi - inc_az


def scene_frames(num_rows: int, num_columns: int, n_rev: int, inclinations,
                 seed: int = 5, num_boxes: int = 14, spread: float = 30.0) -> List[np.ndarray]:
    """``n_rev`` ray-cast (C, R, 3) frames of one scene."""
    scene = make_scene(num_boxes=num_boxes, seed=seed, spread=spread)
    return [raycast_frame(scene, num_rows=num_rows, num_columns=num_columns, seed=seed + f,
                          inclinations=inclinations)[0] for f in range(n_rev)]


def velodyne_packets(frames, distance_resolution: float = 0.002, rpm: float = 600.0,
                     t0_ns: int = 1_000_000_000) -> List[Tuple[int, bytes]]:
    """(stamp_ns, packet) of every firing of ``frames`` (each (C, R, 3),
    R a multiple of 32), three firings per packet."""
    n_cols, R = frames[0].shape[:2]
    if R % 32:
        raise ValueError("the bank layout needs a multiple of 32 lasers")
    banks = R // 32
    if 12 % banks:
        raise ValueError(f"{banks} banks do not divide the 12 blocks of a packet")
    xyz = np.concatenate(frames).astype(np.float64)                 # (F, R, 3)
    F = len(xyz)
    per_packet = 12 // banks
    n_packets = -(-F // per_packet)
    dist = np.linalg.norm(xyz, axis=2)
    ticks = np.where(np.isfinite(dist), np.rint(dist / distance_resolution), 0)
    # the decoder's frame: x = d cos(v) cos(a), y = -d cos(v) sin(a)
    az = np.tile(column_azimuths(n_cols), len(frames))
    az_ticks = np.rint(np.degrees(np.mod(-az, 2.0 * math.pi)) * 100.0).astype(np.int64) % 36000
    blocks = np.zeros((n_packets * per_packet, banks), VELODYNE_BLOCK)
    blocks["flag"] = np.asarray(VELODYNE_BANKS[:banks], np.uint16)[None, :]
    blocks["az"][:F] = az_ticks[:, None]
    blocks["ch"]["d"][:F] = np.clip(ticks, 0, 65535).astype(np.uint16).reshape(F, banks, 32)
    blocks["ch"]["i"][:F] = 100
    # a packet that the stream does not fill carries flags no decoder knows
    blocks["flag"][F:] = 0
    raw = blocks.reshape(n_packets, 12).view(np.uint8).reshape(n_packets, 1200)
    tail = np.zeros((n_packets, 6), np.uint8)
    tail[:, 4] = 0x37                                                # strongest return
    tail[:, 5] = 0xA1                                                # VLS-128
    pkts = np.concatenate([raw, tail], axis=1)
    col_ns = 60e9 / rpm / n_cols
    return [(t0_ns + int(p * per_packet * col_ns), pkts[p].tobytes()) for p in range(n_packets)]


def vlp16_packets(frames, rpm: float = 600.0, t0_ns: int = 1_000_000_000,
                  distance_resolution: float = 0.002) -> List[Tuple[int, bytes]]:
    """(stamp_ns, packet) of ``frames`` (each (C, 16, 3), rows top to
    bottom, ray-cast at ``vlp16_inclinations()``) for a VLP-16: a block
    carries two firings of the 16 lasers in laser-id order at the azimuth of
    its first, so a packet carries 24."""
    from ..sensors.velodyne import VLP16_VERT_ANGLES

    n_cols = frames[0].shape[0]
    xyz = np.concatenate(frames).astype(np.float64)
    F = len(xyz)
    n_packets = -(-F // 24)
    vert = np.asarray(VLP16_VERT_ANGLES)
    row_of_laser = 16 - np.argsort(np.argsort(vert)) - 1            # the decoder's rows
    dist = np.full((n_packets * 24, 16), np.nan)
    dist[:F] = np.linalg.norm(xyz, axis=2)[:, row_of_laser]
    ticks = np.where(np.isfinite(dist), np.rint(dist / distance_resolution), 0)
    az = np.tile(column_azimuths(n_cols), len(frames))
    az = np.concatenate([az, az[-1] + (az[-1] - az[-2]) * np.arange(1, 25)])
    az_ticks = np.rint(np.degrees(np.mod(-az, 2.0 * math.pi)) * 100.0).astype(np.int64) % 36000
    blocks = np.zeros(n_packets * 12, VELODYNE_BLOCK)
    blocks["flag"] = 0xEEFF
    blocks["az"] = az_ticks[0:2 * len(blocks):2]
    blocks["ch"]["d"] = ticks.astype(np.uint16).reshape(-1, 32)
    blocks["ch"]["i"] = 100
    raw = blocks.view(np.uint8).reshape(n_packets, 1200)
    tail = np.zeros((n_packets, 6), np.uint8)
    tail[:, 4], tail[:, 5] = 0x37, 0x22                                # strongest, VLP-16
    pkts = np.concatenate([raw, tail], axis=1)
    col_ns = 60e9 / rpm / n_cols
    return [(t0_ns + int(p * 24 * col_ns), pkts[p].tobytes()) for p in range(n_packets)]


def vlp16_inclinations() -> np.ndarray:
    """The VLP-16's beam inclinations (radians), top to bottom."""
    from ..sensors.velodyne import VLP16_VERT_ANGLES

    return np.deg2rad(np.sort(np.asarray(VLP16_VERT_ANGLES, np.float64))[::-1])


def os32_sensor_info(columns_per_frame: int = 1024, pixels: int = 32,
                     columns_per_packet: int = 16,
                     beam_to_origin_mm: float = 15.806) -> Dict:
    """An OS-32 ``sensor_info`` in the LEGACY profile: ``pixels`` beams
    spread evenly over +-22.5 degrees (top first), no beam azimuth offsets."""
    return {
        "lidar_origin_to_beam_origin_mm": beam_to_origin_mm,
        "beam_altitude_angles": np.linspace(22.5, -22.5, pixels).tolist(),
        "beam_azimuth_angles": [0.0] * pixels,
        "data_format": {
            "pixels_per_column": pixels,
            "columns_per_packet": columns_per_packet,
            "columns_per_frame": columns_per_frame,
            "udp_profile_lidar": "LEGACY",
        },
    }


def ouster_legacy_packets(frames, info: Dict, rpm: float = 600.0, t0_ns: int = 1_000_000_000,
                          fog_below_m: float = 6.0) -> List[Tuple[int, bytes]]:
    """(stamp_ns, packet) of ``frames`` (each (C, R, 3), C the sensor's
    columns per frame) in the LEGACY profile: per column a 16-byte header
    with the encoder count, R 12-byte pixels (range mm, reflectivity,
    signal, noise) and the 0xFFFFFFFF status.  Returns nearer than
    ``fog_below_m`` carry a weak signal (intensity 2), the others 500, and
    pixels without a return no signal."""
    fmt = info["data_format"]
    n_cols, R = frames[0].shape[:2]
    cpp = int(fmt["columns_per_packet"])
    if n_cols != int(fmt["columns_per_frame"]) or R != int(fmt["pixels_per_column"]):
        raise ValueError("frames do not have the sensor_info's shape")
    xyz = np.concatenate(frames).astype(np.float64)
    F = len(xyz)
    dist = np.linalg.norm(xyz, axis=2)
    rng_mm = np.where(np.isfinite(dist), np.rint(dist * 1000.0), 0).astype(np.uint32)
    signal = np.where(np.isfinite(dist), np.where(dist < fog_below_m, 8, 500), 0).astype(np.uint16)
    az = np.tile(column_azimuths(n_cols), len(frames))
    # the decoder's azimuth: 2 pi (1 - encoder / ticks per revolution)
    enc = np.rint((1.0 - np.mod(az, 2.0 * math.pi) / (2.0 * math.pi))
                  * ENCODER_TICKS_PER_REV).astype(np.int64) % ENCODER_TICKS_PER_REV
    n_packets = -(-F // cpp)
    head = np.zeros(n_packets * cpp, OUSTER_LEGACY_COLUMN_HEAD)
    head["mid"] = np.arange(n_packets * cpp) % n_cols
    head["enc"][:F] = enc
    px = np.zeros((n_packets * cpp, R, 6), np.uint16)           # 12 bytes a pixel
    px[:F, :, 0:2] = rng_mm.view(np.uint16).reshape(F, R, 2)
    px[:F, :, 3] = signal
    status = np.zeros((n_packets * cpp, 1), np.uint32)
    status[:F] = 0xFFFFFFFF
    cols = np.concatenate([head.view(np.uint8).reshape(-1, 16),
                           px.view(np.uint8).reshape(-1, 12 * R),
                           status.view(np.uint8).reshape(-1, 4)], axis=1)
    pkts = cols.reshape(n_packets, -1)
    col_ns = 60e9 / rpm / n_cols
    return [(t0_ns + int(p * cpp * col_ns), pkts[p].tobytes()) for p in range(n_packets)]


def feed(node, packets, pose=None, lead_ns: int = 1_000_000) -> None:
    """Feed ``packets`` to ``node`` with an odometry pose (identity unless
    given) stamped ``lead_ns`` after each packet, so that every firing of
    the packet finds a newer transform, then flush the node."""
    pose = np.eye(4) if pose is None else pose
    for stamp, pkt in packets:
        node.on_transform(stamp + lead_ns, pose)
        node.on_raw_data(pkt, stamp)
    node.flush()
