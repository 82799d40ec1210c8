"""Velodyne calibration loading (the port's copy of
``continuous_clustering_tpu/sensors/velodyne_calibration.py``).

The reference consumes velodyne_pointcloud-style YAML calibrations
(ros/velodyne_input.hpp uses the vendored RawData parser with a calibration
path).  This parses the same schema — ``lasers: [{laser_id, vert_correction,
rot_correction, dist_correction, ...}]`` (angles in radians) — into the
arrays ``VelodyneInput`` takes, with built-in fallbacks per model.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import numpy as np

# built-in vertical angle tables (degrees, laser-id order)
BUILTIN_VERT_ANGLES: Dict[str, list] = {
    "VLP16": [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15],
    "HDL32": [
        -30.67, -9.33, -29.33, -8.0, -28.0, -6.66, -26.66, -5.33, -25.33, -4.0,
        -24.0, -2.67, -22.67, -1.33, -21.33, 0.0, -20.0, 1.33, -18.67, 2.67,
        -17.33, 4.0, -16.0, 5.33, -14.67, 6.67, -13.33, 8.0, -12.0, 9.33,
        -10.67, 10.67,
    ],
}


def load_calibration(path) -> Dict[str, np.ndarray]:
    """Parse a velodyne_pointcloud calibration YAML.

    Returns dict with vert_angles_deg, azimuth_offsets_deg, rings
    (keyed the way VelodyneInput expects).
    """
    try:
        import yaml
    except ImportError:  # minimal fallback parser for the flat schema
        return _parse_minimal(Path(path).read_text())

    data = yaml.safe_load(Path(path).read_text())
    lasers = sorted(data["lasers"], key=lambda l: l["laser_id"])
    vert = np.array([math.degrees(l["vert_correction"]) for l in lasers])
    rot = np.array([math.degrees(l.get("rot_correction", 0.0)) for l in lasers])
    rings = np.argsort(np.argsort(vert)).astype(np.int32)

    def _term(key):
        return np.array([float(l.get(key, 0.0)) for l in lasers], np.float32)

    return {
        "vert_angles_deg": vert,
        "azimuth_offsets_deg": rot,
        "rings": rings,
        "num_lasers": len(lasers),
        # velodyne_pointcloud correction terms (meters), zeros if absent
        "dist_corrections_m": _term("dist_correction"),
        "dist_corrections_x_m": _term("dist_correction_x"),
        "dist_corrections_y_m": _term("dist_correction_y"),
        "vert_offsets_m": _term("vert_offset_correction"),
        "horiz_offsets_m": _term("horiz_offset_correction"),
        "two_pt": np.array(
            [int(bool(l.get("two_pt_correction_available", False))) for l in lasers],
            np.uint8,
        ),
    }


def _parse_minimal(text: str) -> Dict[str, np.ndarray]:
    """Line-based parse of the flat 'lasers:' list (no YAML dependency)."""
    import re

    entries = []
    current = {}
    for line in text.splitlines():
        m = re.search(r"(laser_id|vert_correction|rot_correction)\s*:\s*([-\d.eE]+)", line)
        if not m:
            continue
        key, val = m.group(1), float(m.group(2))
        if key == "laser_id" and "laser_id" in current:
            entries.append(current)
            current = {}
        current[key] = val
    if current:
        entries.append(current)
    entries.sort(key=lambda e: e.get("laser_id", 0))
    vert = np.array([math.degrees(e.get("vert_correction", 0.0)) for e in entries])
    rot = np.array([math.degrees(e.get("rot_correction", 0.0)) for e in entries])
    return {
        "vert_angles_deg": vert,
        "azimuth_offsets_deg": rot,
        "rings": np.argsort(np.argsort(vert)).astype(np.int32),
        "num_lasers": len(entries),
    }


def builtin(model: str) -> Dict[str, np.ndarray]:
    vert = np.array(BUILTIN_VERT_ANGLES[model.upper()], dtype=np.float64)
    return {
        "vert_angles_deg": vert,
        "azimuth_offsets_deg": np.zeros(len(vert)),
        "rings": np.argsort(np.argsort(vert)).astype(np.int32),
        "num_lasers": len(vert),
    }
