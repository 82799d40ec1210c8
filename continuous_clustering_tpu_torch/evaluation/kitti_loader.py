"""SemanticKITTI odometry dataset loader (the port's copy of
``continuous_clustering_tpu/evaluation/kitti_loader.py``).

NumPy re-derivation of the reference loader
(``src/evaluation/kitti_loader.cpp``): .bin/.label parsing, laser-row
recovery from azimuth wrap-arounds, 64x2200 range-image rasterization with
collision shifting, undo of KITTI's ego-motion correction, pose chains
(poses.txt/calib.txt and raw OXTS), slerp interpolation and timestamp
handling.

Rasterization has two paths and no fallback between them:
``generate_range_image(use_native=True)`` runs the native library's loop
(``csrc/host/kitti.cpp``) and raises when the library cannot be built;
``use_native=False`` is its NumPy twin.  The two compute a point's column
differently: the twin in f32, ``(pi - arctan2(y, x)) / (2 pi / W)``, the
native loop as ``atan2f`` then a division in double (the reference's
formula).  A point near a column boundary can therefore land one column
apart, and the collision shifting that follows in its row passes the move
on to later points of that row; ``tests/test_torch_kitti.py`` holds the two
to exactly that rule.
"""

from __future__ import annotations

import ctypes
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native

NUM_LASERS = 64          # evaluation/kitti_loader.hpp:84
RANGE_IMAGE_WIDTH = 2200  # evaluation/kitti_loader.hpp:86


# ---------------------------------------------------------------- file IO
def load_point_cloud(path) -> np.ndarray:
    """KITTI .bin → structured array (x, y, z, i) (kitti_loader.cpp:12-29)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    out = np.zeros(len(raw), dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"), ("i", "f4")])
    out["x"], out["y"], out["z"], out["i"] = raw.T
    return out


def load_labels(path, num_points: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """SemanticKITTI .label → (semantic u16, instance u16) (…cpp:31-46)."""
    raw = np.fromfile(path, dtype=np.uint16).reshape(-1, 2)
    if num_points is not None and len(raw) != num_points:
        raise ValueError(
            f"Number of points does not match (label/bin): {len(raw)} / {num_points}"
        )
    return raw[:, 0].copy(), raw[:, 1].copy()


def load_flattened(path, dtype) -> np.ndarray:
    return np.fromfile(path, dtype=dtype)


# ------------------------------------------------------- laser index recovery
def recover_laser_indices(
    x: np.ndarray, y: np.ndarray, num_lasers: int = NUM_LASERS
) -> np.ndarray:
    """Row recovery by azimuth wrap-around jumps (…cpp:48-99).

    Rows are ordered top to bottom; a backwards jump of more than 0.7 rad in
    the monotonic azimuth signals the next laser.
    """
    az = np.arctan2(y, x)
    az_mono = np.where(az < 0, az + 2 * math.pi, az)
    jump = np.zeros(len(az), dtype=bool)
    jump[1:] = (az_mono[1:] - az_mono[:-1]) < -0.7
    laser = np.cumsum(jump)
    if laser.size and laser[-1] + 1 != num_lasers:
        # reference only warns here (…cpp:93-95)
        pass
    # points after the last expected row keep the default index (break at …cpp:75-76)
    laser = np.where(laser >= num_lasers, 0, laser)
    return laser.astype(np.int32)


# ------------------------------------------------------------- rasterization
def generate_range_image(
    points: np.ndarray,
    laser: np.ndarray,
    shift_cell_if_already_occupied: bool = True,
    width: int = RANGE_IMAGE_WIDTH,
    num_lasers: int = NUM_LASERS,
    use_native: bool = True,
) -> np.ndarray:
    """Rasterize into (NUM_LASERS * RANGE_IMAGE_WIDTH,) of original indices
    (-1 = empty), with the reference's right-then-left collision shifting
    (…cpp:101-175).  Sequential in file order, as in the reference.
    ``use_native`` runs the native loop (raises when the library cannot be
    built); False runs the NumPy twin (see the module docstring for where
    the two differ)."""
    W = width
    if use_native:
        lib = native.load()
        xyz4 = np.ascontiguousarray(
            np.stack([points["x"], points["y"], points["z"], points["i"]], axis=1),
            np.float32,
        )
        laser_c = np.ascontiguousarray(laser, np.int32)
        out = np.full(num_lasers * W, -1, np.int64)
        lib.cct_generate_range_image(
            len(points),
            xyz4.ctypes.data_as(ctypes.c_void_p),
            laser_c.ctypes.data_as(ctypes.c_void_p),
            W,
            num_lasers,
            1 if shift_cell_if_already_occupied else 0,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out

    az = np.arctan2(points["y"], points["x"])
    col = ((math.pi - az) / (2 * math.pi / W)).astype(np.int64)
    col = np.where(col == W, W - 1, col)

    image = np.full(num_lasers * W, -1, dtype=np.int64)
    flat = laser.astype(np.int64) * W + col

    if not shift_cell_if_already_occupied:
        image[flat] = np.arange(len(points))
        return image

    # collision shifting is order-dependent (a shifted point can occupy a
    # later point's cell), so the exact path is a plain sequential loop
    for idx in range(len(points)):
        f = flat[idx]
        c = col[idx]
        if image[f] >= 0:
            if c + 1 < W and image[f + 1] < 0:
                f = f + 1
            elif c - 1 >= 0 and image[f - 1] < 0:
                f = f - 1
        image[f] = idx
    return image


# -------------------------------------------------------- ego motion undo
def undo_ego_motion_correction(
    points: np.ndarray,
    rotation_start_stamp: int,
    rotation_end_stamp: int,
    odom_from_velo_mid: np.ndarray,
    odom_from_velo: List["StampedPose"],
) -> None:
    """In-place inverse of KITTI's ego-motion correction (…cpp:177-210)."""
    bin_res = 1_000_000  # 1 ms
    duration = rotation_end_stamp - rotation_start_stamp
    num_bins = int(math.ceil(duration / bin_res))
    mats = np.zeros((num_bins, 3, 4))
    for b in range(num_bins):
        stamp = rotation_start_stamp + b * bin_res + bin_res // 2
        pose = interpolate(odom_from_velo, stamp).pose
        m = np.linalg.inv(pose) @ odom_from_velo_mid
        mats[b] = m[:3, :]

    frac = (math.pi - np.arctan2(points["y"], points["x"])) / (2 * math.pi)
    b = ((frac * duration) / bin_res).astype(np.int64)
    b = np.clip(b, 0, num_bins - 1)
    xyz = np.stack([points["x"], points["y"], points["z"], np.ones(len(points))], axis=1)
    new = np.einsum("nij,nj->ni", mats[b], xyz)
    points["x"] = new[:, 0].astype(np.float32)
    points["y"] = new[:, 1].astype(np.float32)
    points["z"] = new[:, 2].astype(np.float32)


# ------------------------------------------------------------------- poses
@dataclass
class StampedPose:
    stamp: int
    pose: np.ndarray  # 4x4


def interpolate(transforms: List[StampedPose], stamp: int) -> StampedPose:
    """Slerp pose interpolation (…cpp:297-328)."""
    stamps = [t.stamp for t in transforms]
    i = np.searchsorted(stamps, stamp, side="left")
    if i >= len(transforms):
        return StampedPose(stamp, transforms[-1].pose)
    if i == 0:
        return StampedPose(stamp, transforms[0].pose)
    before, after = transforms[i - 1], transforms[i]
    q0 = _mat_to_quat(before.pose[:3, :3])
    q1 = _mat_to_quat(after.pose[:3, :3])
    return StampedPose(stamp, slerp_pose(stamp, before, q0, after, q1))


def slerp_pose(stamp: int, before: StampedPose, q0: np.ndarray, after: StampedPose,
               q1: np.ndarray) -> np.ndarray:
    """The 4x4 pose at ``stamp`` between ``before`` and ``after`` (stamped
    ``before.stamp < stamp <= after.stamp``), whose rotations' quaternions
    are ``q0`` and ``q1`` (``_mat_to_quat``): slerp of the rotation, linear
    translation."""
    f = (stamp - before.stamp) / (after.stamp - before.stamp)
    q = _slerp(q0, q1, f)
    t = (1 - f) * before.pose[:3, 3] + f * after.pose[:3, 3]
    pose = np.eye(4)
    pose[:3, :3] = _quat_to_mat(q)
    pose[:3, 3] = t
    return pose


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _slerp(q0: np.ndarray, q1: np.ndarray, f: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + f * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = math.acos(np.clip(d, -1, 1))
    return (math.sin((1 - f) * theta) * q0 + math.sin(f * theta) * q1) / math.sin(theta)


def get_static_transform_and_projection_matrices(calib_path):
    """calib.txt: P0..P3 + Tr (cam0_from_velodyne) (…cpp:371-419)."""
    mats = []
    with open(calib_path) as fh:
        for line in fh:
            v = line.split()
            m = np.eye(4)
            m[:3, :4] = np.array([float(x) for x in v[1:13]]).reshape(3, 4)
            mats.append(m)
    projections = mats[:4]
    tf_cam0_from_velodyne = mats[4]
    return tf_cam0_from_velodyne, projections


def get_all_dynamic_transforms(
    poses_path, timestamps: List[int], tf_cam0_from_x: np.ndarray
) -> List[StampedPose]:
    """poses.txt → odom_from_x chain (…cpp:330-369)."""
    tf_odom_from_first_cam0 = np.eye(4)
    tf_odom_from_first_cam0[:3, :3] = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    poses = []
    with open(poses_path) as fh:
        for i, line in enumerate(fh):
            if timestamps and i >= len(timestamps):
                break
            v = [float(x) for x in line.split()]
            m = np.eye(4)
            m[:3, :4] = np.array(v).reshape(3, 4)
            tf = tf_odom_from_first_cam0 @ m @ tf_cam0_from_x
            poses.append(StampedPose(timestamps[i] if timestamps else 0, tf))
    if timestamps and len(poses) != len(timestamps):
        raise ValueError(
            "The number of poses (i.e. lines in poses.txt) does not match "
            "with number of timestamps."
        )
    return poses


def load_timestamps(path, make_fake_absolute: bool = False) -> List[int]:
    """times.txt (relative seconds) → ns stamps (…cpp:504-529)."""
    fake_start = time.time_ns() if make_fake_absolute else 0
    out = []
    with open(path) as fh:
        for line in fh:
            out.append(fake_start + int(float(line) * 1_000_000_000))
    return out


def get_start_end_timestamps(middle: List[int]) -> Tuple[List[int], List[int]]:
    """±50 ms rotation bounds (…cpp:531-546)."""
    n = len(middle)
    start, end = [0] * n, [0] * n
    for i in range(n - 1):
        end[i] = (middle[i] + middle[i + 1]) // 2
        start[i + 1] = end[i]
    start[0] = middle[0] - 50_000_000
    end[-1] = middle[-1] + 50_000_000
    return start, end


# ----------------------------------------------------------- raw (OXTS) path
@dataclass
class Oxts:
    stamp: int
    lat: float
    lon: float
    alt: float
    roll: float
    pitch: float
    yaw: float
    vn: float
    ve: float
    vf: float


def load_single_oxford_measurement(path) -> Oxts:
    """(…cpp:212-236)."""
    with open(path) as fh:
        v = fh.readline().split()
    return Oxts(
        0, float(v[0]), float(v[1]), float(v[2]), float(v[3]), float(v[4]),
        float(v[5]), float(v[8]), float(v[9]), float(v[10]),
    )


def convert_oxford_measurement_to_pose(o: Oxts, scale: float) -> np.ndarray:
    """Mercator + Euler angles (…cpp:238-259)."""
    earth_radius = 6378137.0
    tx = scale * earth_radius * math.pi * o.lon / 180.0
    ty = scale * earth_radius * math.log(math.tan(math.pi * (90.0 + o.lat) / 360.0))
    cz, sz = math.cos(o.yaw), math.sin(o.yaw)
    cy, sy = math.cos(o.pitch), math.sin(o.pitch)
    cx, sx = math.cos(o.roll), math.sin(o.roll)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    pose = np.eye(4)
    pose[:3, :3] = rz @ ry @ rx
    pose[:3, 3] = [tx, ty, o.alt]
    return pose


def load_timestamps_raw(path) -> List[int]:
    """Raw-dataset datetime timestamps → ns (…cpp:464-502)."""
    import datetime

    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            date, timepart = line.split(" ")
            hms, frac = timepart.split(".")
            if len(frac) != 9:
                raise ValueError(f"Fractional seconds are not nanoseconds: {line}")
            dt = datetime.datetime.strptime(f"{date} {hms}", "%Y-%m-%d %H:%M:%S")
            out.append(int(dt.timestamp()) * 1_000_000_000 + int(frac))
    return out


def get_all_dynamic_transforms_raw(
    oxford_folder, first_frame: int, last_frame: int, tf_oxford_from_x: np.ndarray
) -> List[StampedPose]:
    """Raw OXTS folder → odom_from_x transforms (…cpp:261-284)."""
    oxford_folder = Path(oxford_folder)
    stamps = load_timestamps_raw(oxford_folder / "timestamps.txt")
    scale = 0.0
    out = []
    for frame in range(first_frame, last_frame + 1):
        o = load_single_oxford_measurement(
            oxford_folder / "data" / f"{frame:010d}.txt"
        )
        if scale == 0.0:
            scale = math.cos(o.lat * math.pi / 180.0)
        pose = convert_oxford_measurement_to_pose(o, scale) @ tf_oxford_from_x
        out.append(StampedPose(stamps[frame], pose))
    return out


def make_transforms_relative_to_first(transforms: List[StampedPose]) -> List[StampedPose]:
    first_inv = np.linalg.inv(transforms[0].pose)
    return [StampedPose(t.stamp, first_inv @ t.pose) for t in transforms]


def load_static_transform(path) -> np.ndarray:
    """calib_imu_to_velo.txt / calib_velo_to_cam.txt (…cpp:421-452)."""
    with open(path) as fh:
        fh.readline()  # meta line
        r = [float(x) for x in fh.readline().split()[1:10]]
        t = [float(x) for x in fh.readline().split()[1:4]]
    m = np.eye(4)
    m[:3, :3] = np.array(r).reshape(3, 3)
    m[:3, 3] = t
    return m


# ------------------------------------------------------------------- mappings
@dataclass
class RawSequenceSubset:
    date: str
    drive: str
    start: int
    end: int


def kitti_odometry_to_raw_mapping() -> Dict[int, RawSequenceSubset]:
    """(…cpp:548-564)."""
    return {
        0: RawSequenceSubset("2011_10_03", "2011_10_03_drive_0027_sync", 0, 4540),
        1: RawSequenceSubset("2011_10_03", "2011_10_03_drive_0042_sync", 0, 1100),
        2: RawSequenceSubset("2011_10_03", "2011_10_03_drive_0034_sync", 0, 4660),
        3: RawSequenceSubset("2011_09_26", "2011_09_26_drive_0067_sync", 0, 800),
        4: RawSequenceSubset("2011_09_30", "2011_09_30_drive_0016_sync", 0, 270),
        5: RawSequenceSubset("2011_09_30", "2011_09_30_drive_0018_sync", 0, 2760),
        6: RawSequenceSubset("2011_09_30", "2011_09_30_drive_0020_sync", 0, 1100),
        7: RawSequenceSubset("2011_09_30", "2011_09_30_drive_0027_sync", 0, 1100),
        8: RawSequenceSubset("2011_09_30", "2011_09_30_drive_0028_sync", 1100, 5170),
        9: RawSequenceSubset("2011_09_30", "2011_09_30_drive_0033_sync", 0, 1590),
        10: RawSequenceSubset("2011_09_30", "2011_09_30_drive_0034_sync", 0, 1200),
    }


SEMANTIC_KITTI_LABELS: Dict[int, str] = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
    15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
    30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
    44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
    51: "fence", 52: "other-structure", 60: "lane-marking", 70: "vegetation",
    71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
    99: "other-object", 252: "moving-car", 253: "moving-bicyclist",
    254: "moving-person", 255: "moving-motorcyclist", 256: "moving-on-rails",
    257: "moving-bus", 258: "moving-truck", 259: "moving-other-vehicle",
}

LABEL_NAME_TO_ID = {v: k for k, v in SEMANTIC_KITTI_LABELS.items()}

GROUND_LABEL_IDS = frozenset(
    LABEL_NAME_TO_ID[n]
    for n in ("lane-marking", "road", "parking", "sidewalk", "other-ground", "terrain")
)
UNLABELED_ID = LABEL_NAME_TO_ID["unlabeled"]
