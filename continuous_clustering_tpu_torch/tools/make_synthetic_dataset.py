"""Write a synthetic SemanticKITTI-shaped dataset from ray-cast scenes (the
port's copy of ``continuous_clustering_tpu/tools/make_synthetic_dataset.py``).

Produces ``<root>/<seq>/velodyne/*.bin``, ``labels/*.label``, ``times.txt``,
``calib.txt``, ``poses.txt`` so the full kitti_demo path (loader, ego-motion
undo, rasterization, evaluation) can run without the real dataset.  Points
are stored in KITTI's convention: row-major by laser (top row first), sorted
within a row by monotonic azimuth, NaN returns omitted
(see recoverLaserIndices, src/evaluation/kitti_loader.cpp:48-99).

    python -m continuous_clustering_tpu_torch.tools.make_synthetic_dataset \
        <root> [--sequence 00] [--frames 3] [--boxes 10] [--rows 64] \
        [--columns 2200] [--seed 0] [--speed 0]
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np

from ..evaluation.synthetic import hdl64_inclinations, make_scene, raycast_frame


def write_sequence(
    root: Path,
    sequence: str = "00",
    num_frames: int = 3,
    num_boxes: int = 10,
    seed: int = 0,
    num_rows: int = 64,
    num_columns: int = 2200,
    speed_mps: float = 0.0,
):
    seq_dir = root / sequence
    (seq_dir / "velodyne").mkdir(parents=True, exist_ok=True)
    (seq_dir / "labels").mkdir(parents=True, exist_ok=True)

    scene = make_scene(num_boxes=num_boxes, seed=seed, spread=30.0)
    inclinations = hdl64_inclinations(num_rows)

    times = [0.1 * (i + 1) for i in range(num_frames)]
    with open(seq_dir / "times.txt", "w") as fh:
        for t in times:
            fh.write(f"{t:.6f}\n")

    # calib: identity Tr (velodyne == cam0), dummy projections
    with open(seq_dir / "calib.txt", "w") as fh:
        ident = "1 0 0 0 0 1 0 0 0 0 1 0"
        for name in ("P0", "P1", "P2", "P3", "Tr"):
            fh.write(f"{name}: {ident}\n")

    # poses.txt: first_cam0_from_cam0 rows; with Tr = I and the fixed
    # odom_from_first_cam0 axis swap (kitti_loader.cpp:339-340), a forward
    # ego motion of +x in odom means +z in cam0 coordinates
    tf_odom_from_first_cam0 = np.eye(4)
    tf_odom_from_first_cam0[:3, :3] = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    inv_axis = np.linalg.inv(tf_odom_from_first_cam0)
    with open(seq_dir / "poses.txt", "w") as fh:
        for i, t in enumerate(times):
            odom_from_velo = np.eye(4)
            odom_from_velo[0, 3] = speed_mps * t
            line_mat = inv_axis @ odom_from_velo
            vals = line_mat[:3, :].reshape(-1)
            fh.write(" ".join(f"{v:.9f}" for v in vals) + "\n")

    for frame in range(num_frames):
        origin = (speed_mps * times[frame], 0.0, 0.0)
        xyz, inst = raycast_frame(
            scene,
            num_rows=num_rows,
            num_columns=num_columns,
            sensor_origin=origin,
            inclinations=inclinations,
            seed=seed + frame,
        )
        # raycast_frame casts from the origin but returns odom-frame points;
        # store them in the sensor frame
        pts = xyz.astype(np.float64)
        pts[..., 0] -= origin[0]
        pts[..., 1] -= origin[1]
        pts[..., 2] -= origin[2]

        rows_out = []
        labels_out = []
        for r in range(num_rows):
            p = pts[:, r, :]
            lab = inst[:, r]
            ok = ~np.isnan(p[:, 0])
            p, lab = p[ok], lab[ok]
            az = np.arctan2(p[:, 1], p[:, 0])
            az_mono = np.where(az < 0, az + 2 * math.pi, az)
            order = np.argsort(az_mono, kind="stable")
            rows_out.append(p[order])
            labels_out.append(lab[order])
        allp = np.concatenate(rows_out)
        alll = np.concatenate(labels_out)

        bin_data = np.zeros((len(allp), 4), np.float32)
        bin_data[:, :3] = allp
        bin_data[:, 3] = 0.5
        bin_data.tofile(seq_dir / "velodyne" / f"{frame:06d}.bin")

        semantic = np.where(alll == -1, 40, np.where(alll > 0, 10, 0)).astype(np.uint16)
        instance = np.where(alll > 0, alll, 0).astype(np.uint16)
        lab = np.stack([semantic, instance], axis=1).astype(np.uint16)
        lab.tofile(seq_dir / "labels" / f"{frame:06d}.label")

    return seq_dir


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root", type=Path)
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--boxes", type=int, default=10)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--columns", type=int, default=2200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speed", type=float, default=0.0)
    a = ap.parse_args()
    out = write_sequence(
        a.root, a.sequence, a.frames, a.boxes, a.seed, a.rows, a.columns, a.speed
    )
    print(f"wrote synthetic sequence to {out}")


if __name__ == "__main__":
    main()
