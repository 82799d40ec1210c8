"""kitti_demo — no-middleware CLI entry point and evaluation harness (the
port's copy of ``continuous_clustering_tpu/tools/kitti_demo.py``).

Mirrors the reference tool (``src/tools/kitti_demo.cpp``): per sequence it
loads clouds/labels/poses, undoes ego-motion correction, rasterizes the
64x2200 range image, streams each column as a pseudo-firing with an
interpolated pose into the pipeline, and evaluates ground segmentation and
clustering (OSE/USE) against SemanticKITTI + euclidean-clustering GT labels.

The pipeline is the port's ``ContinuousClustering`` on the card unless the
CPU is named (``--device cpu``), with host insertion unless
``--insertion device`` is given; every step runs K1 and K2.  Each point's
u64 index (sequence << 48 | frame << 32 | point) crosses the facade as its
two 32-bit halves and comes back through ``get_columns``.  The range image
is rasterized natively (the reference's column formula) unless
``use_native=False`` asks for the NumPy twin, which computes columns in f32
as the JAX tool does when its native library is absent.

Usage:
    python -m continuous_clustering_tpu_torch.tools.kitti_demo <kitti_folder> \
        [sequences...] [--evaluate | --evaluate-fast] \
        [--delay-between-columns us] [--firing-batch N] [--rows N] [--columns N] \
        [--device cuda|cpu] [--insertion host|device]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..config import kitti_config
from ..constants import GP_GROUND
from ..evaluation import kitti_loader as kl
from ..evaluation.euclidean_clustering import generate_euclidean_clustering_labels
from ..evaluation.kitti_evaluation import KittiEvaluation
from ..models.continuous_clustering import ContinuousClustering
from ..utils.cli import CommandLineParser
from ..utils.platform import resolve_device

U64_MAX = np.iinfo(np.uint64).max


class KittiDemo:
    def __init__(
        self,
        evaluate=False,
        delay_between_columns=2000,
        firing_batch=256,
        num_rows=kl.NUM_LASERS,
        num_columns=kl.RANGE_IMAGE_WIDTH,
        device=None,
        insertion="host",
        use_native=True,
    ):
        self.evaluate = evaluate
        self.delay_between_columns = delay_between_columns
        self.firing_batch = firing_batch
        self.num_rows = num_rows
        self.num_columns = num_columns
        self.device = resolve_device(device)
        self.insertion = insertion
        self.use_native = use_native
        self.evaluation = KittiEvaluation()
        # (sequence, frame) -> dict of per-point GT/detection arrays
        self.frames: Dict[Tuple[int, int], dict] = {}
        self.current_sequence = 0
        self.previous_frame = 0

    # -- evaluation plumbing (reference kitti_demo.cpp:161-224) ------------
    def _evaluate_previous_frame(self):
        key = (self.current_sequence, self.previous_frame)
        fr = self.frames.pop(key)
        self.evaluation.evaluate_frame(
            fr["semantic"],
            fr["is_ground"],
            fr["euclid"],
            fr["det"],
            self.current_sequence,
        )
        self.previous_frame += 1

    def _on_finished_columns(self, pipe, from_gcol, to_gcol):
        cloud = pipe.get_columns(from_gcol, to_gcol)
        R = pipe.num_rows
        n_cols = to_gcol - from_gcol + 1
        uidx = cloud["globally_unique_point_index"].reshape(n_cols, R)
        ids = cloud["id"].reshape(n_cols, R)
        glab = cloud["ground_point_label"].reshape(n_cols, R)
        for c in range(n_cols):
            valid = uidx[c] != U64_MAX
            u, i, gl = uidx[c][valid], ids[c][valid], glab[c][valid]
            if not len(u):
                continue
            seq = ((u >> np.uint64(48)) & np.uint64(0xFFFF)).astype(np.int64)
            frame = ((u >> np.uint64(32)) & np.uint64(0xFFFF)).astype(np.int64)
            pidx = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
            if np.any(frame < self.previous_frame):
                raise RuntimeError(
                    "Found a point belonging to a frame that was already evaluated!"
                )
            if np.any(frame > self.previous_frame + 1):
                raise RuntimeError("Found a point whose frame is too far ahead!")
            for s, f in set(zip(seq.tolist(), frame.tolist())):
                sel = (seq == s) & (frame == f)
                fr = self.frames[(s, f)]
                fr["is_ground"][pidx[sel]] = gl[sel] == GP_GROUND
                fr["det"][pidx[sel]] = i[sel]
                fr["has_det"][pidx[sel]] = True
            if np.any(frame == self.previous_frame + 1):
                self._evaluate_previous_frame()

    # -- main loop (reference kitti_demo.cpp:227-438) ----------------------
    def run(self, root: Path, sequences):
        execution_durations = []
        for sequence in sequences:
            t_start = time.perf_counter()
            seq_idx = int(sequence)
            seq_dir = root / f"{seq_idx:02d}"
            print(f"RUN SEQUENCE: {seq_idx}")

            velodyne = seq_dir / "velodyne"
            labels_dir = seq_dir / "labels"
            euclid_dir = seq_dir / "labels_euclidean_clustering"

            stamps_mid = kl.load_timestamps(seq_dir / "times.txt", make_fake_absolute=True)
            stamps_start, stamps_end = kl.get_start_end_timestamps(stamps_mid)
            tf_cam0_from_velo, _ = kl.get_static_transform_and_projection_matrices(
                seq_dir / "calib.txt"
            )
            transforms = kl.get_all_dynamic_transforms(
                seq_dir / "poses.txt", stamps_mid, tf_cam0_from_velo
            )

            cfg = kitti_config()
            if self.num_columns != cfg.range_image.num_columns:
                cfg = cfg.replace(
                    range_image=cfg.range_image.__class__(num_columns=self.num_columns)
                )
            pipe = ContinuousClustering(cfg, firing_batch_size=self.firing_batch,
                                        device=self.device, insertion=self.insertion)
            self.last_pipe = pipe  # exposed for debugging/visualization
            pipe.reset(self.num_rows)
            pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
            if self.evaluate:
                pipe.set_finished_column_callback(
                    lambda a, b, ground_only: None
                    if ground_only
                    else self._on_finished_columns(pipe, a, b)
                )

            self.current_sequence = seq_idx
            self.previous_frame = 0
            if self.evaluate and not labels_dir.exists():
                print("SemanticKitti labels were not found -> Don't evaluate this sequence.")
                continue

            num_frames = len(stamps_mid)
            for frame in range(num_frames):
                print(f"RUN SEQUENCE: {seq_idx}, FRAME: {frame}")
                points = kl.load_point_cloud(velodyne / f"{frame:06d}.bin")

                if self.evaluate:
                    semantic, instance = kl.load_labels(
                        labels_dir / f"{frame:06d}.label", len(points)
                    )
                    cache = euclid_dir / f"{frame:06d}.label"
                    if cache.exists():
                        euclid = kl.load_flattened(cache, np.uint16)
                    else:
                        xyz = np.stack([points["x"], points["y"], points["z"]], axis=1)
                        euclid = generate_euclidean_clustering_labels(
                            xyz, semantic, instance
                        )
                    self.frames[(seq_idx, frame)] = dict(
                        semantic=semantic,
                        euclid=euclid.astype(np.uint32),
                        det=np.zeros(len(points), np.uint32),
                        is_ground=np.zeros(len(points), bool),
                        has_det=np.zeros(len(points), bool),
                    )

                laser = kl.recover_laser_indices(
                    points["x"], points["y"], num_lasers=self.num_rows
                )
                kl.undo_ego_motion_correction(
                    points,
                    stamps_start[frame],
                    stamps_end[frame],
                    transforms[frame].pose,
                    transforms,
                )
                image = kl.generate_range_image(
                    points, laser, width=self.num_columns, num_lasers=self.num_rows,
                    use_native=self.use_native,
                )

                W, R = self.num_columns, self.num_rows
                img2d = image.reshape(R, W)
                duration = stamps_end[frame] - stamps_start[frame]
                for col in range(W):
                    ratio = col / (W - 1)
                    stamp = stamps_start[frame] + int(duration * ratio)
                    src = img2d[:, col]
                    ok = src >= 0
                    xyz = np.full((R, 3), np.nan, np.float32)
                    xyz[ok, 0] = points["x"][src[ok]]
                    xyz[ok, 1] = points["y"][src[ok]]
                    xyz[ok, 2] = points["z"][src[ok]]
                    uidx = np.full(R, U64_MAX, np.uint64)
                    uidx[ok] = (
                        (np.uint64(seq_idx) << np.uint64(48))
                        | (np.uint64(frame) << np.uint64(32))
                        | src[ok].astype(np.uint64)
                    )
                    inten = np.zeros(R, np.uint8)
                    inten[ok] = (points["i"][src[ok]] * 255).astype(np.uint8)
                    firing = {
                        "xyz": xyz,
                        "stamp": np.full(R, stamp, np.uint64),
                        "intensity": inten,
                        "firing_index": col,
                        "uidx": uidx,
                    }
                    pose = kl.interpolate(transforms, stamp).pose
                    pipe.add_firing(firing, pose)
                    if self.delay_between_columns > 0:
                        time.sleep(self.delay_between_columns / 1e6)

            pipe.flush()
            if self.evaluate:
                self._evaluate_previous_frame()
                self.frames.clear()

            dt = time.perf_counter() - t_start
            execution_durations.append(dt)
            print(f"Execution time: {dt:.5f}")

        output = self.evaluation.generate_evaluation_results()
        print(output)
        with open("evaluation_results.txt", "w") as fh:
            fh.write(output)
            fh.write("\n\nExecution Duration per Sequence:\n")
            for seq, dt in zip(sequences, execution_durations):
                fh.write(f"Sequence {seq}: {dt:.5f}\n")


def main(argv=None):
    parser = CommandLineParser(argv if argv is not None else sys.argv[1:])
    if parser.argument_exists("--help") or parser.argument_exists("-h"):
        print(
            "usage: kitti_demo <kitti_folder> [sequences...]\n"
            "  --evaluate               run the OSE/USE + ground evaluation\n"
            "  --evaluate-fast          evaluate with zero column delay\n"
            "  --delay-between-columns N  pacing in microseconds (default 2000)\n"
            "  --firing-batch N         firings per device batch (default 256)\n"
            "  --rows N --columns N     range image shape (default 64x2200)\n"
            "  --device NAME            torch device (default: the card)\n"
            "  --insertion host|device  insertion path (default host)"
        )
        return None
    evaluate = parser.argument_exists("--evaluate")
    delay = int(parser.get_value_for_argument("--delay-between-columns", "2000"))
    firing_batch = int(parser.get_value_for_argument("--firing-batch", "256"))
    rows = int(parser.get_value_for_argument("--rows", str(kl.NUM_LASERS)))
    columns = int(parser.get_value_for_argument("--columns", str(kl.RANGE_IMAGE_WIDTH)))
    device = parser.get_value_for_argument("--device", "") or None
    insertion = parser.get_value_for_argument("--insertion", "host")
    if parser.argument_exists("--evaluate-fast"):
        evaluate = True
        delay = 0

    rest = parser.get_remaining_args()
    for token in rest:
        if token.startswith("-"):
            raise RuntimeError(f"Unknown argument: {token}")
    if not rest:
        raise SystemExit("usage: kitti_demo <kitti_folder> [sequences...]")

    root = Path(rest[0])
    if len(rest) == 1:
        sequences = sorted(p.name for p in root.iterdir() if p.is_dir())
        print(f"Run all sequences in: {root}")
    else:
        sequences = rest[1:]
        print(f"Run sequences: {sequences}")

    demo = KittiDemo(
        evaluate=evaluate,
        delay_between_columns=delay,
        firing_batch=firing_batch,
        num_rows=rows,
        num_columns=columns,
        device=device,
        insertion=insertion,
    )
    demo.run(root, sequences)
    return demo


if __name__ == "__main__":
    main()
