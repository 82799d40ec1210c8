"""gt_label_generator — offline euclidean-clustering GT label generation (the
port's copy of ``continuous_clustering_tpu/tools/gt_label_generator.py``).

Mirrors the reference tool (``src/tools/gt_label_generator_tool.cpp``): per
frame loads cloud + SemanticKITTI labels, runs conditional euclidean
clustering and writes ``labels_euclidean_clustering/XXXXXX.label`` (uint16
stream).  ``--num-threads N`` parallelizes over frames in a process pool.

Usage:
    python -m continuous_clustering_tpu_torch.tools.gt_label_generator \
        <kitti_folder> [sequences...] [--num-threads N] [--zip OUT.zip]

``--zip`` additionally archives every ``labels_euclidean_clustering``
directory under ``dataset/sequences/<seq>/…`` — the same layout the
reference's ``scripts/zip_euclidean_clustering_labels.sh`` produces for
sharing generated ground truth.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import sys
import zipfile
from pathlib import Path

import numpy as np

from ..evaluation import kitti_loader as kl
from ..evaluation.euclidean_clustering import generate_euclidean_clustering_labels
from ..utils.cli import CommandLineParser


def process_single_frame(seq_dir: Path, frame: int) -> str:
    points = kl.load_point_cloud(seq_dir / "velodyne" / f"{frame:06d}.bin")
    semantic, instance = kl.load_labels(
        seq_dir / "labels" / f"{frame:06d}.label", len(points)
    )
    xyz = np.stack([points["x"], points["y"], points["z"]], axis=1)
    labels = generate_euclidean_clustering_labels(xyz, semantic, instance)
    out_dir = seq_dir / "labels_euclidean_clustering"
    out_dir.mkdir(exist_ok=True)
    out = out_dir / f"{frame:06d}.label"
    labels.astype(np.uint16).tofile(out)
    return str(out)


def zip_generated_labels(root: Path, sequences, out_zip: Path) -> int:
    """Archive labels_euclidean_clustering dirs as dataset/sequences/<seq>/…
    (reference scripts/zip_euclidean_clustering_labels.sh layout).  Returns
    the number of label files archived."""
    n = 0
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for sequence in sequences:
            lbl_dir = root / sequence / "labels_euclidean_clustering"
            if not lbl_dir.is_dir():
                continue
            for f in sorted(lbl_dir.glob("*.label")):
                zf.write(
                    f,
                    f"dataset/sequences/{sequence}/"
                    f"labels_euclidean_clustering/{f.name}",
                )
                n += 1
    return n


def main(argv=None):
    parser = CommandLineParser(argv if argv is not None else sys.argv[1:])
    num_threads = int(parser.get_value_for_argument("--num-threads", "1"))
    zip_out = parser.get_value_for_argument("--zip", "")
    rest = parser.get_remaining_args()
    if not rest:
        raise SystemExit("usage: gt_label_generator <kitti_folder> [sequences...]")
    root = Path(rest[0])
    sequences = rest[1:] or sorted(p.name for p in root.iterdir() if p.is_dir())

    jobs = []
    for sequence in sequences:
        seq_dir = root / sequence
        frames = sorted(int(p.stem) for p in (seq_dir / "velodyne").glob("*.bin"))
        for frame in frames:
            jobs.append((seq_dir, frame))

    if num_threads > 1:
        # spawned, not forked: the caller may hold threads (torch's, JAX's)
        # whose locks a forked child would inherit
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(max_workers=num_threads,
                                                    mp_context=ctx) as ex:
            for out in ex.map(process_single_frame, *zip(*jobs)):
                print(out)
    else:
        for seq_dir, frame in jobs:
            print(process_single_frame(seq_dir, frame))

    if zip_out:
        n = zip_generated_labels(root, sequences, Path(zip_out))
        print(f"archived {n} label files to {zip_out}")


if __name__ == "__main__":
    main()
