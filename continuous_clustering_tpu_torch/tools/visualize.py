"""Range-image / label visualization dumps (the port's copy of
``continuous_clustering_tpu/tools/visualize.py``).

The reference relies on rviz plugins (range image, continuous point cloud,
colorize-by-label; package.xml:24-27) for visual debugging.  Without a
middleware GUI this tool renders the same debug views to PNG: range image,
ground-point debug labels, and cluster ids over a column range.

The stream runs through the port's ``KittiDemo`` on the card unless
``--device cpu`` names the CPU.

Usage:
    python -m continuous_clustering_tpu_torch.tools.visualize <kitti_folder> <seq> \
        [--frame 0] [--out prefix] [--rows 64] [--columns 2200] [--device cuda|cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..constants import (
    DBG_DARKRED, DBG_GRAY, DBG_GREEN, DBG_LIGHTGRAY, DBG_ORANGE, DBG_RED,
    DBG_VIOLET, DBG_WHITE, DBG_YELLOW, DBG_YELLOWGREEN,
)
from ..utils.cli import CommandLineParser
from .kitti_demo import KittiDemo

# debug label -> RGB, mirroring the reference's QColor-ish palette
DEBUG_COLORS = {
    DBG_WHITE: (255, 255, 255),
    DBG_GRAY: (128, 128, 128),
    DBG_GREEN: (0, 200, 0),
    DBG_YELLOWGREEN: (154, 205, 50),
    DBG_YELLOW: (255, 255, 0),
    DBG_ORANGE: (255, 165, 0),
    DBG_RED: (220, 0, 0),
    DBG_DARKRED: (139, 0, 0),
    DBG_VIOLET: (238, 130, 238),
    DBG_LIGHTGRAY: (200, 200, 200),
}


def _write_png(path: Path, rgb: np.ndarray) -> None:
    """Minimal PNG writer (no external deps)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].astype(np.uint8).tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    path.write_bytes(png)


def render_range_image(distance: np.ndarray, max_range: float = 60.0) -> np.ndarray:
    d = np.nan_to_num(distance, nan=max_range)
    v = (255 * (1.0 - np.clip(d / max_range, 0, 1))).astype(np.uint8)
    return np.stack([v, v, v], axis=-1)


def render_debug_labels(debug: np.ndarray) -> np.ndarray:
    rgb = np.zeros(debug.shape + (3,), np.uint8)
    for label, color in DEBUG_COLORS.items():
        rgb[debug == label] = color
    return rgb


def render_cluster_ids(ids: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(0)
    palette = rng.integers(40, 255, size=(4096, 3), dtype=np.uint8)
    rgb = np.zeros(ids.shape + (3,), np.uint8)
    nz = ids > 0
    rgb[nz] = palette[ids[nz] % 4096]
    return rgb


def dump_state(pipe, from_gcol: int, to_gcol: int, prefix: Path):
    """Render debug views of a column range from a live pipeline."""
    cloud = pipe.get_columns(from_gcol, to_gcol)
    R = pipe.num_rows
    n = to_gcol - from_gcol + 1
    dist = cloud["distance"].reshape(n, R).T
    debug = cloud["debug_ground_point_label"].reshape(n, R).T
    ids = cloud["id"].reshape(n, R).T.astype(np.int64)
    _write_png(Path(f"{prefix}_range.png"), render_range_image(dist))
    _write_png(Path(f"{prefix}_ground.png"), render_debug_labels(debug))
    _write_png(Path(f"{prefix}_clusters.png"), render_cluster_ids(ids))
    return [f"{prefix}_range.png", f"{prefix}_ground.png", f"{prefix}_clusters.png"]


def main(argv=None):
    p = CommandLineParser(argv if argv is not None else sys.argv[1:])
    frame = int(p.get_value_for_argument("--frame", "0"))
    out = p.get_value_for_argument("--out", "cct_debug")
    rows = int(p.get_value_for_argument("--rows", "64"))
    columns = int(p.get_value_for_argument("--columns", "2200"))
    device = p.get_value_for_argument("--device", "") or None
    rest = p.get_remaining_args()
    if len(rest) < 2:
        raise SystemExit("usage: visualize <kitti_folder> <sequence> [--frame N]")

    demo = KittiDemo(
        evaluate=False, delay_between_columns=0, num_rows=rows, num_columns=columns,
        device=device,
    )
    root, seq = Path(rest[0]), rest[1]
    demo.run(root, [seq])

    pipe = demo.last_pipe
    fu = pipe.first_unpublished_global_column_index
    a = max(0, fu - columns) + frame * columns
    b = min(a + columns - 1, fu - 1)
    files = dump_state(pipe, a, b, Path(out))
    print("wrote:", ", ".join(files))
    return files


if __name__ == "__main__":
    main()
