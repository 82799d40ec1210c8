"""Make a minimal rosbag: keep only whitelisted topics (the port's copy of
``continuous_clustering_tpu/tools/make_minimal_rosbag.py``).

The reference ships a script that shrinks recorded bags to the raw packet +
tf topics needed to reproduce a run (dropping cameras and debug topics;
its camera-blur step needs OpenCV and is out of scope here).  This is the
middleware-free analog built on the pure-Python bag reader/writer
(io/rosbag.py): connection headers and stamps are preserved verbatim, so
stock ROS tools can consume the result after `rosbag reindex`.

Usage:
    python -m continuous_clustering_tpu_torch.tools.make_minimal_rosbag \
        in.bag out.bag --topics /sensor/lidar/vls128_roof/raw_data,/tf \
        [--compression bz2]
"""

from __future__ import annotations

import sys

from ..io.rosbag import filter_bag
from ..utils.cli import CommandLineParser


def main(argv=None) -> int:
    p = CommandLineParser(sys.argv[1:] if argv is None else list(argv))
    topics = p.get_value_for_argument("--topics", "")
    compression = p.get_value_for_argument("--compression", "none")
    rest = p.get_remaining_args()
    if len(rest) != 2 or not topics:
        print(__doc__)
        return 2
    src, dst = rest
    counts = filter_bag(src, dst, topics.split(","), compression=compression)
    total = sum(counts.values())
    for t in sorted(counts):
        print(f"  {counts[t]:8d}  {t}")
    print(f"wrote {dst}: {total} messages on {len(counts)} topics")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
