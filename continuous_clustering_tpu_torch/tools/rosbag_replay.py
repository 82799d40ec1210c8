"""Replay raw LiDAR packets from a ROS1 bag into the clustering node (the
port's counterpart of ``continuous_clustering_tpu/tools/rosbag_replay.py``).

The reference's hardware-free demo is ``rosbag play`` into the ROS node
(reference README.md:111-135); this is the same workflow with no ROS: the
bag's raw-packet messages (velodyne_msgs/VelodyneScan or
ouster_ros/PacketMsg) feed ``ClusteringNode.on_raw_data`` directly, with
identity odometry unless a tf topic is wired by the caller.  The node runs
on the card unless ``--device cpu`` (``device="cpu"``) names the CPU.

Usage:
    python -m continuous_clustering_tpu_torch.tools.rosbag_replay <bag> \
        [--topic /bus/vls128_roof/eth_scan/bus_to_host] \
        [--sensor velodyne|ouster] [--num-lasers N] \
        [--ouster-metadata path.json] [--num-columns N] [--limit N] \
        [--device cuda|cpu]

Prints one line per published cluster range plus a final summary.
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import Config, RangeImageConfig
from ..io.node import ClusteringNode
from ..io.rosbag import decode_ouster_packet, decode_velodyne_scan, read_messages
from ..utils.cli import CommandLineParser


def replay(
    bag_path,
    topic=None,
    sensor="velodyne",
    sensor_kwargs=None,
    num_columns=1700,
    limit=None,
    node=None,
    device=None,
):
    """Feed a bag's packets through a ClusteringNode (made on ``device``, the
    card unless the CPU is named, when none is given); returns stats dict."""
    if node is None:
        cfg = Config().replace(range_image=RangeImageConfig(num_columns=num_columns))
        node = ClusteringNode(
            config=cfg,
            sensor_manufacturer=sensor,
            sensor_kwargs=sensor_kwargs or {},
            ego_robot_frame_from_sensor_frame=np.eye(4),
            wait_for_tf=True,
            device=device,
        )
    stats = {
        "messages": 0,
        "packets": 0,
        "clusters": 0,
        "cluster_points": 0,
        "clock_messages": 0,
        "tf_messages": 0,
    }

    def on_cluster(pts, stamp):
        stats["clusters"] += 1
        stats["cluster_points"] += len(pts)

    node.publish_cluster = on_cluster
    # clock + tf streams for downstream consumers (reference
    # kitti_demo.cpp:76-80 / ros_utils.cpp:404-422); collected so a caller
    # can forward them (RosBridge does, when ROS is present)
    clock_stream, tf_stream = [], []

    def on_clock(msg):
        stats["clock_messages"] += 1
        clock_stream.append(msg)

    def on_tf(msg):
        stats["tf_messages"] += 1
        tf_stream.append(msg)

    node.publish_clock = on_clock
    node.publish_tf = on_tf
    stats["clock_stream"] = clock_stream
    stats["tf_stream"] = tf_stream

    for msg_topic, datatype, stamp_ns, data in read_messages(bag_path):
        if topic is not None and msg_topic != topic:
            continue
        if datatype.endswith("VelodyneScan"):
            _, packets = decode_velodyne_scan(data)
            for pstamp, pkt in packets:
                node.on_transform(pstamp + 1, np.eye(4))
                node.on_raw_data(pkt, pstamp)
                stats["packets"] += 1
        elif datatype.endswith("PacketMsg"):
            node.on_transform(stamp_ns + 1, np.eye(4))
            node.on_raw_data(data if sensor != "ouster" else decode_ouster_packet(data), stamp_ns)
            stats["packets"] += 1
        else:
            continue
        stats["messages"] += 1
        if limit is not None and stats["messages"] >= limit:
            break
    node.flush()
    return stats


def main(argv=None):
    parser = CommandLineParser(argv if argv is not None else sys.argv[1:])
    topic = parser.get_value_for_argument("--topic", None)
    sensor = parser.get_value_for_argument("--sensor", "velodyne")
    num_lasers = int(parser.get_value_for_argument("--num-lasers", "16"))
    meta = parser.get_value_for_argument("--ouster-metadata", None)
    num_columns = int(parser.get_value_for_argument("--num-columns", "1700"))
    limit = parser.get_value_for_argument("--limit", None)
    device = parser.get_value_for_argument("--device", None)
    rest = [t for t in parser.get_remaining_args() if not t.startswith("-")]
    if not rest:
        raise SystemExit("usage: rosbag_replay <bag> [--topic T] [--sensor S]")

    kwargs = {}
    if sensor == "velodyne":
        kwargs = {"num_lasers": num_lasers, "decode_threads": 1}
    elif sensor == "ouster":
        if not meta:
            raise SystemExit("--ouster-metadata <sensor_info.json> is required")
        kwargs = {"sensor_info": meta, "decode_threads": 1}

    stats = replay(
        rest[0],
        topic=topic,
        sensor=sensor,
        sensor_kwargs=kwargs,
        num_columns=num_columns,
        limit=int(limit) if limit else None,
        device=device,
    )
    print(
        f"replayed {stats['messages']} messages / {stats['packets']} packets: "
        f"{stats['clusters']} clusters ({stats['cluster_points']} points), "
        f"{stats['clock_messages']} clock / {stats['tf_messages']} tf messages"
    )
    return stats


if __name__ == "__main__":
    main()
