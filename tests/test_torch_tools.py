"""The port's tools on the CPU: the ROS1 bag reader and writer
(``io/rosbag.py``), ``tools/rosbag_replay.py`` driving the port's node,
``tools/make_minimal_rosbag.py``, ``tools/latency_bench.py``, and the
``utils`` it needs (``platform.resolve_device``, ``profiling``, ``stats``).

The bags are written with ``tests/test_rosbag.py``'s spec-conformant writer
and with the port's own writer; what the port reads must equal what the
JAX package's reader reads from the same file, message for message.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from continuous_clustering_tpu.io import rosbag as jax_rosbag
from continuous_clustering_tpu_torch.io import rosbag
from continuous_clustering_tpu_torch.tools import sensor_packets as sp

from .test_native import _vlp16_packet
from .test_rosbag import _serialize_velodyne_scan, write_bag
from .test_torch_step import one_torch_thread  # noqa: F401

VLP16_COLS = 440


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the port's native library")


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_roundtrip(tmp_path, compression):
    pkt = _vlp16_packet(10.0)
    scan = _serialize_velodyne_scan(5_000_000_000, [(5_000_000_000, pkt)])
    msgs = [("/bus/vls128_roof/eth_scan/bus_to_host", "velodyne_msgs/VelodyneScan",
             5_000_000_000, scan),
            ("/other", "std_msgs/String", 6_000_000_000, b"\x03\x00\x00\x00abc")]
    bag = tmp_path / f"t_{compression}.bag"
    write_bag(bag, msgs, compression=compression)
    got = list(rosbag.read_messages(bag))
    assert [(t, d, s) for t, d, s, _ in got] == [m[:3] for m in msgs]
    assert got == list(jax_rosbag.read_messages(bag))
    stamp, packets = rosbag.decode_velodyne_scan(got[0][3])
    assert stamp == 5_000_000_000 and len(packets) == 1 and packets[0][1] == pkt
    assert rosbag.decode_ouster_packet(b"\x03\x00\x00\x00xyz!") == b"xyz"


def scan_bag(path, n_rev=2, seed=0):
    """A bag of VLP-16 scans of a seeded scene, one packet per message."""
    frames = sp.scene_frames(16, VLP16_COLS, n_rev, sp.vlp16_inclinations(), seed=seed,
                             num_boxes=6, spread=12.0)
    packets = sp.vlp16_packets(frames, t0_ns=9_000_000_000)
    write_bag(path, [("/velodyne_packets", "velodyne_msgs/VelodyneScan", stamp,
                      _serialize_velodyne_scan(stamp, [(stamp, pkt)]))
                     for stamp, pkt in packets], compression="bz2")
    return len(packets)


def test_bag_replay_drives_the_node(tmp_path):
    """A bag of VLP-16 scans -> rosbag_replay -> the port's node on the CPU
    -> clusters, and a clock and a tf message per firing."""
    from continuous_clustering_tpu_torch.tools.rosbag_replay import replay

    bag = tmp_path / "drive.bag"
    n_packets = scan_bag(bag)
    stats = replay(bag, sensor="velodyne", sensor_kwargs={"num_lasers": 16, "decode_threads": 1},
                   num_columns=VLP16_COLS, device="cpu")
    assert stats["packets"] == stats["messages"] == n_packets
    assert stats["clusters"] >= 1 and stats["cluster_points"] > 20
    # identity odometry stamped 1 ns after each packet: the firings of the
    # last packet are stamped later and wait for a transform the bag lacks
    assert stats["clock_messages"] == stats["tf_messages"] == (n_packets - 1) * 24
    stamps = [m["stamp_ns"] for m in stats["clock_stream"]]
    assert stamps == sorted(stamps)


def test_rosbag_replay_cli_equals_the_function(tmp_path, capsys):
    """``main([..., "--device", "cpu"])`` replays the bag like ``replay``
    (the decode thread on, as the CLI sets it), and ``--limit`` stops early."""
    from continuous_clustering_tpu_torch.tools.rosbag_replay import main, replay

    bag = tmp_path / "cli.bag"
    scan_bag(bag, n_rev=1, seed=3)
    stats = main([str(bag), "--num-lasers", "16", "--num-columns", str(VLP16_COLS),
                  "--device", "cpu"])
    assert "replayed" in capsys.readouterr().out
    ref = replay(bag, sensor="velodyne", sensor_kwargs={"num_lasers": 16},
                 num_columns=VLP16_COLS, device="cpu")
    for k in ("messages", "packets", "clusters", "cluster_points"):
        assert stats[k] == ref[k], k
    short = main([str(bag), "--num-lasers", "16", "--num-columns", str(VLP16_COLS),
                  "--device", "cpu", "--limit", "3"])
    assert short["messages"] == 3


def test_write_messages_roundtrip(tmp_path):
    msgs = [("/a", "pkg/TypeA", 1_500_000_000, b"payload-a0"),
            ("/b", "pkg/TypeB", 1_600_000_000, b"payload-b0"),
            ("/a", "pkg/TypeA", 1_700_000_000, b"payload-a1")]
    bag = tmp_path / "w.bag"
    rosbag.write_messages(bag, msgs)
    got = list(rosbag.read_messages_raw(bag))
    assert [(t, s, d) for t, _, s, d in got] == [(m[0], m[2], m[3]) for m in msgs]
    bag2 = tmp_path / "w2.bag"
    rosbag.write_messages(bag2, got, compression="bz2")
    assert list(rosbag.read_messages_raw(bag2)) == got == list(jax_rosbag.read_messages_raw(bag))
    # the port's writer writes the JAX writer's bytes
    bag3 = tmp_path / "w3.bag"
    jax_rosbag.write_messages(bag3, msgs)
    assert bag3.read_bytes() == bag.read_bytes()


def test_filter_bag_minimal(tmp_path):
    src = tmp_path / "full.bag"
    write_bag(src, [("/lidar/raw_data", "velodyne_msgs/VelodyneScan", 10**9, b"p0"),
                    ("/camera/image", "sensor_msgs/Image", 10**9 + 1, b"JPG" * 100),
                    ("/tf", "tf2_msgs/TFMessage", 10**9 + 2, b"tfmsg"),
                    ("/lidar/raw_data", "velodyne_msgs/VelodyneScan", 10**9 + 3, b"p1")])
    dst = tmp_path / "min.bag"
    assert rosbag.filter_bag(src, dst, ["/lidar/raw_data", "/tf"]) == {"/lidar/raw_data": 2,
                                                                     "/tf": 1}
    got = list(rosbag.read_messages(dst))
    assert [(t, d) for t, _, _, d in got] == [("/lidar/raw_data", b"p0"), ("/tf", b"tfmsg"),
                                              ("/lidar/raw_data", b"p1")]
    assert got[0][1] == "velodyne_msgs/VelodyneScan"


def test_make_minimal_rosbag_cli(tmp_path, capsys):
    from continuous_clustering_tpu_torch.tools.make_minimal_rosbag import main

    src = tmp_path / "full.bag"
    write_bag(src, [("/keep", "t/K", 5, b"x"), ("/drop", "t/D", 6, b"y")])
    dst = tmp_path / "min.bag"
    assert main([str(src), str(dst), "--topics", "/keep"]) == 0
    assert [m[0] for m in rosbag.read_messages(dst)] == ["/keep"]
    assert "wrote" in capsys.readouterr().out
    assert main([str(src)]) == 2                     # usage


def test_bag_header_record_matches_ros_comm_padding(tmp_path):
    import struct

    path = tmp_path / "hdr.bag"
    rosbag.write_messages(path, [("/t", b"topic=/t\n", 1, b"x")])
    raw = path.read_bytes()
    off = len(rosbag.MAGIC)
    (hlen,) = struct.unpack_from("<I", raw, off)
    (dlen,) = struct.unpack_from("<I", raw, off + 4 + hlen)
    assert hlen + dlen == 4096
    msgs = list(rosbag.read_messages(path))
    assert len(msgs) == 1 and msgs[0][3] == b"x"


def test_latency_bench_on_the_cpu(capsys):
    from continuous_clustering_tpu_torch.tools.latency_bench import main

    out = main(["--device", "cpu", "--rows", "16", "--columns", "110", "--revolutions", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert line["metric"] == "cluster_publish_latency" and line["unit"] == "ms"
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert line["clusters"] >= 1 and line["columns_per_second"] == 1100.0
    assert line["p50_ms"] <= line["p95_ms"] <= line["p99_ms"]
    # from the pacing, the backlog counts too: never earlier than from the
    # stamp of submission
    assert line["schedule_p50_ms"] >= line["p50_ms"]
    assert line["schedule_p99_ms"] >= line["p99_ms"]
    assert line["stream_s"] > 0 and line["real_time_s"] == 0.1


def test_resolve_device(monkeypatch):
    from continuous_clustering_tpu_torch.utils.platform import describe_device, resolve_device

    monkeypatch.delenv("CCT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("CCT_PLATFORM", "cpu")
    assert resolve_device() == torch.device("cpu")
    assert describe_device(torch.device("cpu")) == {"device": "cpu", "power_limit": None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("CCT_PLATFORM")
    assert resolve_device() == torch.device("cuda")


def test_latency_bench_and_replay_raise_without_a_card(tmp_path, monkeypatch):
    from continuous_clustering_tpu_torch.tools import latency_bench, rosbag_replay

    monkeypatch.delenv("CCT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        latency_bench.main(["--rows", "16", "--columns", "110", "--revolutions", "1"])
    bag = tmp_path / "b.bag"
    rosbag.write_messages(bag, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rosbag_replay.replay(bag, sensor_kwargs={"num_lasers": 16}, num_columns=110)


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    from continuous_clustering_tpu_torch.utils.profiling import span, trace

    with trace(str(tmp_path / "tr")):
        with span("cct_stage"):
            torch.ones(8).add_(1)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "cct_stage" for e in events)


def test_stats_equal_jax():
    """The port's copies of the recorders summarise like the JAX ones; the
    latency tracker adds p95."""
    from continuous_clustering_tpu.utils import stats as jax_stats
    from continuous_clustering_tpu_torch.utils import stats

    rng = np.random.default_rng(1)
    samples = rng.integers(0, 50, (40, 4)).tolist()
    w, jw = stats.WorkloadRecorder(), jax_stats.WorkloadRecorder()
    lt, jlt = stats.LatencyTracker(), jax_stats.LatencyTracker()
    for s in samples:
        kw = dict(zip(("sensor", "fifo", "device", "publish"), s))
        w.record(**kw)
        jw.record(**kw)
        lt.record_cluster(s[0], wall_publish_ns=10**6 * s[1] + s[0])
        jlt.record_cluster(s[0], wall_publish_ns=10**6 * s[1] + s[0])
    assert w.summary() == jw.summary()
    p, jp = lt.percentiles(), jlt.percentiles()
    assert {k: v for k, v in p.items() if k != "p95_ms"} == jp
    assert p["p95_ms"] == float(np.percentile([s[1] for s in samples], 95))
    t = stats.StageTimer()
    with t.track("a"):
        pass
    assert t.summary()["a"]["count"] == 1
