"""Minimal pure-Python ROS1 bag (format 2.0) reader — no ROS required (the
port's copy of ``continuous_clustering_tpu/io/rosbag.py``).

The reference's sensor-hardware-free workflow replays rosbags of raw UDP
packets (`rosbag play`, reference README.md:111-135).  This reader covers
that use case in a zero-ROS environment: iterate `(topic, datatype, stamp,
raw_bytes)` for the packet topics and decode the two raw-packet message
types the reference consumes:

* ``velodyne_msgs/VelodyneScan`` — std_msgs/Header + VelodynePacket[]
  (each: ros time + 1206 fixed bytes),
* ``ouster_ros/PacketMsg`` — uint8[] buffer.

Format per the public rosbag 2.0 spec: a ``#ROSBAG V2.0`` magic line, then
length-prefixed records whose headers are ``len|name=value`` fields; chunk
records (op=0x05) wrap connection/message records, compression ``none`` or
``bz2`` (lz4 needs an external lib and raises).  Validated round-trip
against the writer in tests/test_rosbag.py and tests/test_torch_tools.py.
"""

from __future__ import annotations

import bz2
import struct
from pathlib import Path
from typing import Dict, Iterator, Tuple

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    n = len(buf)
    while off < n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


class Connection:
    def __init__(self, conn_id: int, topic: str, conn_header: bytes):
        h = _parse_header(conn_header)
        self.id = conn_id
        self.topic = topic
        self.datatype = h.get(b"type", b"").decode()
        self.md5sum = h.get(b"md5sum", b"").decode()


def read_messages(path) -> Iterator[Tuple[str, str, int, bytes]]:
    """Yield (topic, datatype, stamp_ns, serialized_message) in bag order."""
    raw = Path(path).read_bytes()
    if not raw.startswith(MAGIC):
        raise ValueError(f"{path}: not a ROSBAG V2.0 file")
    connections: Dict[int, Connection] = {}

    def handle(header: Dict[bytes, bytes], data: bytes):
        op = header[b"op"][0]
        if op == OP_CONNECTION:
            (cid,) = struct.unpack("<I", header[b"conn"])
            topic = header[b"topic"].decode()
            connections[cid] = Connection(cid, topic, data)
        elif op == OP_MSG:
            (cid,) = struct.unpack("<I", header[b"conn"])
            secs, nsecs = struct.unpack("<II", header[b"time"])
            conn = connections[cid]
            yield_list.append(
                (conn.topic, conn.datatype, secs * 1_000_000_000 + nsecs, data)
            )
        elif op == OP_CHUNK:
            compression = header.get(b"compression", b"none")
            if compression == b"none":
                payload = data
            elif compression == b"bz2":
                payload = bz2.decompress(data)
            else:
                raise ValueError(
                    f"unsupported chunk compression: {compression.decode()}"
                )
            for h2, d2 in _records(payload):
                handle(h2, d2)
        # bag header / index / chunk info records are skipped

    yield_list: list = []
    for header, data in _records(raw, len(MAGIC)):
        handle(header, data)
        while yield_list:
            yield yield_list.pop(0)


# --------------------------------------------------------------------------
# raw-packet message decoders (ROS1 serialization)
# --------------------------------------------------------------------------

def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off : off + n].decode(), off + n


def decode_velodyne_scan(data: bytes):
    """velodyne_msgs/VelodyneScan -> (header_stamp_ns, [(stamp_ns, packet)])."""
    off = 4  # header.seq
    secs, nsecs = struct.unpack_from("<II", data, off)
    off += 8
    _, off = _read_string(data, off)  # frame_id
    (count,) = struct.unpack_from("<I", data, off)
    off += 4
    packets = []
    for _ in range(count):
        psec, pnsec = struct.unpack_from("<II", data, off)
        off += 8
        packets.append((psec * 1_000_000_000 + pnsec, data[off : off + 1206]))
        off += 1206
    return secs * 1_000_000_000 + nsecs, packets


def decode_ouster_packet(data: bytes) -> bytes:
    """ouster_ros/PacketMsg -> raw packet buffer."""
    (n,) = struct.unpack_from("<I", data, 0)
    return data[4 : 4 + n]


# --------------------------------------------------------------------------
# writer + topic filter (reference scripts/create_minimal_rosbag.py analog)
# --------------------------------------------------------------------------

def _emit_header(fields) -> bytes:
    out = b""
    for name, value in fields:
        f = name + b"=" + value
        out += struct.pack("<I", len(f)) + f
    return out


def _emit_record(fields, data: bytes) -> bytes:
    h = _emit_header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def read_messages_raw(path) -> Iterator[Tuple[str, bytes, int, bytes]]:
    """Like :func:`read_messages` but yields the RAW connection header
    bytes instead of the parsed datatype: ``(topic, conn_header, stamp_ns,
    serialized_message)``.  Preserving the original connection header
    (type, md5sum, full message_definition) keeps filtered bags consumable
    by stock ROS tools."""
    raw = Path(path).read_bytes()
    if not raw.startswith(MAGIC):
        raise ValueError(f"{path}: not a ROSBAG V2.0 file")
    conns: Dict[int, Tuple[str, bytes]] = {}
    out: list = []

    def handle(header: Dict[bytes, bytes], data: bytes):
        op = header[b"op"][0]
        if op == OP_CONNECTION:
            (cid,) = struct.unpack("<I", header[b"conn"])
            conns[cid] = (header[b"topic"].decode(), data)
        elif op == OP_MSG:
            (cid,) = struct.unpack("<I", header[b"conn"])
            secs, nsecs = struct.unpack("<II", header[b"time"])
            topic, ch = conns[cid]
            out.append((topic, ch, secs * 1_000_000_000 + nsecs, data))
        elif op == OP_CHUNK:
            compression = header.get(b"compression", b"none")
            payload = data if compression == b"none" else bz2.decompress(data)
            for h2, d2 in _records(payload):
                handle(h2, d2)

    for header, data in _records(raw, len(MAGIC)):
        handle(header, data)
        while out:
            yield out.pop(0)


def write_messages(path, messages, compression: str = "none") -> None:
    """Write a spec-conformant (unindexed) ROSBAG V2.0 file.

    ``messages``: iterable of ``(topic, conn_header_bytes, stamp_ns,
    serialized_message)`` — the shape :func:`read_messages_raw` yields, so
    read→filter→write round-trips losslessly.  ``conn_header_bytes`` may
    also be a plain datatype string, in which case a minimal connection
    header is synthesized (md5sum "*": consumers that verify md5 must
    reindex).  The file carries index_pos=0, i.e. "unindexed" per the
    spec; ``rosbag reindex`` restores indexes for ROS-side consumers.
    """
    topics: Dict[str, int] = {}
    inner = b""
    for topic, conn_header, stamp_ns, payload in messages:
        if isinstance(conn_header, str):
            conn_header = _emit_header(
                [(b"type", conn_header.encode()), (b"md5sum", b"*"),
                 (b"message_definition", b"")]
            )
        if topic not in topics:
            cid = len(topics)
            topics[topic] = cid
            inner += _emit_record(
                [(b"op", bytes([OP_CONNECTION])),
                 (b"conn", struct.pack("<I", cid)),
                 (b"topic", topic.encode())],
                conn_header,
            )
        inner += _emit_record(
            [(b"op", bytes([OP_MSG])),
             (b"conn", struct.pack("<I", topics[topic])),
             (b"time", struct.pack("<II", stamp_ns // 10 ** 9, stamp_ns % 10 ** 9))],
            payload,
        )
    chunk_data = bz2.compress(inner) if compression == "bz2" else inner
    if compression not in ("none", "bz2"):
        raise ValueError(f"unsupported compression: {compression}")
    chunk = _emit_record(
        [(b"op", bytes([OP_CHUNK])),
         (b"compression", compression.encode()),
         (b"size", struct.pack("<I", len(inner)))],
        chunk_data,
    )
    # ros_comm's writeFileHeaderRecord pads HEADER + DATA (excluding the two
    # 4-byte length prefixes) to FILE_HEADER_LENGTH = 4096, i.e. data_len =
    # 4096 - header_len and the record totals 4104 bytes, so `rosbag
    # reindex` can rewrite index_pos / conn_count in place without
    # clobbering the first chunk record that follows.
    bh_fields = [
        (b"op", bytes([OP_BAG_HEADER])),
        (b"index_pos", struct.pack("<Q", 0)),
        (b"conn_count", struct.pack("<I", len(topics))),
        (b"chunk_count", struct.pack("<I", 1)),
    ]
    bh_header_len = len(_emit_header(bh_fields))
    bag_header = _emit_record(bh_fields, b"\x20" * (4096 - bh_header_len))
    assert len(bag_header) == 4104
    Path(path).write_bytes(MAGIC + bag_header + chunk)


def filter_bag(src, dst, topics, compression: str = "none") -> Dict[str, int]:
    """Copy only ``topics`` (exact names) from bag ``src`` to ``dst``,
    preserving connection headers and stamps (the reference's
    make-minimal-rosbag workflow: keep the raw packet + tf topics, drop
    cameras and bulky debug topics).  Returns {topic: message_count}."""
    keep = set(topics)
    counts: Dict[str, int] = {}

    def gen():
        for topic, ch, stamp, payload in read_messages_raw(src):
            if topic in keep:
                counts[topic] = counts.get(topic, 0) + 1
                yield topic, ch, stamp, payload

    write_messages(dst, gen(), compression=compression)
    return counts
