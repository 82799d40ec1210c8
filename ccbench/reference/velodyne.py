"""Plain NumPy decoder of 1206-byte Velodyne data packets for sensors of 32
or more lasers (VLS-128 class), written for the benchmark from the wire
format, not from the program's decoder.

Per the Velodyne manuals: a packet holds 12 blocks of 100 bytes, each a
2-byte bank flag (0xEEFF lasers 0-31, 0xDDFF 32-63, 0xCCFF 64-95, 0xBBFF
96-127), a 2-byte azimuth in hundredths of a degree, and 32 channels of a
2-byte distance in ``distance_resolution`` ticks and a 1-byte intensity; 6
factory bytes follow.  ``R / 32`` consecutive blocks of one azimuth make one
firing.  A channel's time is the packet's stamp plus ``(block * 32 +
channel) * firing_cycle_ns / 32``.  Rows follow the reference's convention:
row = R - ring - 1, ring the rank of the laser's vertical angle (bottom 0).
A zero distance is no return (NaN).  Coordinates are worked out in float64
and rounded once to float32: x = d cos(v) cos(a), y = -d cos(v) sin(a),
z = d sin(v).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

BANK_BASE = {0xEEFF: 0, 0xDDFF: 32, 0xCCFF: 64, 0xBBFF: 96}
BLOCK = np.dtype([("flag", "<u2"), ("az", "<u2"), ("ch", [("d", "<u2"), ("i", "u1")], (32,))])


def decode(packets: Sequence[Tuple[int, bytes]], num_lasers: int, vert_angles_deg,
           distance_resolution: float, firing_cycle_ns: float) -> List[Dict[str, np.ndarray]]:
    """The firings of ``packets`` ((stamp_ns, bytes) in order), each a dict
    of ``xyz`` (R, 3) f32, ``stamp`` (R,) u64 and ``intensity`` (R,) u8."""
    R = num_lasers
    banks = R // 32
    if R % 32 or 12 % banks:
        raise ValueError(f"{R} lasers do not fill whole packets of 32-laser banks")
    vert = np.deg2rad(np.asarray(vert_angles_deg, np.float64))
    ring = np.argsort(np.argsort(vert))
    row_of_laser = R - ring - 1
    raw = np.frombuffer(b"".join(p[:1200] for _, p in packets), np.uint8)
    blocks = raw.view(BLOCK).reshape(len(packets), 12 // banks, banks)   # (P, firings, banks)
    stamps = np.asarray([s for s, _ in packets], np.uint64)
    firings = []
    for p in range(blocks.shape[0]):
        for f in range(blocks.shape[1]):
            group = blocks[p, f]
            known = [g for g in range(banks) if int(group[g]["flag"]) in BANK_BASE]
            if not known:
                continue
            xyz = np.full((R, 3), np.nan, np.float32)
            stamp = np.zeros(R, np.uint64)
            inten = np.zeros(R, np.uint8)
            for g in known:
                blk = group[g]
                b = f * banks + g                       # block index in the packet
                lasers = BANK_BASE[int(blk["flag"])] + np.arange(32)
                rows = row_of_laser[lasers]
                d = blk["ch"]["d"].astype(np.float64) * distance_resolution
                a = np.deg2rad(int(blk["az"]) * 0.01)
                v = vert[lasers]
                pts = np.stack([d * np.cos(v) * np.cos(a), -d * np.cos(v) * np.sin(a),
                                d * np.sin(v)], axis=1)
                pts[d <= 0] = np.nan
                xyz[rows] = pts.astype(np.float32)
                inten[rows] = blk["ch"]["i"]
                stamp[rows] = stamps[p] + ((b * 32 + np.arange(32)) * firing_cycle_ns
                                           / 32).astype(np.uint64)
            firings.append({"xyz": xyz, "stamp": stamp, "intensity": inten})
    return firings
