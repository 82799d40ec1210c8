"""Velodyne packet input: the native C++ decoder, and its NumPy twin (the
port's counterpart of ``continuous_clustering_tpu/sensors/velodyne.py``).

Decodes raw 1206-byte Velodyne data packets into firings (reference
VelodyneInput, ros/velodyne_input.hpp; wire format per the public Velodyne
manuals).  Calibration = per-laser vertical angles (+ optional azimuth
offsets and ring mapping), e.g. from a velodyne_pointcloud-style YAML.

``use_native=True`` (the default) decodes with the port's native library
(``native.py``, built from ``csrc/host``) and raises when it cannot be
built: unlike the JAX class there is no silent drop to NumPy.  The NumPy
decoder runs only when asked for (``use_native=False``); it is the twin the
tests hold the native decoder against (f32-close: ``cosf``/``sinf`` against
double trig).
"""

from __future__ import annotations

import ctypes
import math
import numpy as np

from .. import native
from ..utils.stats import TRACE
from .sensor_input import SensorInput

# Built-in VLP-16 vertical angles (degrees), laser-id order
VLP16_VERT_ANGLES = [
    -15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15,
]


class VelodyneInput(SensorInput):
    def __init__(
        self,
        num_lasers: int = 16,
        vert_angles_deg=None,
        azimuth_offsets_deg=None,
        rings=None,
        distance_resolution: float = 0.002,
        firing_cycle_ns: float = 55296.0,
        use_native: bool = True,
        decode_threads: int = 0,
        dist_corrections_m=None,
        dist_corrections_x_m=None,
        dist_corrections_y_m=None,
        vert_offsets_m=None,
        horiz_offsets_m=None,
        two_pt=None,
    ):
        super().__init__(num_lasers)
        if vert_angles_deg is None:
            if num_lasers == 16:
                vert_angles_deg = VLP16_VERT_ANGLES
            else:
                vert_angles_deg = np.linspace(15, -25, num_lasers)
        self.vert = np.deg2rad(np.asarray(vert_angles_deg, np.float32))
        self.az_off = (
            np.deg2rad(np.asarray(azimuth_offsets_deg, np.float32))
            if azimuth_offsets_deg is not None
            else np.zeros(num_lasers, np.float32)
        )
        if rings is None:
            # ring = rank of vertical angle (bottom = 0)
            rings = np.argsort(np.argsort(self.vert)).astype(np.int32)
        self.rings = np.asarray(rings, np.int32)
        self.distance_resolution = distance_resolution
        self.firing_cycle_ns = firing_cycle_ns

        # velodyne_pointcloud per-laser correction terms (meters); zeros when
        # the calibration does not provide them
        def _arr(v):
            return (
                np.zeros(num_lasers, np.float32)
                if v is None
                else np.asarray(v, np.float32)
            )

        self.dist_corr = _arr(dist_corrections_m)
        self.dist_corr_x = _arr(dist_corrections_x_m)
        self.dist_corr_y = _arr(dist_corrections_y_m)
        self.vert_off = _arr(vert_offsets_m)
        self.horiz_off = _arr(horiz_offsets_m)
        self.two_pt = (
            np.zeros(num_lasers, np.uint8)
            if two_pt is None
            else np.asarray(two_pt, np.uint8)
        )

        self._native = None
        self._offload = None
        if use_native:
            lib = self._lib = native.load()  # raises when it cannot be built
            self._native = lib.cct_velodyne_create(
                num_lasers,
                ctypes.c_float(distance_resolution),
                self.vert.ctypes.data_as(ctypes.c_void_p),
                self.az_off.ctypes.data_as(ctypes.c_void_p),
                self.rings.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_double(firing_cycle_ns),
            )
            lib.cct_velodyne_set_corrections(
                self._native,
                self.dist_corr.ctypes.data_as(ctypes.c_void_p),
                self.dist_corr_x.ctypes.data_as(ctypes.c_void_p),
                self.dist_corr_y.ctypes.data_as(ctypes.c_void_p),
                self.vert_off.ctypes.data_as(ctypes.c_void_p),
                self.horiz_off.ctypes.data_as(ctypes.c_void_p),
                self.two_pt.ctypes.data_as(ctypes.c_void_p),
            )
            if decode_threads > 0:
                # decode-thread offload (reference ros_sensor_input.hpp:19-60):
                # on_packet only enqueues; a native worker decodes packet n
                # while the caller dispatches the firings of packet n-1
                self._offload = lib.cct_offload_create(self._native, 0, 1)
        # NumPy decoder's assembly state
        self._slot_xyz = np.full((num_lasers, 3), np.nan, np.float32)
        self._slot_int = np.zeros(num_lasers, np.uint8)
        self._slot_stamp = np.zeros(num_lasers, np.uint64)
        self._slot_filled = np.zeros(num_lasers, bool)

    def __del__(self):
        if getattr(self, "_offload", None):
            self._lib.cct_offload_destroy(self._offload)
            self._offload = None
        if getattr(self, "_native", None):
            self._lib.cct_velodyne_destroy(self._native)
            self._native = None

    # ------------------------------------------------------------- decode
    def on_packet(self, packet: bytes, stamp_ns: int) -> None:
        TRACE.count("node.packets")
        if self._offload:
            with TRACE.span("node.enqueue"):
                buf = (ctypes.c_char * len(packet)).from_buffer_copy(packet)
                self._lib.cct_offload_enqueue(
                    self._offload, buf, len(packet), ctypes.c_uint64(stamp_ns)
                )
            self._poll_native()
        elif self._native:
            with TRACE.span("node.enqueue"):
                buf = (ctypes.c_char * len(packet)).from_buffer_copy(packet)
                self._lib.cct_velodyne_decode(
                    self._native, buf, len(packet), ctypes.c_uint64(stamp_ns)
                )
            self._poll_native()
        else:
            self._decode_python(packet, stamp_ns)

    def pending_packets(self) -> int:
        """Packets enqueued to the decode thread but not yet decoded
        (queue-depth metric, reference workload sampling)."""
        if self._offload:
            return int(self._lib.cct_offload_pending(self._offload))
        return 0

    def drain(self) -> None:
        """Block until the decode thread has consumed every enqueued packet,
        then emit the resulting firings (deterministic flush)."""
        if self._offload:
            self._lib.cct_offload_drain(self._offload)
            self._poll_native()

    def _poll_native(self):
        with TRACE.span("node.poll"):
            R = self.num_lasers
            max_f = 64
            while True:
                # fresh buffers every round: _emit hands out views into them
                xyz = np.empty((max_f, R, 3), np.float32)
                inten = np.empty((max_f, R), np.uint8)
                stamps = np.empty((max_f, R), np.uint64)
                if self._offload:
                    n = self._lib.cct_offload_poll(
                        self._offload,
                        max_f,
                        xyz.ctypes.data_as(ctypes.c_void_p),
                        inten.ctypes.data_as(ctypes.c_void_p),
                        stamps.ctypes.data_as(ctypes.c_void_p),
                    )
                else:
                    n = self._lib.cct_velodyne_poll(
                        self._native,
                        max_f,
                        xyz.ctypes.data_as(ctypes.c_void_p),
                        inten.ctypes.data_as(ctypes.c_void_p),
                        stamps.ctypes.data_as(ctypes.c_void_p),
                    )
                for i in range(n):
                    self._emit(xyz[i], stamps[i], inten[i])
                if n < max_f:
                    break

    # ------------------------------------------------- the NumPy twin
    # VLP-16 firing timing, microseconds (velodyne_pointcloud constants)
    _VLP16_DSR_TOFFSET = 2.304
    _VLP16_FIRING_TOFFSET = 55.296
    _VLP16_BLOCK_TDURATION = 110.592

    def _decode_python(self, packet: bytes, stamp_ns: int) -> None:
        if len(packet) < 1200:
            return
        data = np.frombuffer(packet, dtype=np.uint8)[:1200].reshape(12, 100)
        # factory byte 1204: return mode (0x39 = dual)
        dual = len(packet) >= 1206 and packet[1204] == 0x39
        az_ticks = [
            int(data[b, 2]) | (int(data[b, 3]) << 8) for b in range(12)
        ]
        R = self.num_lasers
        if R == 16:
            self._decode_python_vlp16(data, az_ticks, dual, stamp_ns)
            return
        blocks_per_firing = max(1, (R + 31) // 32)
        # bank flags: 0xEEFF lasers 0-31, 0xDDFF 32-63, 0xCCFF 64-95,
        # 0xBBFF 96-127 (VLS-128)
        bank_of = {0xEEFF: 0, 0xDDFF: 32, 0xCCFF: 64, 0xBBFF: 96}
        dual_pair = dual and R == 32  # pairing for 32-laser models only
        for b in range(12):
            block = data[b]
            flag = int(block[0]) | (int(block[1]) << 8)
            if flag not in bank_of:
                continue
            azimuth = az_ticks[b] * 0.01 * math.pi / 180.0
            payload = block[4:100].reshape(32, 3)
            ticks = payload[:, 0].astype(np.uint16) | (
                payload[:, 1].astype(np.uint16) << np.uint16(8)
            )
            inten = payload[:, 2]
            bank = bank_of[flag] if R > 32 else 0
            overwrite_pass = dual_pair and b % 2 == 1
            tb = (b & ~1) if dual_pair else b  # pair blocks are simultaneous
            for ch in range(32):
                laser = bank + ch
                if laser >= R:
                    break
                self._add_point(
                    laser, azimuth, float(ticks[ch]) * self.distance_resolution,
                    int(inten[ch]),
                    stamp_ns + int((tb * 32 + ch) * self.firing_cycle_ns / 32),
                    overwrite=overwrite_pass and int(ticks[ch]) > 0,
                )
            complete = (
                b % 2 == 1 if dual_pair else (b + 1) % blocks_per_firing == 0
            )
            if complete and self._slot_filled.any():
                self._emit_assembled()

    def _decode_python_vlp16(self, data, az_ticks, dual, stamp_ns):
        """Two 16-laser firings per block with inter-block azimuth
        interpolation; dual-return pairs assemble into one firing with the
        strongest (second) block overwriting the last-return block."""
        last_diff = 0.0
        step = 2 if dual else 1
        for b in range(0, 12, step):
            if b + step < 12:
                d = az_ticks[b + step] - az_ticks[b]
                diff = float((36000 + d) % 36000)
                if d < 0:  # angle-overflow guard
                    diff = last_diff
                last_diff = diff
            else:
                diff = last_diff
            for firing in range(2):
                for pkt_pass in range(2 if dual else 1):
                    blk = b + pkt_pass
                    block = data[blk]
                    flag = int(block[0]) | (int(block[1]) << 8)
                    if flag != 0xEEFF:
                        continue
                    payload = block[4:100].reshape(32, 3)
                    for dsr in range(16):
                        k = firing * 16 + dsr
                        ticks = int(payload[k, 0]) | (int(payload[k, 1]) << 8)
                        az_t = az_ticks[b] + diff * (
                            dsr * self._VLP16_DSR_TOFFSET
                            + firing * self._VLP16_FIRING_TOFFSET
                        ) / self._VLP16_BLOCK_TDURATION
                        if az_t >= 36000.0:
                            az_t -= 36000.0
                        self._add_point(
                            dsr,
                            az_t * 0.01 * math.pi / 180.0,
                            ticks * self.distance_resolution,
                            int(payload[k, 2]),
                            stamp_ns
                            + int((b * 32 + k) * self.firing_cycle_ns / 32),
                            overwrite=pkt_pass == 1 and ticks > 0,
                        )
                if self._slot_filled.any():
                    self._emit_assembled()

    def _add_point(self, laser, azimuth, dist, inten, stamp, overwrite=False):
        ring = int(self.rings[laser])
        row = self.num_lasers - ring - 1  # velodyne_input.hpp:62
        if self._slot_filled[row] and not overwrite:
            return
        was_filled = bool(self._slot_filled[row])
        if dist <= 0:
            if not was_filled:
                self._slot_filled[row] = True
                self._slot_stamp[row] = stamp
            return  # distance 0 => NaN (velodyne_input.hpp:56)
        self._slot_filled[row] = True
        self._slot_stamp[row] = stamp
        # f32 math end-to-end, as the native decoder computes it
        f32 = np.float32
        va = f32(self.vert[laser])
        cv, sv = f32(math.cos(va)), f32(math.sin(va))
        # rot_correction is subtracted (velodyne_pointcloud convention),
        # via the angle-difference identities like the native path
        rc = f32(self.az_off[laser])
        craw, sraw = f32(math.cos(f32(azimuth))), f32(math.sin(f32(azimuth)))
        crc, src = f32(math.cos(rc)), f32(math.sin(rc))
        ca = f32(craw * crc + sraw * src)
        sa = f32(sraw * crc - craw * src)
        vo, ho = f32(self.vert_off[laser]), f32(self.horiz_off[laser])
        dc = f32(self.dist_corr[laser])
        d = f32(f32(dist) + dc)
        corr_x = corr_y = f32(0.0)
        if self.two_pt[laser]:
            # two-point distance correction, interpolated between the near
            # anchors (2.40 m x / 1.93 m y) and the 25.04 m far anchor
            xy = f32(d * cv - vo * sv)
            xx = f32(abs(xy * sa - ho * ca))
            yy = f32(abs(xy * ca + ho * sa))
            dcx, dcy = f32(self.dist_corr_x[laser]), f32(self.dist_corr_y[laser])
            corr_x = f32((dc - dcx) * (xx - f32(2.40)) / f32(25.04 - 2.40) + dcx - dc)
            corr_y = f32((dc - dcy) * (yy - f32(1.93)) / f32(25.04 - 1.93) + dcy - dc)
        dist_x, dist_y = f32(d + corr_x), f32(d + corr_y)
        xv = f32(f32(dist_x * cv - vo * sv) * sa - ho * ca)
        yv = f32(f32(dist_y * cv - vo * sv) * ca + ho * sa)
        zv = f32(dist_y * sv + vo * cv)
        # velodyne frame -> ROS frame: x = y_v, y = -x_v, z = z_v
        self._slot_xyz[row] = (yv, -xv, zv)
        self._slot_int[row] = inten

    def _emit_assembled(self):
        self._emit(self._slot_xyz.copy(), self._slot_stamp.copy(), self._slot_int.copy())
        self._slot_xyz[:] = np.nan
        self._slot_int[:] = 0
        self._slot_stamp[:] = 0
        self._slot_filled[:] = False
