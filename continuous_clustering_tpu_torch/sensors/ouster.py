"""Ouster packet input: the native C++ decoder, and its NumPy twin (the
port's counterpart of ``continuous_clustering_tpu/sensors/ouster.py``).

``use_native=True`` (the default) decodes with the port's native library
and raises when it cannot be built; the NumPy decoder runs only when asked
for (``use_native=False``), as the twin the tests hold the native decoder
against.  ``sensor_info`` is a path to the JSON or the parsed dict.

Parses the sensor_info JSON (beam angles, data format — same schema as the
reference's calibrations/touareg_os32_*.json) and decodes lidar packets
into firings (reference OusterInput, ros/ouster_input.hpp, which delegates
the format to the ouster-sdk packet_format).  The profile is selected by
the ``udp_profile_lidar`` field of the sensor_info (absent = LEGACY):

* ``LEGACY`` — 16-byte column headers with an encoder-tick azimuth.
* ``RNG19_RFL8_SIG16_NIR16`` — single-return eUDP, 12-byte pixels.
* ``RNG15_RFL8_NIR8`` — low-data-rate eUDP, 4-byte pixels (8 mm range
  granularity, no SIGNAL field: intensity comes from the calibrated
  0-255 reflectivity).
* ``RNG19_RFL8_SIG16_NIR16_DUAL`` — dual-return eUDP, 16-byte pixels;
  ``return_index`` selects which return is emitted (the reference
  publishes the first return's RANGE/SIGNAL, ouster_input.hpp:134-138).
* ``FUSA_RNG15_RFL8_NIR8_DUAL`` — functional-safety dual-return eUDP,
  8-byte pixels: per return r in {0,1} range u16 @4r (15 bits, 8 mm
  granularity) and calibrated reflectivity u8 @(2+4r); near_ir u8 @3.
  Like RNG15 there is no SIGNAL field, so intensity is the 0-255
  reflectivity verbatim.
"""

from __future__ import annotations

import ctypes
import json
import math
from pathlib import Path
import numpy as np

from .. import native
from ..utils.stats import TRACE
from .sensor_input import SensorInput

ENCODER_TICKS_PER_REV = 90112


class OusterInput(SensorInput):
    PROFILES = {
        "LEGACY": 0,
        "RNG19_RFL8_SIG16_NIR16": 1,
        "RNG15_RFL8_NIR8": 2,
        "RNG19_RFL8_SIG16_NIR16_DUAL": 3,
        "FUSA_RNG15_RFL8_NIR8_DUAL": 4,
    }
    DUAL_PROFILES = (3, 4)

    def __init__(
        self,
        sensor_info,
        use_native: bool = True,
        decode_threads: int = 0,
        return_index: int = 0,
    ):
        if isinstance(sensor_info, (str, Path)):
            sensor_info = json.loads(Path(sensor_info).read_text())
        self.info = sensor_info
        fmt = sensor_info["data_format"]
        self.pixels_per_column = int(fmt["pixels_per_column"])
        self.columns_per_packet = int(fmt["columns_per_packet"])
        self.columns_per_frame = int(fmt["columns_per_frame"])
        self.beam_to_origin_mm = float(sensor_info["lidar_origin_to_beam_origin_mm"])
        prof_name = str(fmt.get("udp_profile_lidar", "LEGACY"))
        if prof_name not in self.PROFILES:
            raise ValueError(
                f"unsupported Ouster udp_profile_lidar: {prof_name!r} "
                f"(supported: {', '.join(self.PROFILES)})"
            )
        self.profile = self.PROFILES[prof_name]
        if return_index not in (0, 1):
            raise ValueError("return_index must be 0 or 1")
        if return_index == 1 and self.profile not in self.DUAL_PROFILES:
            raise ValueError("return_index=1 requires a DUAL profile")
        self.return_index = return_index
        self.altitude = np.deg2rad(
            np.asarray(sensor_info["beam_altitude_angles"], np.float32)
        )
        self.azimuth = np.deg2rad(
            np.asarray(sensor_info["beam_azimuth_angles"], np.float32)
        )
        super().__init__(self.pixels_per_column)

        self._native = None
        self._offload = None
        if use_native:
            lib = self._lib = native.load()  # raises when it cannot be built
            self._native = lib.cct_ouster_create(
                self.pixels_per_column,
                self.columns_per_packet,
                self.columns_per_frame,
                self.profile,
                self.return_index,
                ctypes.c_double(self.beam_to_origin_mm),
                self.altitude.ctypes.data_as(ctypes.c_void_p),
                self.azimuth.ctypes.data_as(ctypes.c_void_p),
            )
            if decode_threads > 0:
                # decode-thread offload (reference ros_sensor_input.hpp:19-60)
                self._offload = lib.cct_offload_create(self._native, 1, 1)

    def __del__(self):
        if getattr(self, "_offload", None):
            self._lib.cct_offload_destroy(self._offload)
            self._offload = None
        if getattr(self, "_native", None):
            self._lib.cct_ouster_destroy(self._native)
            self._native = None

    def on_packet(self, packet: bytes, host_stamp_ns: int) -> None:
        TRACE.count("node.packets")
        if self._offload:
            with TRACE.span("node.enqueue"):
                buf = (ctypes.c_char * len(packet)).from_buffer_copy(packet)
                self._lib.cct_offload_enqueue(
                    self._offload, buf, len(packet), ctypes.c_uint64(host_stamp_ns)
                )
            self._poll_native()
        elif self._native:
            with TRACE.span("node.enqueue"):
                buf = (ctypes.c_char * len(packet)).from_buffer_copy(packet)
                self._lib.cct_ouster_decode(
                    self._native, buf, len(packet), ctypes.c_uint64(host_stamp_ns)
                )
            self._poll_native()
        else:
            self._decode_python(packet, host_stamp_ns)

    def pending_packets(self) -> int:
        if self._offload:
            return int(self._lib.cct_offload_pending(self._offload))
        return 0

    def drain(self) -> None:
        if self._offload:
            self._lib.cct_offload_drain(self._offload)
            self._poll_native()

    def _poll_native(self):
        with TRACE.span("node.poll"):
            R = self.pixels_per_column
            max_f = self.columns_per_packet * 2
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
                    n = self._lib.cct_ouster_poll(
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

    def _decode_python(self, packet: bytes, host_stamp_ns: int) -> None:
        R = self.pixels_per_column
        eudp = self.profile != 0
        pixel_bytes = {0: 12, 1: 12, 2: 4, 3: 16, 4: 8}[self.profile]
        header = 32 if eudp else 0
        col_header = 12 if eudp else 16
        col_footer = 0 if eudp else 4
        col_bytes = col_header + R * pixel_bytes + col_footer
        if len(packet) < header + col_bytes * self.columns_per_packet:
            return
        raw = np.frombuffer(packet, np.uint8)
        for c in range(self.columns_per_packet):
            col = raw[header + c * col_bytes : header + (c + 1) * col_bytes]
            if eudp:
                status16 = int(col[10:12].copy().view(np.uint16)[0])
                if not (status16 & 0x1):
                    continue
                m_id = int(col[8:10].copy().view(np.uint16)[0])
                theta_enc = 2.0 * math.pi * (1.0 - m_id / self.columns_per_frame)
            else:
                status = col[-4:].view(np.uint32)[0]
                if status != 0xFFFFFFFF:
                    continue
                encoder = int(col[12:16].view(np.uint32)[0])
                theta_enc = 2.0 * math.pi * (1.0 - encoder / ENCODER_TICKS_PER_REV)
            px = col[col_header : col_header + R * pixel_bytes].reshape(R, pixel_bytes)
            if self.profile == 2:
                # 15-bit range at 8 mm granularity; no SIGNAL field
                r16 = px[:, :2].copy().view(np.uint16)[:, 0]
                range_mm = (r16 & 0x7FFF).astype(np.uint32) * 8
                signal = None
                inten8 = px[:, 2].copy()  # calibrated reflectivity, 0-255
            elif self.profile == 3:
                ro = 4 * self.return_index
                range_mm = px[:, ro : ro + 4].copy().view(np.uint32)[:, 0] & 0x0007FFFF
                so = 8 + 2 * self.return_index
                signal = px[:, so : so + 2].copy().view(np.uint16)[:, 0]
            elif self.profile == 4:
                ro = 4 * self.return_index
                r16 = px[:, ro : ro + 2].copy().view(np.uint16)[:, 0]
                range_mm = (r16 & 0x7FFF).astype(np.uint32) * 8
                signal = None
                inten8 = px[:, ro + 2].copy()  # calibrated reflectivity
            else:
                mask = 0x0007FFFF if self.profile == 1 else 0x000FFFFF
                range_mm = px[:, :4].copy().view(np.uint32)[:, 0] & mask
                signal = px[:, 6:8].copy().view(np.uint16)[:, 0]
            valid = range_mm > 0
            r = range_mm.astype(np.float32) * 1e-3
            n_off = self.beam_to_origin_mm * 1e-3
            theta = theta_enc + self.azimuth
            rc = r - n_off
            xyz = np.full((R, 3), np.nan, np.float32)
            xyz[valid, 0] = (
                rc[valid] * np.cos(theta[valid]) * np.cos(self.altitude[valid])
                + n_off * math.cos(theta_enc)
            )
            xyz[valid, 1] = (
                rc[valid] * np.sin(theta[valid]) * np.cos(self.altitude[valid])
                + n_off * math.sin(theta_enc)
            )
            xyz[valid, 2] = rc[valid] * np.sin(self.altitude[valid])
            if signal is not None:
                inten = np.clip(signal.astype(np.float32), 0, 1000) * 255.0 / 1000.0
                inten8 = inten.astype(np.uint8)
            self._emit(
                xyz,
                np.full(R, host_stamp_ns, np.uint64),
                inten8,
            )
