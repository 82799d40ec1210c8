"""The port's sensor decoders (``continuous_clustering_tpu_torch/sensors``).

Each decode test of ``tests/test_native.py`` runs here against the port's
native library (built from ``csrc/host`` with ``g++``) and against its NumPy
twin, with the same inputs and tolerances.  On top:

* native against the NumPy twin on the same packets: xyz within
  ``rtol = atol = 1e-5`` (``cosf``/``sinf`` against double trig; beyond 1 m
  the absolute bound is 1e-5 of the point's range, the size of an f32 trig
  error times the range, so that returns at 20-80 m are held to the same
  relative bound as test_native.py's returns within 12 m), stamps and
  intensities exact, for the VLP-16, the VLS-128 and all five Ouster
  profiles;
* the decode thread (``decode_threads=1``) against the inline decode:
  every firing exactly, in order;
* the port's NumPy decoders against the JAX package's NumPy decoders: every
  firing exactly;
* ``use_native=True`` raises when the library cannot be built (no silent
  drop to NumPy).

The Ouster ``sensor_info`` is written by the test (the reference's
calibration files are not part of this repository).
"""

from __future__ import annotations

import copy
import json
import math
import shutil

import numpy as np
import pytest

from continuous_clustering_tpu.sensors.ouster import OusterInput as JaxOusterInput
from continuous_clustering_tpu.sensors.velodyne import VelodyneInput as JaxVelodyneInput
from continuous_clustering_tpu_torch import native
from continuous_clustering_tpu_torch.sensors import velodyne_calibration as calib
from continuous_clustering_tpu_torch.sensors.ouster import OusterInput
from continuous_clustering_tpu_torch.sensors.sensor_input import GenericPointsInput
from continuous_clustering_tpu_torch.sensors.velodyne import VLP16_VERT_ANGLES, VelodyneInput
from continuous_clustering_tpu_torch.tools import sensor_packets as sp

from .test_native import (_expected_xyz_vlp16, _ouster_dual_packet, _ouster_fusa_packet,
                          _ouster_packet, _ouster_rng15_packet, _ouster_rng19_packet,
                          _vlp16_packet, _vlp16_packet_blocks, _vls128_packet)

# native against the NumPy twin: cosf/sinf against double trig
DECODE_RTOL = DECODE_ATOL = 1e-5
PROFILES = ("LEGACY", "RNG19_RFL8_SIG16_NIR16", "RNG15_RFL8_NIR8",
            "RNG19_RFL8_SIG16_NIR16_DUAL", "FUSA_RNG15_RFL8_NIR8_DUAL")


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the port's native library")


def os32_info(profile="LEGACY"):
    """An OS-32 sensor_info with beam azimuth offsets and the beam-origin
    offset, in ``profile`` (1024 columns: 88 encoder ticks a column)."""
    info = sp.os32_sensor_info()
    info["beam_azimuth_angles"] = [(-1.5 if i % 2 else 1.5) for i in range(32)]
    info["data_format"]["udp_profile_lidar"] = profile
    return info


def decode(dec, packets):
    out = []
    dec.add_on_new_firing_callback(out.append)
    for stamp, pkt in packets:
        dec.on_packet(pkt, stamp)
    dec.drain()
    return out


def profile_packets(info, profile):
    builders = {
        "LEGACY": lambda: [_ouster_packet(info, 5.0 + k, encoder0=88 * 16 * k) for k in range(4)],
        "RNG19_RFL8_SIG16_NIR16": lambda: [_ouster_rng19_packet(info, 4.0 + 3 * k, m_id=16 * k)
                                           for k in range(4)],
        "RNG15_RFL8_NIR8": lambda: [_ouster_rng15_packet(info, 7.5 + k, refl=20 + k, m_id=16 * k)
                                    for k in range(4)],
        "RNG19_RFL8_SIG16_NIR16_DUAL": lambda: [
            _ouster_dual_packet(info, (6.0 + k, 11.0 + k), (300 + 100 * k, 1200), m_id=16 * k)
            for k in range(4)],
        "FUSA_RNG15_RFL8_NIR8_DUAL": lambda: [
            _ouster_fusa_packet(info, (7.5 + k, 21.0), (17 + k, 255), m_id=16 * k)
            for k in range(4)],
    }
    return [(42 + 1000 * k, p) for k, p in enumerate(builders[profile]())]


def assert_firings_close(a, b, exact=False):
    assert len(a) == len(b) > 0
    for fa, fb in zip(a, b):
        if exact:
            np.testing.assert_array_equal(fa["xyz"], fb["xyz"])
        else:
            np.testing.assert_array_equal(np.isnan(fa["xyz"]), np.isnan(fb["xyz"]))
            rng = np.maximum(np.linalg.norm(np.nan_to_num(fb["xyz"]), axis=1, keepdims=True), 1.0)
            err = np.nan_to_num(np.abs(fa["xyz"] - fb["xyz"]))
            bound = DECODE_ATOL * rng + DECODE_RTOL * np.nan_to_num(np.abs(fb["xyz"]))
            assert np.all(err <= bound), f"max error {float((err - bound).max())} over the bound"
        np.testing.assert_array_equal(fa["stamp"], fb["stamp"])
        np.testing.assert_array_equal(fa["intensity"], fb["intensity"])
        assert fa["firing_index"] == fb["firing_index"]


# ------------------------------------------------------- test_native.py's cases

@pytest.mark.parametrize("use_native", [True, False])
def test_velodyne_decode(use_native):
    dec = VelodyneInput(num_lasers=16, use_native=use_native)
    firings = decode(dec, [(1_000_000, _vlp16_packet(45.0))])
    assert len(firings) == 24           # 12 blocks x 2 firings per block
    f = firings[0]
    assert f["xyz"].shape == (16, 3)
    np.testing.assert_allclose(np.linalg.norm(f["xyz"], axis=1), 10.0, rtol=1e-5)
    assert np.all(f["intensity"] == 77)
    assert f["xyz"][0, 2] > f["xyz"][-1, 2]   # rows top to bottom


@pytest.mark.parametrize("use_native", [True, False])
def test_ouster_decode(use_native):
    info = os32_info()
    firings = decode(OusterInput(info, use_native=use_native), [(42, _ouster_packet(info, 15.0))])
    assert len(firings) == info["data_format"]["columns_per_packet"]
    f = firings[0]
    assert f["xyz"].shape == (32, 3)
    np.testing.assert_allclose(np.linalg.norm(f["xyz"], axis=1), 15.0, rtol=0.01)
    assert np.all(f["intensity"] == int(500 * 255 / 1000))


@pytest.mark.parametrize("use_native", [True, False])
def test_vls128_all_banks_decoded(use_native):
    dec = VelodyneInput(num_lasers=128, distance_resolution=0.004, use_native=use_native)
    firings = decode(dec, [(0, _vls128_packet(90.0))])
    assert len(firings) == 3            # 12 blocks / 4 banks per firing
    f = firings[0]
    assert f["xyz"].shape == (128, 3)
    assert (~np.isnan(f["xyz"][:, 0])).all()
    np.testing.assert_allclose(np.linalg.norm(f["xyz"], axis=1), 20.0, rtol=1e-4)


@pytest.mark.parametrize("use_native", [True, False])
def test_ouster_rng19_decode(use_native):
    info = os32_info("RNG19_RFL8_SIG16_NIR16")
    firings = decode(OusterInput(info, use_native=use_native),
                     [(42, _ouster_rng19_packet(info, 15.0))])
    assert len(firings) == info["data_format"]["columns_per_packet"]
    d = np.linalg.norm(firings[0]["xyz"], axis=1)
    assert np.all(np.abs(d - 15.0) < 0.1)
    assert np.all(firings[0]["intensity"] == int(min(700, 1000) * 255 / 1000))


def test_ouster_rng19_matches_legacy_geometry():
    info_l, info_r = os32_info(), os32_info("RNG19_RFL8_SIG16_NIR16")
    ticks_per_col = 90112 // info_l["data_format"]["columns_per_frame"]
    m_id = 37
    legacy = decode(OusterInput(info_l),
                    [(7, _ouster_packet(info_l, 12.5, encoder0=m_id * ticks_per_col))])
    rng19 = decode(OusterInput(info_r), [(7, _ouster_rng19_packet(info_r, 12.5, m_id=m_id))])
    assert len(legacy) == len(rng19) > 0
    for a, b in zip(legacy, rng19):
        np.testing.assert_allclose(a["xyz"], b["xyz"], rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("use_native", [True, False])
def test_ouster_rng15_decode(use_native):
    info = os32_info("RNG15_RFL8_NIR8")
    firings = decode(OusterInput(info, use_native=use_native),
                     [(42, _ouster_rng15_packet(info, 12.0, refl=180))])
    assert len(firings) == info["data_format"]["columns_per_packet"]
    assert np.all(np.abs(np.linalg.norm(firings[0]["xyz"], axis=1) - 12.0) < 0.1)
    assert np.all(firings[0]["intensity"] == 180)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("return_index", [0, 1])
def test_ouster_dual_return_decode(use_native, return_index):
    info = os32_info("RNG19_RFL8_SIG16_NIR16_DUAL")
    dec = OusterInput(info, use_native=use_native, return_index=return_index)
    firings = decode(dec, [(42, _ouster_dual_packet(info, (10.0, 14.0), (500, 900)))])
    assert len(firings) == info["data_format"]["columns_per_packet"]
    d = np.linalg.norm(firings[0]["xyz"], axis=1)
    assert np.all(np.abs(d - (10.0, 14.0)[return_index]) < 0.1)
    assert np.all(firings[0]["intensity"] == int((500, 900)[return_index] * 255 / 1000))


def test_ouster_dual_return_index_validation():
    info = os32_info()
    with pytest.raises(ValueError, match="DUAL"):
        OusterInput(info, return_index=1)
    info["data_format"]["udp_profile_lidar"] = "NOT_A_PROFILE"
    with pytest.raises(ValueError, match="udp_profile_lidar"):
        OusterInput(info)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("return_index", [0, 1])
def test_ouster_fusa_dual_decode(use_native, return_index):
    info = os32_info("FUSA_RNG15_RFL8_NIR8_DUAL")
    dec = OusterInput(info, use_native=use_native, return_index=return_index)
    firings = decode(dec, [(42, _ouster_fusa_packet(info, (10.0, 14.0), (210, 80)))])
    assert len(firings) == info["data_format"]["columns_per_packet"]
    f = firings[0]
    want_r = (10.0, 14.0)[return_index]
    assert np.all(np.abs(np.linalg.norm(f["xyz"], axis=1) - want_r) < 0.05)
    assert np.all(f["intensity"] == (210, 80)[return_index])
    # hand-computed xyz of pixel 0 of column 0 (m_id 0: theta_enc = 2 pi)
    alt = np.deg2rad(info["beam_altitude_angles"][0])
    azo = np.deg2rad(info["beam_azimuth_angles"][0])
    n = info["lidar_origin_to_beam_origin_mm"] * 1e-3
    theta_enc = 2.0 * np.pi
    rc = want_r - n
    want = np.array([rc * np.cos(theta_enc + azo) * np.cos(alt) + n * np.cos(theta_enc),
                     rc * np.sin(theta_enc + azo) * np.cos(alt) + n * np.sin(theta_enc),
                     rc * np.sin(alt)], np.float32)
    np.testing.assert_allclose(f["xyz"][0], want, atol=2e-2)


@pytest.mark.parametrize("use_native", [True, False])
def test_vlp16_azimuth_interpolation(use_native):
    az0, daz = 9000, 40
    dist_ticks = int(12.0 / 0.002)
    specs = [(az0 + b * daz, {ch: (dist_ticks, 10) for ch in range(32)}) for b in range(12)]
    firings = decode(VelodyneInput(num_lasers=16, use_native=use_native),
                     [(0, _vlp16_packet_blocks(specs))])
    assert len(firings) == 24
    dsr_t, fir_t, blk_t = 2.304, 55.296, 110.592
    rings = np.argsort(np.argsort(VLP16_VERT_ANGLES))
    for b in (0, 5):
        for firing in (0, 1):
            f = firings[b * 2 + firing]
            for dsr in (0, 7, 15):
                row = 16 - int(rings[dsr]) - 1
                az_f = az0 + b * daz + daz * (dsr * dsr_t + firing * fir_t) / blk_t
                exp = _expected_xyz_vlp16(dsr, az_f, 12.0, VLP16_VERT_ANGLES[dsr])
                np.testing.assert_allclose(f["xyz"][row], exp, rtol=2e-5, atol=2e-5,
                                           err_msg=f"b={b} firing={firing} dsr={dsr}")
    row = 16 - int(rings[15]) - 1
    uninterp = _expected_xyz_vlp16(15, az0, 12.0, VLP16_VERT_ANGLES[15])
    assert np.abs(firings[1]["xyz"][row] - uninterp).max() > 1e-3


@pytest.mark.parametrize("use_native", [True, False])
def test_vlp16_dual_return(use_native):
    last_t, strong_t = int(8.0 / 0.002), int(6.0 / 0.002)
    specs = []
    for pair in range(6):
        az = 18000 + pair * 40
        specs.append((az, {3: (last_t, 1), 5: (last_t, 2), 19: (last_t, 1), 21: (last_t, 2)}))
        specs.append((az, {3: (strong_t, 9), 19: (strong_t, 9)}))
    firings = decode(VelodyneInput(num_lasers=16, use_native=use_native),
                     [(0, _vlp16_packet_blocks(specs, return_mode=0x39))])
    assert len(firings) == 12           # pairs collapse into one firing each
    rings = np.argsort(np.argsort(VLP16_VERT_ANGLES))
    row3, row5 = 16 - int(rings[3]) - 1, 16 - int(rings[5]) - 1
    for f in firings:
        np.testing.assert_allclose(np.linalg.norm(f["xyz"][row3]), 6.0, rtol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(f["xyz"][row5]), 8.0, rtol=1e-4)
        assert f["intensity"][row3] == 9
        other = [r for r in range(16) if r not in (row3, row5)]
        assert np.isnan(f["xyz"][other, 0]).all()


def two_point_decoder(cls, use_native):
    R = 32
    return cls(num_lasers=R, vert_angles_deg=np.linspace(10, -30, R),
               azimuth_offsets_deg=np.full(R, 1.5, np.float32), use_native=use_native,
               dist_corrections_m=np.full(R, 0.12, np.float32),
               dist_corrections_x_m=np.full(R, 0.20, np.float32),
               dist_corrections_y_m=np.full(R, 0.05, np.float32),
               vert_offsets_m=np.full(R, 0.10, np.float32),
               horiz_offsets_m=np.full(R, 0.026, np.float32), two_pt=np.ones(R, np.uint8))


def two_point_packet(az_deg=73.0, dist_m=17.0):
    blocks = b""
    for _ in range(12):
        blocks += struct_block(0xEEFF, int(az_deg * 100), [(int(dist_m / 0.002), 40)] * 32)
    return blocks + b"\x00" * 6


def struct_block(flag, az_ticks, chans):
    import struct

    return struct.pack("<HH", flag, az_ticks) + b"".join(struct.pack("<HB", d, i) for d, i in chans)


@pytest.mark.parametrize("use_native", [True, False])
def test_velodyne_two_point_calibration(use_native):
    firings = decode(two_point_decoder(VelodyneInput, use_native), [(0, two_point_packet())])
    assert len(firings) == 12
    R, az_deg, dist_m = 32, 73.0, 17.0
    vert_deg = np.linspace(10, -30, R)
    rings = np.argsort(np.argsort(vert_deg))
    for laser in (0, 13, 31):
        va = math.radians(float(vert_deg[laser]))
        cv, sv = math.cos(va), math.sin(va)
        az = math.radians(az_deg) - math.radians(1.5)
        ca, sa = math.cos(az), math.sin(az)
        d = dist_m + 0.12
        xy = d * cv - 0.10 * sv
        xx, yy = abs(xy * sa - 0.026 * ca), abs(xy * ca + 0.026 * sa)
        cx = (0.12 - 0.20) * (xx - 2.40) / (25.04 - 2.40) + 0.20 - 0.12
        cy = (0.12 - 0.05) * (yy - 1.93) / (25.04 - 1.93) + 0.05 - 0.12
        xv = ((d + cx) * cv - 0.10 * sv) * sa - 0.026 * ca
        yv = ((d + cy) * cv - 0.10 * sv) * ca + 0.026 * sa
        zv = (d + cy) * sv + 0.10 * cv
        np.testing.assert_allclose(firings[0]["xyz"][R - int(rings[laser]) - 1],
                                   np.array([yv, -xv, zv], np.float32), rtol=1e-4, atol=1e-4,
                                   err_msg=f"laser={laser}")


# ------------------------------------------------- native against the NumPy twin

def interpolated_vlp16_packets():
    """Advancing azimuths, every other packet dual return (test_native.py's
    parity stream)."""
    rng = np.random.default_rng(7)
    pkts = []
    for p in range(8):
        dual = p % 2 == 1
        specs = []
        for b in range(12):
            az = (p * 600 + (b // (2 if dual else 1)) * 40) % 36000
            chans = {int(ch): (int(rng.integers(0, 3000)), int(rng.integers(0, 255)))
                     for ch in rng.integers(0, 32, 20)}
            specs.append((az, chans))
        pkts.append((p * 10**6, _vlp16_packet_blocks(specs, 0x39 if dual else 0x37)))
    return pkts


VLP16_CORRECTIONS = dict(
    num_lasers=16,
    dist_corrections_m=np.full(16, 0.03, np.float32),
    vert_offsets_m=np.full(16, 0.05, np.float32),
    horiz_offsets_m=np.full(16, -0.02, np.float32),
    two_pt=np.ones(16, np.uint8),
    dist_corrections_x_m=np.full(16, 0.06, np.float32),
    dist_corrections_y_m=np.full(16, 0.01, np.float32),
)


def vls128_stream():
    frames = sp.scene_frames(128, 170, 1, sp.velodyne_inclinations(128), seed=2)
    return sp.velodyne_packets(frames)


VELODYNE_STREAMS = {
    "vlp16": (lambda: [(i * 10**6, _vlp16_packet(a, dist_m=5 + a / 50))
                       for i, a in enumerate(np.linspace(0, 359, 20))], dict(num_lasers=16)),
    "vlp16_interpolated": (interpolated_vlp16_packets, VLP16_CORRECTIONS),
    "vls128_scene": (vls128_stream, dict(num_lasers=128)),
    "vlp16_scene": (lambda: sp.vlp16_packets(sp.scene_frames(16, 110, 1, sp.vlp16_inclinations(),
                                                               spread=15.0)),
                    dict(num_lasers=16)),
}


@pytest.mark.parametrize("stream", sorted(VELODYNE_STREAMS))
def test_velodyne_native_matches_numpy(stream):
    make, kw = VELODYNE_STREAMS[stream]
    pkts = make()
    nat = decode(VelodyneInput(use_native=True, **kw), pkts)
    ref = decode(VelodyneInput(use_native=False, **kw), pkts)
    assert_firings_close(nat, ref)


@pytest.mark.parametrize("profile,return_index", [(p, r) for p in PROFILES
                                                   for r in ((0, 1) if "DUAL" in p else (0,))])
def test_ouster_native_matches_numpy(profile, return_index):
    info = os32_info(profile)
    pkts = profile_packets(info, profile)
    nat = decode(OusterInput(info, use_native=True, return_index=return_index), pkts)
    ref = decode(OusterInput(info, use_native=False, return_index=return_index), pkts)
    assert_firings_close(nat, ref)


def test_ouster_scene_native_matches_numpy():
    """An OS-32 scene in the LEGACY profile (the packets of
    ``tools/sensor_packets.py``): native equals the twin, and both equal the
    ray-cast frame within the quantization of the packets."""
    info = sp.os32_sensor_info(columns_per_frame=256)
    frames = sp.scene_frames(32, 256, 1, np.deg2rad(np.linspace(22.5, -22.5, 32)), seed=4)
    pkts = sp.ouster_legacy_packets(frames, info)
    nat = decode(OusterInput(info, use_native=True), pkts)
    ref = decode(OusterInput(info, use_native=False), pkts)
    assert_firings_close(nat, ref)
    xyz = np.stack([f["xyz"] for f in nat])
    assert np.array_equal(np.isnan(xyz), np.isnan(frames[0]))
    # 1 mm range ticks, 1 / 88 of a column's encoder ticks, and the beam
    # origin 15.8 mm off the sensor's axis
    np.testing.assert_allclose(xyz, frames[0], atol=0.05)


# ------------------------------------------------------ decode thread vs inline

@pytest.mark.parametrize("stream", ["vlp16", "vls128_scene"])
def test_velodyne_decode_offload_matches_inline(stream):
    make, kw = VELODYNE_STREAMS[stream]
    pkts = make()
    inline = decode(VelodyneInput(**kw), pkts)
    dec = VelodyneInput(decode_threads=1, **kw)
    assert dec._offload is not None
    offload = decode(dec, pkts)
    assert dec.pending_packets() == 0
    assert_firings_close(inline, offload, exact=True)


@pytest.mark.parametrize("profile", PROFILES)
def test_ouster_decode_offload_matches_inline(profile):
    info = os32_info(profile)
    pkts = profile_packets(info, profile)
    inline = decode(OusterInput(info), pkts)
    dec = OusterInput(info, decode_threads=1)
    assert dec._offload is not None
    offload = decode(dec, pkts)
    assert dec.pending_packets() == 0
    assert_firings_close(inline, offload, exact=True)


# ------------------------------------------ the port's NumPy twin against JAX's

@pytest.mark.parametrize("stream", sorted(VELODYNE_STREAMS))
def test_velodyne_numpy_decoder_equals_jax(stream):
    make, kw = VELODYNE_STREAMS[stream]
    pkts = make()
    assert_firings_close(decode(VelodyneInput(use_native=False, **kw), pkts),
                         decode(JaxVelodyneInput(use_native=False, **kw), pkts), exact=True)


def test_velodyne_two_point_numpy_decoder_equals_jax():
    pkts = [(0, two_point_packet()), (10**6, two_point_packet(101.0, 4.0))]
    assert_firings_close(decode(two_point_decoder(VelodyneInput, False), pkts),
                         decode(two_point_decoder(JaxVelodyneInput, False), pkts), exact=True)


@pytest.mark.parametrize("profile", PROFILES)
def test_ouster_numpy_decoder_equals_jax(profile):
    info = os32_info(profile)
    pkts = profile_packets(info, profile)
    for ri in ((0, 1) if "DUAL" in profile else (0,)):
        assert_firings_close(decode(OusterInput(info, use_native=False, return_index=ri), pkts),
                             decode(JaxOusterInput(copy.deepcopy(info), use_native=False,
                                                   return_index=ri), pkts), exact=True)


# ----------------------------------------------------------------- the rest

def test_ouster_no_return_pixel_intensity_differs_between_decoders():
    """A pixel without a return (range 0) gets intensity 0 from the native
    decoder and its scaled signal from the NumPy twin (both packages' code);
    its point is NaN either way, so the clustering never sees it."""
    info = os32_info()
    pkt = _ouster_packet(info, 0.0)                      # range 0, signal 500
    nat = decode(OusterInput(info, use_native=True), [(1, pkt)])
    ref = decode(OusterInput(info, use_native=False), [(1, pkt)])
    assert np.isnan(nat[0]["xyz"]).all() and np.isnan(ref[0]["xyz"]).all()
    assert np.all(nat[0]["intensity"] == 0)
    assert np.all(ref[0]["intensity"] == int(500 * 255 / 1000))


def test_sensor_info_from_a_path(tmp_path):
    info = os32_info()
    path = tmp_path / "os32.json"
    path.write_text(json.dumps(info))
    pkt = [(5, _ouster_packet(info, 9.0))]
    assert_firings_close(decode(OusterInput(str(path)), pkt), decode(OusterInput(info), pkt),
                         exact=True)


def test_use_native_raises_when_the_library_cannot_be_built(monkeypatch):
    def no_build():
        raise RuntimeError("native library cannot be built: g++ not found")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "build", no_build)
    with pytest.raises(RuntimeError, match="cannot be built"):
        VelodyneInput(num_lasers=16)
    with pytest.raises(RuntimeError, match="cannot be built"):
        OusterInput(os32_info())
    # the NumPy twin needs no library
    assert len(decode(VelodyneInput(num_lasers=16, use_native=False),
                      [(0, _vlp16_packet(10.0))])) == 24


def test_generic_points_input_latches_rows_and_stamps():
    dec = GenericPointsInput()
    out = []
    dec.add_on_new_firing_callback(out.append)
    xyz = np.arange(12, dtype=np.float32).reshape(4, 3)
    dec.on_message(xyz, 77)
    dec.on_message(xyz + 1, 78, intensity=np.full(4, 9, np.uint8))
    assert dec.num_lasers == 4 and [f["firing_index"] for f in out] == [0, 1]
    np.testing.assert_array_equal(out[1]["xyz"], xyz + 1)
    assert out[0]["stamp"].tolist() == [77] * 4 and out[1]["intensity"].tolist() == [9] * 4


def test_velodyne_calibration_equals_jax(tmp_path):
    from continuous_clustering_tpu.sensors import velodyne_calibration as jax_calib

    lasers = "\n".join(
        f"- {{laser_id: {i}, vert_correction: {math.radians(v):.9f}, rot_correction: "
        f"{0.001 * i:.6f}, dist_correction: 0.0{i % 7}, two_pt_correction_available: "
        f"{'true' if i % 2 else 'false'}}}" for i, v in enumerate(VLP16_VERT_ANGLES))
    path = tmp_path / "vlp16.yaml"
    path.write_text("lasers:\n" + "\n".join("  " + ln for ln in lasers.splitlines()) + "\n")
    for fn in ("load_calibration",):
        got, want = getattr(calib, fn)(path), getattr(jax_calib, fn)(path)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    text = path.read_text()
    got, want = calib._parse_minimal(text), jax_calib._parse_minimal(text)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    for model in ("VLP16", "HDL32"):
        got, want = calib.builtin(model), jax_calib.builtin(model)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    # the loaded calibration drives the decoder like the explicit arrays
    cal = calib.load_calibration(path)
    dec = VelodyneInput(**cal, use_native=False)
    assert dec.num_lasers == 16 and np.array_equal(dec.rings, cal["rings"])
