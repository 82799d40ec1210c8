// Ouster LiDAR UDP packet decoder (legacy packet format).
//
// Native equivalent of the reference's OusterInput
// (include/continuous_clustering/ros/ouster_input.hpp): per measurement
// block (column) read RANGE + SIGNAL fields and convert to XYZ via the
// precomputed beam lookup table built from the sensor_info beam angles
// (ouster_input.hpp:75-88); signal scaled to 0-255; one firing per valid
// column.
//
// Legacy format: per column
//   16-byte header: timestamp u64, measurement id u16, frame id u16,
//   encoder count u32
//   pixels_per_column pixels of 12 bytes: range u32 (19 bits + flags),
//   reflectivity u16, signal u16, near_ir u16, padding u16
//   4-byte block status footer (0xFFFFFFFF = valid)
//
// eUDP formats (32-byte packet header, per column a 12-byte header:
// timestamp u64, measurement id u16, status u16 with bit0 = valid; azimuth
// comes from the measurement id: theta_enc = 2*pi * (1 - m_id / cols)):
//   RNG19_RFL8_SIG16_NIR16 (profile 1): 12-byte pixels — range u32
//     (19 bits), reflectivity u8, signal u16 @6, near_ir u16 @8.
//   RNG15_RFL8_NIR8 low data rate (profile 2): 4-byte pixels — range u16
//     (15 bits, 8 mm granularity), reflectivity u8 @2, near_ir u8 @3.
//     This profile carries no SIGNAL field; intensity comes from the
//     already-0-255 calibrated reflectivity instead of the 0-1000 signal
//     scaling.
//   RNG19_RFL8_SIG16_NIR16_DUAL (profile 3): 16-byte pixels — per return
//     r in {0,1}: range u32 @4r (19 bits) with reflectivity u8 packed in
//     bits 24-31, signal u16 @(8+2r); near_ir u16 @12.  return_index
//     selects which return is emitted (the reference publishes the first
//     return's RANGE/SIGNAL fields only, ouster_input.hpp:134-138).
//   FUSA_RNG15_RFL8_NIR8_DUAL (profile 4): 8-byte pixels — per return
//     r in {0,1}: range u16 @4r (15 bits, 8 mm granularity), calibrated
//     reflectivity u8 @(2+4r); near_ir u8 @3.  No SIGNAL field: intensity
//     is the 0-255 reflectivity verbatim (like profile 2).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kNaN = std::numeric_limits<float>::quiet_NaN();

struct OusterDecoder {
  int pixels_per_column;
  int columns_per_packet;
  int columns_per_frame;
  int profile;       // 0 = LEGACY, 1 = RNG19, 2 = RNG15 low rate,
                     // 3 = RNG19 dual, 4 = FUSA RNG15 dual
  int return_index;  // 0 or 1; only meaningful for profiles 3 and 4
  double lidar_origin_to_beam_origin_mm;
  std::vector<float> altitude;  // radians, per pixel
  std::vector<float> azimuth;   // radians, per pixel (beam azimuth offsets)

  std::vector<float> out_xyz;
  std::vector<uint8_t> out_inten;
  std::vector<uint64_t> out_stamps;
  int out_count = 0;

  void decodePacket(const uint8_t* data, int64_t size, uint64_t host_stamp) {
    const bool eudp = profile != 0;
    const int pixel_bytes =
        profile == 2 ? 4 : profile == 3 ? 16 : profile == 4 ? 8 : 12;
    const int header = eudp ? 32 : 0;
    const int col_header = eudp ? 12 : 16;
    const int col_footer = eudp ? 0 : 4;
    const int col_bytes = col_header + pixels_per_column * pixel_bytes + col_footer;
    if (size < header + static_cast<int64_t>(col_bytes) * columns_per_packet)
      return;
    for (int c = 0; c < columns_per_packet; ++c) {
      const uint8_t* col = data + header + c * col_bytes;
      uint16_t mid;
      std::memcpy(&mid, col + 8, 2);
      float theta_enc;
      if (eudp) {
        uint16_t status16;
        std::memcpy(&status16, col + 10, 2);
        if (!(status16 & 0x1)) continue;
        theta_enc = 2.0f * static_cast<float>(M_PI) *
                    (1.0f - static_cast<float>(mid) /
                                static_cast<float>(columns_per_frame));
      } else {
        uint32_t status;
        std::memcpy(&status, col + col_bytes - 4, 4);
        if (status != 0xFFFFFFFFu) continue;
        uint32_t encoder;
        std::memcpy(&encoder, col + 12, 4);
        // encoder ticks: 90112 per rev
        theta_enc = 2.0f * static_cast<float>(M_PI) *
                    (1.0f - static_cast<float>(encoder) / 90112.0f);
      }
      size_t base = out_xyz.size();
      out_xyz.resize(base + static_cast<size_t>(pixels_per_column) * 3, kNaN);
      out_inten.resize(out_inten.size() + pixels_per_column, 0);
      out_stamps.resize(out_stamps.size() + pixels_per_column, host_stamp);
      for (int px = 0; px < pixels_per_column; ++px) {
        const uint8_t* p = col + col_header + px * pixel_bytes;
        uint32_t range_mm;
        uint8_t inten8;
        if (profile == 2) {
          uint16_t range16;
          std::memcpy(&range16, p, 2);
          range_mm = static_cast<uint32_t>(range16 & 0x7FFFu) * 8u;
          inten8 = p[2];  // calibrated reflectivity, already 0-255
        } else if (profile == 3) {
          uint32_t word;
          std::memcpy(&word, p + 4 * return_index, 4);
          range_mm = word & 0x0007FFFFu;
          uint16_t signal;
          std::memcpy(&signal, p + 8 + 2 * return_index, 2);
          float s = signal > 1000 ? 1000.0f : static_cast<float>(signal);
          inten8 = static_cast<uint8_t>(s * 255.0f / 1000.0f);
        } else if (profile == 4) {
          uint16_t range16;
          std::memcpy(&range16, p + 4 * return_index, 2);
          range_mm = static_cast<uint32_t>(range16 & 0x7FFFu) * 8u;
          inten8 = p[2 + 4 * return_index];  // calibrated reflectivity
        } else {
          uint32_t range_raw;
          std::memcpy(&range_raw, p, 4);
          range_mm = range_raw & (profile == 1 ? 0x0007FFFFu : 0x000FFFFFu);
          uint16_t signal;
          std::memcpy(&signal, p + 6, 2);
          float s = signal > 1000 ? 1000.0f : static_cast<float>(signal);
          inten8 = static_cast<uint8_t>(s * 255.0f / 1000.0f);
        }
        if (range_mm == 0) continue;
        float r = range_mm * 1e-3f;
        float n = static_cast<float>(lidar_origin_to_beam_origin_mm) * 1e-3f;
        float theta = theta_enc + azimuth[px];
        float phi = altitude[px];
        float rc = r - n;
        float x = rc * std::cos(theta) * std::cos(phi) + n * std::cos(theta_enc);
        float y = rc * std::sin(theta) * std::cos(phi) + n * std::sin(theta_enc);
        float z = rc * std::sin(phi);
        out_xyz[base + px * 3 + 0] = x;
        out_xyz[base + px * 3 + 1] = y;
        out_xyz[base + px * 3 + 2] = z;
        // 0-1000 signal -> 0-255 clamp (ouster_input.hpp intensity scaling)
        out_inten[out_inten.size() - pixels_per_column + px] = inten8;
      }
      ++out_count;
    }
  }
};

}  // namespace

extern "C" {

void* cct_ouster_create(int pixels_per_column, int columns_per_packet,
                        int columns_per_frame, int profile, int return_index,
                        double lidar_origin_to_beam_origin_mm,
                        const float* altitude_rad, const float* azimuth_rad) {
  auto* d = new OusterDecoder();
  d->pixels_per_column = pixels_per_column;
  d->columns_per_packet = columns_per_packet;
  d->columns_per_frame = columns_per_frame;
  d->profile = profile;
  d->return_index = return_index;
  d->lidar_origin_to_beam_origin_mm = lidar_origin_to_beam_origin_mm;
  d->altitude.assign(altitude_rad, altitude_rad + pixels_per_column);
  d->azimuth.assign(azimuth_rad, azimuth_rad + pixels_per_column);
  return d;
}

void cct_ouster_destroy(void* h) { delete static_cast<OusterDecoder*>(h); }

void cct_ouster_decode(void* h, const uint8_t* packet, int64_t size,
                       uint64_t host_stamp_ns) {
  static_cast<OusterDecoder*>(h)->decodePacket(packet, size, host_stamp_ns);
}

int cct_ouster_poll(void* h, int max_firings, float* xyz, uint8_t* inten,
                    uint64_t* stamps) {
  auto* d = static_cast<OusterDecoder*>(h);
  int n = d->out_count < max_firings ? d->out_count : max_firings;
  size_t rows = static_cast<size_t>(d->pixels_per_column);
  std::memcpy(xyz, d->out_xyz.data(), n * rows * 3 * sizeof(float));
  std::memcpy(inten, d->out_inten.data(), n * rows * sizeof(uint8_t));
  std::memcpy(stamps, d->out_stamps.data(), n * rows * sizeof(uint64_t));
  d->out_xyz.erase(d->out_xyz.begin(), d->out_xyz.begin() + n * rows * 3);
  d->out_inten.erase(d->out_inten.begin(), d->out_inten.begin() + n * rows);
  d->out_stamps.erase(d->out_stamps.begin(), d->out_stamps.begin() + n * rows);
  d->out_count -= n;
  return n;
}
}
