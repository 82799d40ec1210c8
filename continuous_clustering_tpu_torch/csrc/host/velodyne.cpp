// Velodyne UDP packet decoder (VLP-16 / HDL-32 / VLP-32C / VLS-128 class).
//
// Native equivalent of the reference's VelodyneInput decode path
// (include/continuous_clustering/ros/velodyne_input.hpp, which delegates to
// the vendored velodyne_pointcloud RawData parser).  Implemented from the
// public Velodyne wire format: 1206-byte data packets of 12 blocks, each
// block = 0xEEFF/0xDDFF flag, 2-byte azimuth (centi-degrees), 32 channels of
// (2-byte distance, 1-byte intensity), then a 4-byte timestamp and 2 factory
// bytes (return mode, product id).
//
// Fidelity features matching the velodyne_pointcloud RawData math:
//   * VLP-16 inter-block azimuth interpolation: the sensor reports one
//     azimuth per block but fires 2x16 lasers across the block's duration;
//     each channel's azimuth is interpolated from the gap to the next block
//     using the published firing timing (2.304 us/channel, 55.296 us/firing,
//     110.592 us/block).
//   * Dual-return mode (factory byte 0x39): consecutive block pairs carry
//     the last + strongest return of the SAME firing at the same azimuth;
//     the pair is assembled into one firing, strongest (second block)
//     overwriting last when both are valid.  Supported for 16- and 32-laser
//     models (the reference's parser likewise special-cases per model).
//   * Full per-laser calibration corrections: rot_correction (subtracted
//     from azimuth), dist_correction, two-point distance corrections
//     (dist_correction_x/y with the 2.40 m / 1.93 m / 25.04 m anchor
//     interpolation), vert_offset_correction, horiz_offset_correction.
//
// Output firings follow the reference convention: one slot per laser row,
// row = num_lasers - ring - 1 (velodyne_input.hpp:46-76), NaN for missing
// returns, per-point timestamp = packet stamp + intra-packet offset.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBlocksPerPacket = 12;
constexpr int kChannelsPerBlock = 32;
constexpr float kNaN = std::numeric_limits<float>::quiet_NaN();
constexpr float kDegTicksToRad = 0.01f * static_cast<float>(M_PI) / 180.0f;

// VLP-16 firing timing, microseconds (velodyne_pointcloud rawdata constants)
constexpr float kVlp16DsrToffset = 2.304f;
constexpr float kVlp16FiringToffset = 55.296f;
constexpr float kVlp16BlockDuration = 110.592f;

// two-point calibration anchor distances, meters (velodyne_pointcloud)
constexpr float kTwoPtAnchorX = 2.40f;
constexpr float kTwoPtAnchorY = 1.93f;
constexpr float kTwoPtFar = 25.04f;

constexpr uint8_t kReturnModeDual = 0x39;

struct Config {
  int num_lasers;                 // 16, 32 or 128
  float distance_resolution;      // meters per tick (0.002 or 0.004)
  std::vector<float> vert_angle;  // per laser id, radians
  std::vector<float> azimuth_offset;  // rot_correction per laser id, radians
  std::vector<int> ring;          // laser id -> ring (bottom=0)
  double firing_cycle_ns;         // time between consecutive firings
  // velodyne_pointcloud two-point + offset correction terms (all meters)
  std::vector<float> dist_correction;
  std::vector<float> dist_correction_x;
  std::vector<float> dist_correction_y;
  std::vector<float> vert_offset;
  std::vector<float> horiz_offset;
  std::vector<uint8_t> two_pt;  // per laser: two-point correction available
};

struct Decoder {
  Config cfg;
  // current firing assembly (reference SensorInput, ros/sensor_input.hpp)
  std::vector<float> xyz;        // num_lasers * 3
  std::vector<uint8_t> inten;
  std::vector<uint64_t> stamps;
  int points_in_firing = 0;
  uint64_t firing_index = 0;

  // completed firings, flattened
  std::vector<float> out_xyz;
  std::vector<uint8_t> out_inten;
  std::vector<uint64_t> out_stamps;
  int out_count = 0;

  explicit Decoder(Config c) : cfg(std::move(c)) {
    size_t n = static_cast<size_t>(cfg.num_lasers);
    if (cfg.dist_correction.empty()) cfg.dist_correction.assign(n, 0.0f);
    if (cfg.dist_correction_x.empty()) cfg.dist_correction_x.assign(n, 0.0f);
    if (cfg.dist_correction_y.empty()) cfg.dist_correction_y.assign(n, 0.0f);
    if (cfg.vert_offset.empty()) cfg.vert_offset.assign(n, 0.0f);
    if (cfg.horiz_offset.empty()) cfg.horiz_offset.assign(n, 0.0f);
    if (cfg.two_pt.empty()) cfg.two_pt.assign(n, 0);
    resetFiring();
  }

  void resetFiring() {
    xyz.assign(static_cast<size_t>(cfg.num_lasers) * 3, kNaN);
    inten.assign(cfg.num_lasers, 0);
    stamps.assign(cfg.num_lasers, 0);
    points_in_firing = 0;
  }

  void emitFiring() {
    out_xyz.insert(out_xyz.end(), xyz.begin(), xyz.end());
    out_inten.insert(out_inten.end(), inten.begin(), inten.end());
    out_stamps.insert(out_stamps.end(), stamps.begin(), stamps.end());
    ++out_count;
    ++firing_index;
    resetFiring();
  }

  void addPoint(int laser_id, float azimuth_rad, float raw_dist_m,
                uint8_t inty, uint64_t stamp, bool overwrite = false) {
    int ring = cfg.ring[laser_id];
    int row = cfg.num_lasers - ring - 1;  // velodyne_input.hpp:62
    if (row < 0 || row >= cfg.num_lasers) return;
    bool filled = !std::isnan(xyz[row * 3]);
    if (filled && !overwrite) return;  // slot already filled this firing
    if (raw_dist_m <= 0.0f) {  // distance 0 => NaN return (velodyne_input.hpp:56)
      if (!filled) {
        stamps[row] = stamp;
        ++points_in_firing;
      }
      return;
    }
    float va = cfg.vert_angle[laser_id];
    float cv = std::cos(va), sv = std::sin(va);
    // velodyne rot_correction is SUBTRACTED from the raw azimuth:
    // cos/sin(az - rot_correction) via the angle-difference identities
    // (velodyne_pointcloud rawdata unpack math)
    float rc = cfg.azimuth_offset[laser_id];
    float craw = std::cos(azimuth_rad), sraw = std::sin(azimuth_rad);
    float crc = std::cos(rc), src = std::sin(rc);
    float ca = craw * crc + sraw * src;  // cos(az - rc)
    float sa = sraw * crc - craw * src;  // sin(az - rc)
    float vo = cfg.vert_offset[laser_id];
    float ho = cfg.horiz_offset[laser_id];
    float dc = cfg.dist_correction[laser_id];
    float dist = raw_dist_m + dc;
    float corr_x = 0.0f, corr_y = 0.0f;
    if (cfg.two_pt[laser_id]) {
      // two-point calibration: distance correction interpolated between the
      // near anchors (2.40 m for x, 1.93 m for y) and the far anchor 25.04 m
      float xy = dist * cv - vo * sv;
      float xx = std::fabs(xy * sa - ho * ca);
      float yy = std::fabs(xy * ca + ho * sa);
      float dcx = cfg.dist_correction_x[laser_id];
      float dcy = cfg.dist_correction_y[laser_id];
      corr_x = (dc - dcx) * (xx - kTwoPtAnchorX) / (kTwoPtFar - kTwoPtAnchorX)
               + dcx - dc;
      corr_y = (dc - dcy) * (yy - kTwoPtAnchorY) / (kTwoPtFar - kTwoPtAnchorY)
               + dcy - dc;
    }
    float dist_x = dist + corr_x;
    float dist_y = dist + corr_y;
    // velodyne-frame coordinates, then the ROS frame switch
    // (x_out = y_v, y_out = -x_v, z_out = z_v)
    float xv = (dist_x * cv - vo * sv) * sa - ho * ca;
    float yv = (dist_y * cv - vo * sv) * ca + ho * sa;
    float zv = dist_y * sv + vo * cv;
    xyz[row * 3 + 0] = yv;
    xyz[row * 3 + 1] = -xv;
    xyz[row * 3 + 2] = zv;
    inten[row] = inty;
    stamps[row] = stamp;
    if (!filled) ++points_in_firing;
  }

  void maybeEmit() {
    if (points_in_firing > 0) emitFiring();
  }

  // VLP-16: 2 firings of 16 lasers per block, azimuth interpolated across
  // the block from the gap to the next (distinct-azimuth) block.
  void decodeVlp16(const uint8_t* data, const uint16_t* az, bool dual,
                   uint64_t stamp) {
    float last_diff = 0.0f;
    int step = dual ? 2 : 1;
    for (int b = 0; b < kBlocksPerPacket; b += step) {
      float diff;
      if (b + step < kBlocksPerPacket) {
        int d = static_cast<int>(az[b + step]) - static_cast<int>(az[b]);
        diff = static_cast<float>((36000 + d) % 36000);
        // angle-overflow guard (velodyne_pointcloud: negative raw diff
        // means a wrapped/bogus reading; reuse the previous gap)
        if (d < 0) diff = last_diff;
        last_diff = diff;
      } else {
        diff = last_diff;
      }
      int passes = dual ? 2 : 1;
      for (int firing = 0; firing < 2; ++firing) {
        for (int pass = 0; pass < passes; ++pass) {
          int blk = b + pass;  // dual pairs report the same azimuth
          const uint8_t* block = data + blk * 100;
          uint16_t flag = static_cast<uint16_t>(block[0] | (block[1] << 8));
          if (flag != 0xEEFF) continue;
          for (int dsr = 0; dsr < 16; ++dsr) {
            const uint8_t* p = block + 4 + (firing * 16 + dsr) * 3;
            uint16_t ticks = static_cast<uint16_t>(p[0] | (p[1] << 8));
            float az_ticks =
                static_cast<float>(az[b]) +
                diff * (dsr * kVlp16DsrToffset + firing * kVlp16FiringToffset) /
                    kVlp16BlockDuration;
            if (az_ticks >= 36000.0f) az_ticks -= 36000.0f;
            uint64_t t = stamp + static_cast<uint64_t>(
                                     (b * kChannelsPerBlock + firing * 16 + dsr) *
                                     cfg.firing_cycle_ns / kChannelsPerBlock);
            // in dual mode the second (strongest-return) block overwrites
            // the first when it carries a valid return
            addPoint(dsr, az_ticks * kDegTicksToRad,
                     ticks * cfg.distance_resolution, p[2], t,
                     /*overwrite=*/pass == 1 && ticks > 0);
          }
        }
        maybeEmit();
      }
    }
  }

  // Decode one 1206-byte packet; stamp in ns.
  void decodePacket(const uint8_t* data, int64_t size, uint64_t stamp) {
    // factory byte 1204: return mode (0x37 strongest / 0x38 last / 0x39 dual)
    bool dual = size >= 1206 && data[1204] == kReturnModeDual;
    uint16_t az[kBlocksPerPacket];
    for (int b = 0; b < kBlocksPerPacket; ++b) {
      const uint8_t* block = data + b * 100;
      az[b] = static_cast<uint16_t>(block[2] | (block[3] << 8));
    }
    if (cfg.num_lasers == 16) {
      decodeVlp16(data, az, dual, stamp);
      return;
    }
    // 32+ lasers: the block azimuth applies to the whole block (matches
    // velodyne_pointcloud's generic unpack()).  Dual-return pairing is
    // supported for 32-laser models; VLS-128 dual has model-specific
    // banking the reference's parser also does not cover generically.
    bool dual_pair = dual && cfg.num_lasers == 32;
    int blocks_per_firing =
        (cfg.num_lasers + kChannelsPerBlock - 1) / kChannelsPerBlock;
    for (int b = 0; b < kBlocksPerPacket; ++b) {
      const uint8_t* block = data + b * 100;
      uint16_t flag = static_cast<uint16_t>(block[0] | (block[1] << 8));
      // bank flags: 0xEEFF lasers 0-31, 0xDDFF 32-63, 0xCCFF 64-95 and
      // 0xBBFF 96-127 (VLS-128)
      int bank;
      switch (flag) {
        case 0xEEFF: bank = 0; break;
        case 0xDDFF: bank = 32; break;
        case 0xCCFF: bank = 64; break;
        case 0xBBFF: bank = 96; break;
        default: continue;
      }
      float azimuth = static_cast<float>(az[b]) * kDegTicksToRad;
      bool overwrite_pass = dual_pair && (b % 2 == 1);
      // dual pairs are simultaneous: timestamp from the pair's first block
      int tb = dual_pair ? (b & ~1) : b;
      for (int ch = 0; ch < kChannelsPerBlock; ++ch) {
        const uint8_t* p = block + 4 + ch * 3;
        uint16_t ticks = static_cast<uint16_t>(p[0] | (p[1] << 8));
        float dist = ticks * cfg.distance_resolution;
        uint64_t t = stamp + static_cast<uint64_t>(
                                 (tb * kChannelsPerBlock + ch) *
                                 cfg.firing_cycle_ns / kChannelsPerBlock);
        int laser_id = bank + ch;
        if (laser_id >= cfg.num_lasers) break;
        addPoint(laser_id, azimuth, dist, p[2], t,
                 overwrite_pass && ticks > 0);
      }
      // a firing completes when all banks of one azimuth step were seen
      // (in dual-pair mode: when both returns of the pair were seen)
      bool complete = dual_pair ? (b % 2 == 1)
                                : ((b + 1) % blocks_per_firing == 0);
      if (complete) maybeEmit();
    }
  }
};

}  // namespace

extern "C" {

void* cct_velodyne_create(int num_lasers, float distance_resolution,
                          const float* vert_angles_rad,
                          const float* azimuth_offsets_rad,
                          const int32_t* rings, double firing_cycle_ns) {
  Config c;
  c.num_lasers = num_lasers;
  c.distance_resolution = distance_resolution;
  c.vert_angle.assign(vert_angles_rad, vert_angles_rad + num_lasers);
  if (azimuth_offsets_rad)
    c.azimuth_offset.assign(azimuth_offsets_rad, azimuth_offsets_rad + num_lasers);
  else
    c.azimuth_offset.assign(num_lasers, 0.0f);
  if (rings) {
    c.ring.assign(rings, rings + num_lasers);
  } else {
    c.ring.resize(num_lasers);
    for (int i = 0; i < num_lasers; ++i) c.ring[i] = i;
  }
  c.firing_cycle_ns = firing_cycle_ns;
  return new Decoder(std::move(c));
}

// Install the remaining velodyne_pointcloud per-laser correction terms
// (meters).  Any pointer may be null to keep that term at zero.
void cct_velodyne_set_corrections(void* h, const float* dist_correction,
                                  const float* dist_correction_x,
                                  const float* dist_correction_y,
                                  const float* vert_offset,
                                  const float* horiz_offset,
                                  const uint8_t* two_pt) {
  auto* d = static_cast<Decoder*>(h);
  int n = d->cfg.num_lasers;
  if (dist_correction) d->cfg.dist_correction.assign(dist_correction, dist_correction + n);
  if (dist_correction_x) d->cfg.dist_correction_x.assign(dist_correction_x, dist_correction_x + n);
  if (dist_correction_y) d->cfg.dist_correction_y.assign(dist_correction_y, dist_correction_y + n);
  if (vert_offset) d->cfg.vert_offset.assign(vert_offset, vert_offset + n);
  if (horiz_offset) d->cfg.horiz_offset.assign(horiz_offset, horiz_offset + n);
  if (two_pt) d->cfg.two_pt.assign(two_pt, two_pt + n);
}

void cct_velodyne_destroy(void* h) { delete static_cast<Decoder*>(h); }

void cct_velodyne_decode(void* h, const uint8_t* packet, int64_t size,
                         uint64_t stamp_ns) {
  if (size >= 1200) static_cast<Decoder*>(h)->decodePacket(packet, size, stamp_ns);
}

// Poll completed firings; returns count and copies into caller buffers sized
// max_firings * num_lasers.  Buffers: xyz (f32 x3), intensity, stamps.
int cct_velodyne_poll(void* h, int max_firings, float* xyz, uint8_t* inten,
                      uint64_t* stamps) {
  auto* d = static_cast<Decoder*>(h);
  int n = d->out_count < max_firings ? d->out_count : max_firings;
  size_t rows = static_cast<size_t>(d->cfg.num_lasers);
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
