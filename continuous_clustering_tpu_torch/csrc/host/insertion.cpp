// Host-side continuous range-image construction (stage A fast path).
//
// Exact re-derivation of the reference insertion semantics
// (src/clustering/continuous_clustering.cpp:105-292) as a standalone C++
// component producing *dense column blocks* for device upload: azimuth ->
// continuous column unwrap with rotation disambiguation, next-column
// collision shift, nearer-point priority, behind-frontier drop, and
// rearmost/foremost laser tracking.  This is the pointer-chasing part of the
// pipeline that belongs on the host CPU; the device consumes dense blocks.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace cct {

struct Cell {
  float x, y, z;
  float distance;
  float azimuth;
  float inclination;
  double cont_az;
  int64_t gcol;
  uint64_t stamp;
  uint64_t uidx;
  uint8_t intensity;
};

static const float kNaN = std::numeric_limits<float>::quiet_NaN();

class Insertion {
 public:
  Insertion(int num_rows, int num_columns, int ring_factor, bool clockwise)
      : num_rows_(num_rows),
        num_columns_(num_columns),
        ring_cols_(num_columns * ring_factor),
        clockwise_(clockwise),
        az_width_(static_cast<float>(2.0 * M_PI) / static_cast<float>(num_columns)) {
    cells_.resize(static_cast<size_t>(ring_cols_) * num_rows_);
    pose_idx_.assign(ring_cols_, -1);
    clearAll();
  }

  void clearAll() {
    for (auto& c : cells_) clearCell(c);
    prev_rearmost_ = 0;
    prev_foremost_ = -1;
    first_unfinished_ = -1;
    init_frontier_ = -1;
    cleared_before_ = 0;
    reset_required_ = false;
  }

  static void clearCell(Cell& c) {
    c.x = c.y = c.z = kNaN;
    c.distance = kNaN;
    c.azimuth = kNaN;
    c.inclination = kNaN;
    c.cont_az = std::nan("");
    c.gcol = -1;
    c.stamp = 0;
    c.uidx = ~0ULL;
    c.intensity = 0;
  }

  // Returns the exclusive end of finished columns after this batch.
  // poses: F x 12 doubles (row-major 3x4 odom_from_sensor).
  int64_t addFirings(int F, const float* xyz, const double* poses,
                     const uint64_t* stamps, const uint64_t* uidx,
                     const uint8_t* intensity, int64_t* out_first,
                     int32_t* out_reset) {
    int64_t first_before = first_unfinished_;
    for (int f = 0; f < F && !reset_required_; ++f) {
      addFiring(xyz + static_cast<size_t>(f) * num_rows_ * 3, poses + f * 12,
                stamps ? stamps + static_cast<size_t>(f) * num_rows_ : nullptr,
                uidx ? uidx + static_cast<size_t>(f) * num_rows_ : nullptr,
                intensity ? intensity + static_cast<size_t>(f) * num_rows_ : nullptr,
                f);
    }
    if (first_before < 0) first_before = init_frontier_;
    *out_first = first_before;
    *out_reset = reset_required_ ? 1 : 0;
    return first_unfinished_;
  }

  // Copy columns [from, to) into dense caller buffers (column-major:
  // field[col * num_rows + row]) and clear nothing.
  void fetchColumns(int64_t from, int64_t to, float* x, float* y, float* z,
                    float* dist, float* az, float* inc, double* caz,
                    uint64_t* stamp, uint64_t* uidxv, uint8_t* inten,
                    int32_t* pose_index) const {
    int64_t n = to - from;
    for (int64_t i = 0; i < n; ++i) {
      int64_t g = from + i;
      int lc = static_cast<int>(g % ring_cols_);
      const Cell* col = &cells_[static_cast<size_t>(lc) * num_rows_];
      for (int r = 0; r < num_rows_; ++r) {
        size_t o = static_cast<size_t>(i) * num_rows_ + r;
        const Cell& c = col[r];
        bool valid = c.gcol == g;
        x[o] = valid ? c.x : kNaN;
        y[o] = valid ? c.y : kNaN;
        z[o] = valid ? c.z : kNaN;
        dist[o] = valid ? c.distance : kNaN;
        az[o] = valid ? c.azimuth : kNaN;
        inc[o] = valid ? c.inclination : kNaN;
        caz[o] = valid ? c.cont_az : std::nan("");
        stamp[o] = valid ? c.stamp : 0;
        uidxv[o] = valid ? c.uidx : ~0ULL;
        inten[o] = valid ? c.intensity : 0;
      }
      if (pose_index) pose_index[i] = pose_idx_[lc];
    }
  }

  // Release columns older than `keep_from` (they may be reused).
  void clearColumnsBefore(int64_t keep_from) {
    for (int64_t g = cleared_before_; g < keep_from; ++g) {
      int lc = static_cast<int>(g % ring_cols_);
      Cell* col = &cells_[static_cast<size_t>(lc) * num_rows_];
      for (int r = 0; r < num_rows_; ++r)
        if (col[r].gcol == g) clearCell(col[r]);
    }
    if (keep_from > cleared_before_) cleared_before_ = keep_from;
  }

  bool resetRequired() const { return reset_required_; }
  int64_t firstUnfinished() const { return first_unfinished_; }

 private:
  void addFiring(const float* xyz, const double* pose, const uint64_t* stamps,
                 const uint64_t* uidx, const uint8_t* intensity, int pose_i) {
    const double sx = pose[3], sy = pose[7], sz = pose[11];
    int64_t foremost = -1, rearmost = -1;
    int64_t prev_rot = prev_rearmost_ / num_columns_;  // …cpp:121
    int64_t col_prev = prev_rearmost_ % num_columns_;
    int half = num_columns_ / 2;

    for (int row = 0; row < num_rows_; ++row) {
      float px = xyz[row * 3], py = xyz[row * 3 + 1], pz = xyz[row * 3 + 2];
      if (std::isnan(px)) continue;
      double ox = pose[0] * px + pose[1] * py + pose[2] * pz + sx;
      double oy = pose[4] * px + pose[5] * py + pose[6] * pz + sy;
      double oz = pose[8] * px + pose[9] * py + pose[10] * pz + sz;
      double rx = ox - sx, ry = oy - sy, rz = oz - sz;

      float azimuth = std::atan2(py, px);  // sensor frame (…cpp:142)
      float inc_az = clockwise_ ? -azimuth + static_cast<float>(M_PI)
                                : azimuth + static_cast<float>(M_PI);
      int col = static_cast<int>(inc_az / az_width_);
      int64_t gcol = prev_rot * num_columns_ + col;
      int diff = col - static_cast<int>(col_prev);
      int rot_off = 0;
      if (diff < -half) {  // …cpp:161
        gcol += num_columns_;
        rot_off = 1;
      } else if (prev_rearmost_ > 0 && diff > half) {  // …cpp:166
        gcol -= num_columns_;
        rot_off = -1;
      }

      int lc = static_cast<int>(gcol % ring_cols_);
      Cell* cell = &cells_[static_cast<size_t>(lc) * num_rows_ + row];
      double cont_az = (2.0 * M_PI) * static_cast<double>(prev_rot + rot_off) +
                       static_cast<double>(inc_az);
      float distance =
          static_cast<float>(std::sqrt(rx * rx + ry * ry + rz * rz));

      if (!std::isnan(cell->distance) && !std::isnan(distance)) {  // …cpp:190
        int nlc = lc + 1 >= ring_cols_ ? 0 : lc + 1;
        Cell* next = &cells_[static_cast<size_t>(nlc) * num_rows_ + row];
        if (std::isnan(next->distance)) {
          cell = next;
          lc = nlc;
          ++gcol;
        }
      }
      if (!std::isnan(cell->distance) &&
          (std::isnan(distance) || distance >= cell->distance))
        continue;  // nearer point stays; NOT tracked (…cpp:205-206)

      bool behind = first_unfinished_ >= 0 && gcol < first_unfinished_;
      if (!behind) {
        cell->x = static_cast<float>(ox);
        cell->y = static_cast<float>(oy);
        cell->z = static_cast<float>(oz);
        cell->distance = distance;
        cell->azimuth = azimuth;
        cell->inclination =
            std::asin(static_cast<float>(rz) / distance);
        cell->cont_az = cont_az;
        cell->gcol = gcol;
        cell->stamp = stamps ? stamps[row] : 0;
        cell->uidx = uidx ? uidx[row] : ~0ULL;
        cell->intensity = intensity ? intensity[row] : 0;
        pose_idx_[lc] = pose_i;
      }

      if (rearmost < 0 || gcol < rearmost) rearmost = gcol;  // …cpp:241
      if (foremost < 0 || gcol > foremost) foremost = gcol;
    }

    if (rearmost >= 0 && foremost >= 0) {
      if ((foremost - rearmost) > half) {  // …cpp:252
        reset_required_ = true;
        return;
      }
      if (rearmost > prev_rearmost_) prev_rearmost_ = rearmost;
      if (foremost > prev_foremost_) prev_foremost_ = foremost;
    }
    if (prev_foremost_ < 0) return;
    if (init_frontier_ < 0) init_frontier_ = prev_rearmost_;
    if (first_unfinished_ == -1) first_unfinished_ = prev_rearmost_;
    if (first_unfinished_ < prev_rearmost_) {
      // pose of the firing that finishes these columns (…cpp:289-291): the
      // segmentation job carries the *current* firing's pose
      for (int64_t g = first_unfinished_; g < prev_rearmost_; ++g) {
        int lc = static_cast<int>(g % ring_cols_);
        pose_idx_[lc] = pose_i;
      }
      first_unfinished_ = prev_rearmost_;
    }
  }

  int num_rows_, num_columns_, ring_cols_;
  bool clockwise_;
  float az_width_;
  std::vector<Cell> cells_;
  std::vector<int32_t> pose_idx_;
  int64_t prev_rearmost_ = 0;
  int64_t prev_foremost_ = -1;
  int64_t first_unfinished_ = -1;
  int64_t init_frontier_ = -1;
  int64_t cleared_before_ = 0;
  bool reset_required_ = false;
};

}  // namespace cct

// ----------------------------------------------------------------- C API
extern "C" {

void* cct_insertion_create(int num_rows, int num_columns, int ring_factor,
                           int clockwise) {
  return new cct::Insertion(num_rows, num_columns, ring_factor,
                            clockwise != 0);
}

void cct_insertion_destroy(void* h) { delete static_cast<cct::Insertion*>(h); }

int64_t cct_insertion_add_firings(void* h, int F, const float* xyz,
                                  const double* poses, const uint64_t* stamps,
                                  const uint64_t* uidx,
                                  const uint8_t* intensity, int64_t* out_first,
                                  int32_t* out_reset) {
  return static_cast<cct::Insertion*>(h)->addFirings(
      F, xyz, poses, stamps, uidx, intensity, out_first, out_reset);
}

void cct_insertion_fetch_columns(void* h, int64_t from, int64_t to, float* x,
                                 float* y, float* z, float* dist, float* az,
                                 float* inc, double* caz, uint64_t* stamp,
                                 uint64_t* uidxv, uint8_t* inten,
                                 int32_t* pose_index) {
  static_cast<cct::Insertion*>(h)->fetchColumns(
      from, to, x, y, z, dist, az, inc, caz, stamp, uidxv, inten, pose_index);
}

void cct_insertion_clear_before(void* h, int64_t keep_from) {
  static_cast<cct::Insertion*>(h)->clearColumnsBefore(keep_from);
}

void cct_insertion_reset(void* h) { static_cast<cct::Insertion*>(h)->clearAll(); }
}
