// KITTI rasterization fast path: the order-dependent collision-shift loop
// (reference generateRangeImage, src/evaluation/kitti_loader.cpp:101-175)
// and laser-index recovery (…cpp:48-99) in C++ for full-dataset runs.

#include <cmath>
#include <cstdint>

extern "C" {

// xyz4: n x 4 floats (x, y, z, i).  out_image: num_lasers*width int64 preset
// by caller to -1; receives original point indices.
void cct_generate_range_image(int64_t n, const float* xyz4,
                              const int32_t* laser, int width, int num_lasers,
                              int shift_if_occupied, int64_t* out_image) {
  const double col_width = (2.0 * M_PI) / width;
  for (int64_t i = 0; i < n; ++i) {
    double az = std::atan2(xyz4[i * 4 + 1], xyz4[i * 4]);
    int col = static_cast<int>((M_PI - az) / col_width);
    if (col == width) --col;  // exact -pi case (…cpp:126-127)
    int64_t flat = static_cast<int64_t>(laser[i]) * width + col;
    if (shift_if_occupied && out_image[flat] >= 0) {
      if (col + 1 < width && out_image[flat + 1] < 0) {
        flat += 1;
      } else if (col - 1 >= 0 && out_image[flat - 1] < 0) {
        flat -= 1;
      }
    }
    out_image[flat] = i;
  }
}

// Laser-row recovery by monotonic-azimuth backjumps (…cpp:48-99).
// Returns the number of recovered rows.
int32_t cct_recover_laser_indices(int64_t n, const float* xyz4, int num_lasers,
                                  int32_t* out_laser) {
  int laser = 0;
  double prev = -1.0;
  for (int64_t i = 0; i < n; ++i) {
    double az = std::atan2(xyz4[i * 4 + 1], xyz4[i * 4]);
    double mono = az < 0 ? az + 2.0 * M_PI : az;
    if (prev >= 0 && mono - prev < -0.7) {
      ++laser;
      if (laser >= num_lasers) {
        // remaining points keep the default row (reference break, …cpp:75-76)
        for (int64_t j = i; j < n; ++j) out_laser[j] = 0;
        return num_lasers;
      }
    }
    out_laser[i] = laser;
    prev = mono;
  }
  return laser + 1;
}
}
