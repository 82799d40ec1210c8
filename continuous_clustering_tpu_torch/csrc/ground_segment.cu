// Ground segmentation of one step's batch of ring columns, in one launch.
//
// Replaces no TPU kernel: the JAX package segments with two lax.scan passes
// over the rows (continuous_clustering_tpu/ops/ground_segmentation.py), and
// the port's plain twin (ops/ground_segmentation.py,
// ground_segment_columns_reference) runs them as Python loops of about a
// hundred small tensor operations a row.  This kernel computes what the twin
// computes, bit for bit, for the columns [gcol0, gcol0 + n_cols) of a batch
// of B:
//
//   1. the inclination diffs of each row (inc[r] - inc[r + 1], the bottom row
//      against 0), forward-filled across the batch's columns from the carry
//      `incl_in` (the last valid diff of the previous steps), NaN where
//      nothing valid came before; the carry after the batch goes to
//      `incl_out` where n_cols > 0;
//   2. the classification pass, bottom row to top, per column: skip (NaN,
//      fog, ego vehicle), first point as ground or obstacle, green /
//      yellow-green / yellow ground, obstacle; the supplied inclination of
//      NaN cells;
//   3. the backtrack pass, per column: each obstacle event (debug RED) at row
//      r relabels the contiguous run of qualifying rows below it, as earlier
//      events left them, GROUND -> OBSTACLE / DARKRED;
//   4. is_ignored, and the continuous azimuth of NaN cells.
//
// It reads and writes the ring in place (rows rc apart, the batch's column b
// at ring column (gcol0 mod rc + b) mod rc) and writes only where b < n_cols,
// as the twin's masked ring_put does.  gcol0 and n_cols are read on the
// device: the host reads nothing back.
//
// Arithmetic as the twin's (built with --fmad=false, so nothing is
// contracted): the twin's fma32 is a f64 product (exact) plus a f64 sum
// rounded to f32, for xy_distance's fma(xr, xr, yr * yr) and ego_frame's two
// nested multiply-adds per row of the rotation; d is (float)sqrt((double)..);
// the inclination gate is (float)atan2((double)max_distance_f32,
// (double)dist); every threshold arrives rounded to f32 once, as a
// tensor-against-Python-float comparison rounds it; NaN compares false.
//
// Design: one block; one thread per column walks the R rows with the
// recurrence in registers.  Column tiles of up to 512 threads run one after
// another, the fill's carry passed from tile to tile in shared memory, so
// any B works (the main path's B is 160-416).  The fill is a warp scan of
// "last non-NaN" by shuffles, then one thread per row scans the warps' totals.
// The filled diffs and d go to global scratch (R x B each), since R = 128
// rows of them do not fit in registers; labels, debug labels and events live
// in the ring cells being written (an event is a debug RED: the backtrack
// never writes RED and never rewrites a RED cell).
//
// What bounds it on the card: R serial row steps per thread on one SM, each a
// handful of dependent loads from L2 or HBM.  At R = 64, B = 416 it moves
// about 1.1 MB of ring cells, 0.34 us at the HBM rate, and takes about
// 0.16 ms on an H100 (0.30 ms at R = 128, B = 288): the row latency sets its
// time, not the bytes.  That is under 1 % of a step, against the ~7,000
// launches a step of the row loops it replaces.

#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr unsigned kAllLanes = 0xffffffffu;

// label values, as constants.py has them
constexpr int kGpUnknown = 143, kGpGround = 54, kGpObstacle = 119, kGpEgo = 85, kGpFog = 71;
constexpr int kDbgWhite = 143, kDbgGray = 53, kDbgGreen = 54, kDbgYellowGreen = 146,
              kDbgYellow = 145, kDbgOrange = 105, kDbgRed = 119, kDbgDarkRed = 32,
              kDbgViolet = 141, kDbgLightGray = 71;

// the switches of the configuration (flags)
constexpr int kSupplement = 1, kFog = 2, kTerrain = 4, kGate = 8, kChessboard = 16;

// thresholds, each rounded to f32 once (fparams, in this order)
struct Params {
  float max_slope, first_min_z, first_max_z, lg_slope_above, lg_dist_below, close_z, close_d,
      next_obstacle_d;
  float ego_front, ego_rear, ego_left, ego_right, ego_top, ego_bottom;
  float fog_dist, fog_incl, max_distance, az_width;
  // iparams, in this order
  int fog_intensity, num_cols, flags;
  int sp0, sp1, er0, er1, er2, et0, et1;  // element strides of the per-column poses
};
constexpr int kNumF = 18, kNumI = 10;

// (R, rc) ring fields, row-major
struct Ring {
  const float *x, *y, *z, *dist;
  const int* intensity;
  float *inclination, *cont_az;
  int *gcol, *ground_label, *debug_label;
  unsigned char* is_ignored;
};

struct Step {
  const int *gcol0, *n_cols, *origin_rot;   // () i32
  const float *sensor_pos, *ego_rot, *ego_trans, *hsg;
  const float* incl_in;          // (R,) the fill's carry in
  float* incl_out;               // (R,) and out
  const unsigned char* ovf_in;   // () the overflow flag in
  unsigned char* ovf_out;        // and out
  float* scratch;                // (2, R, B): the filled diffs, d
};
constexpr int kNumPtrs = 23;

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// float("nan") where the twin makes a NaN of its own, the value elsewhere
__device__ __forceinline__ float canonical(float v) { return isnan(v) ? nan_f32() : v; }

// the twin's fma32: f32 a * b + c, the product exact in f64, the f64 sum
// rounded to f32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

__global__ void __launch_bounds__(kMaxThreads)
ground_segment_kernel(Ring g, Step s, Params p, int R, int B, int rc) {
  extern __shared__ float smem[];
  __shared__ int overflow;
  const int T = blockDim.x, nw = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* part = smem;            // (R, nw): each warp's total, then its exclusive prefix
  float* carry = smem + R * nw;  // (R,): the fill carried into the next tile
  float* filled_d = s.scratch;   // (R, B): the warp-scanned diffs
  float* dsc = s.scratch + R * B;  // (R, B): d
  const int gcol0 = *s.gcol0;
  const int n = min(max(*s.n_cols, 0), B);
  const int lc0 = ((gcol0 % rc) + rc) % rc;
  for (int r = tid; r < R; r += T) carry[r] = s.incl_in[r];
  if (tid == 0) overflow = 0;
  __syncthreads();

  for (int t0 = 0; t0 < B; t0 += T) {
    const int b = t0 + tid;
    const int c = (lc0 + b) % rc;
    const bool valid = b < n;

    // ---- 1. the forward fill of the inclination diffs --------------------
    for (int r = 0; r < R; ++r) {
      float v = nan_f32();
      if (valid) {
        const float below = r + 1 < R ? g.inclination[(r + 1) * rc + c] : 0.0f;
        v = g.inclination[r * rc + c] - below;
      }
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const float u = __shfl_up_sync(kAllLanes, v, k);
        if (lane >= k && isnan(v)) v = u;
      }
      if (b < B) filled_d[r * B + b] = v;
      if (lane == 31) part[r * nw + warp] = v;
    }
    __syncthreads();
    for (int r = tid; r < R; r += T) {
      float acc = carry[r];
      for (int w = 0; w < nw; ++w) {
        const float v = part[r * nw + w];
        part[r * nw + w] = acc;
        if (!isnan(v)) acc = v;
      }
      carry[r] = acc;
    }
    __syncthreads();

    if (valid) {
      auto filled = [&](int r) {
        const float v = filled_d[r * B + b];
        return isnan(v) ? canonical(part[r * nw + warp]) : v;
      };
      const int col = gcol0 + b;
      const float sx = s.sensor_pos[b * p.sp0], sy = s.sensor_pos[b * p.sp0 + p.sp1],
                  sz = s.sensor_pos[b * p.sp0 + 2 * p.sp1];
      float er[3][3], et[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        et[i] = s.ego_trans[b * p.et0 + i * p.et1];
#pragma unroll
        for (int j = 0; j < 3; ++j) er[i][j] = s.ego_rot[b * p.er0 + i * p.er1 + j * p.er2];
      }
      const float hsg = *s.hsg;
      const int gcol_rel = static_cast<int>(static_cast<unsigned>(col) -
                                            static_cast<unsigned>(*s.origin_rot) *
                                                static_cast<unsigned>(p.num_cols));
      const float nan_az = (static_cast<float>(gcol_rel) + 0.5f) * p.az_width;
      const bool terrain = p.flags & kTerrain;

      // ---- 2. classification, bottom (r = R - 1) to top (r = 0) ---------
      bool first_found = false, first_obst = false, ovf = false;
      float lg_d = 0.0f, lg_z = hsg, prev_d = 0.0f, prev_z = 0.0f;
      float inc_below_stored = nan_f32();
      int prev_label = kDbgWhite;
      for (int r = R - 1; r >= 0; --r) {
        const int i = r * rc + c;
        const float dist = g.dist[i], inc_raw = g.inclination[i];
        const float xs = g.x[i], ys = g.y[i], zs = g.z[i];
        const int gc = g.gcol[i];
        ovf |= gc != -1 && gc != col;
        const bool cell_nan = isnan(dist);
        const float xr = xs - sx, yr = ys - sy;
        const float d = static_cast<float>(sqrt(static_cast<double>(fma32(xr, xr, yr * yr))));
        dsc[r * B + b] = d;
        const float z = zs - sz;

        bool fog = false;
        if (p.flags & kFog) {
          fog = !cell_nan && g.intensity[i] < p.fog_intensity && dist < p.fog_dist &&
                inc_raw > p.fog_incl;
        }
        float pe[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          pe[k] = fma32(er[k][2], zs, fma32(er[k][0], xs, er[k][1] * ys)) + et[k];
        const bool ego = !cell_nan && !fog && pe[0] < p.ego_front && pe[0] > p.ego_rear &&
                         pe[1] < p.ego_left && pe[1] > p.ego_right && pe[2] < p.ego_top &&
                         pe[2] > p.ego_bottom;

        const float supplied = ((p.flags & kSupplement) && r != R - 1)
                                   ? inc_below_stored + filled(r) : nan_f32();
        const float inc_stored = cell_nan ? supplied : inc_raw;

        const bool skip = cell_nan || fog || ego;
        const bool is_first = !first_found && !skip;
        const float hog = z - hsg;
        const bool first_ground = is_first && hog > p.first_min_z && hog < p.first_max_z;
        const bool first_obstacle = is_first && !first_ground;
        const bool normal = first_found && !skip;
        const float dxp = d - prev_d, dzp = z - prev_z;
        const float slope_prev = dzp / dxp;
        bool flat_prev = fabsf(slope_prev) < p.max_slope && dxp > 0.0f;
        if (terrain) flat_prev = flat_prev && dxp < 5.0f;
        const float dxl = d - lg_d, dzl = z - lg_z;
        const float slope_lg = dzl / dxl;
        const bool flat_lg = fabsf(slope_lg) < p.max_slope && dxl > 0.0f;

        const bool green = normal && !first_obst && flat_prev;
        bool yellowgreen = false, yellow = false;
        if (!terrain) {
          yellowgreen = normal && !green && first_obst && flat_prev && flat_lg;
          yellow = normal && !green && !yellowgreen && fabsf(dxl) < p.close_d &&
                   fabsf(dzl) < p.close_z;
        }
        const bool ground = green || yellowgreen || yellow || first_ground;
        const bool obstacle = (normal && !ground) || first_obstacle;

        const int label = fog ? kGpFog : ego ? kGpEgo : ground ? kGpGround
                          : obstacle ? kGpObstacle : kGpUnknown;
        const int dbg = fog ? kDbgLightGray : ego ? kDbgViolet : first_ground ? kDbgGray
                        : first_obstacle ? kDbgOrange : green ? kDbgGreen
                        : yellowgreen ? kDbgYellowGreen : yellow ? kDbgYellow
                        : obstacle ? kDbgRed : kDbgWhite;
        g.ground_label[i] = label;
        g.debug_label[i] = dbg;
        g.inclination[i] = inc_stored;
        g.gcol[i] = col;
        if (cell_nan) g.cont_az[i] = nan_az;

        const bool update_lg = ((green || yellowgreen) && slope_prev > p.lg_slope_above &&
                                fabsf(dxp) < p.lg_dist_below && prev_label != kDbgYellow) ||
                               first_ground;
        if (update_lg) {
          lg_d = d;
          lg_z = z;
        }
        first_obst = is_first ? first_obstacle : (first_obst || (normal && obstacle));
        first_found = first_found || !skip;
        if (!skip) {
          prev_d = d;
          prev_z = z;
          prev_label = dbg;
        }
        inc_below_stored = inc_stored;
      }
      if (ovf) atomicOr(&overflow, 1);

      // ---- 3. backtrack: close lower ground below an obstacle event ------
      for (int r = R - 2; r >= 0; --r) {
        if (g.debug_label[r * rc + c] != kDbgRed) continue;
        const float d0 = dsc[r * B + b];
        for (int k = r + 1; k < R; ++k) {
          const int i = k * rc + c;
          const int lab = g.ground_label[i];
          const bool cont = g.debug_label[i] == kDbgYellow ||
                            (lab == kGpGround && fabsf(d0 - dsc[k * B + b]) < p.next_obstacle_d);
          if (!cont) break;
          if (lab == kGpGround) {
            g.ground_label[i] = kGpObstacle;
            g.debug_label[i] = kDbgDarkRed;
          }
        }
      }

      // ---- 4. is_ignored ---------------------------------------------------
      const bool even_col = col % 2 == 0;
      for (int r = 0; r < R; ++r) {
        const int i = r * rc + c;
        const float dist = g.dist[i];
        bool ignored = isnan(dist) || g.ground_label[i] != kGpObstacle || dist < p.max_distance;
        if ((p.flags & kGate) && r < R - 1)
          ignored = ignored || static_cast<float>(atan2(static_cast<double>(p.max_distance),
                                                        static_cast<double>(dist))) < filled(r);
        if (p.flags & kChessboard) ignored = ignored || (even_col != (r % 2 == 0));
        g.is_ignored[i] = ignored;
      }
    }
    __syncthreads();  // the next tile rewrites part
  }

  for (int r = tid; r < R; r += T) s.incl_out[r] = n > 0 ? canonical(carry[r]) : s.incl_in[r];
  if (tid == 0) *s.ovf_out = (*s.ovf_in != 0 || overflow != 0) ? 1 : 0;
}

}  // namespace

// ptrs: the Ring fields in their order (x, y, z, distance, intensity,
// inclination, cont_az, gcol, ground_label, debug_label, is_ignored), then
// the Step fields in theirs; fparams and iparams as Params lists them.
extern "C" int cct_ground_segment(void* const* ptrs, const float* fparams, const int* iparams,
                                  int R, int B, int rc, void* stream) {
  static LaunchCache cache;
  if (R < 1 || B < 1 || B > rc) return static_cast<int>(cudaErrorInvalidValue);
  Ring g;
  g.x = static_cast<const float*>(ptrs[0]);
  g.y = static_cast<const float*>(ptrs[1]);
  g.z = static_cast<const float*>(ptrs[2]);
  g.dist = static_cast<const float*>(ptrs[3]);
  g.intensity = static_cast<const int*>(ptrs[4]);
  g.inclination = static_cast<float*>(ptrs[5]);
  g.cont_az = static_cast<float*>(ptrs[6]);
  g.gcol = static_cast<int*>(ptrs[7]);
  g.ground_label = static_cast<int*>(ptrs[8]);
  g.debug_label = static_cast<int*>(ptrs[9]);
  g.is_ignored = static_cast<unsigned char*>(ptrs[10]);
  Step s;
  s.gcol0 = static_cast<const int*>(ptrs[11]);
  s.n_cols = static_cast<const int*>(ptrs[12]);
  s.origin_rot = static_cast<const int*>(ptrs[13]);
  s.sensor_pos = static_cast<const float*>(ptrs[14]);
  s.ego_rot = static_cast<const float*>(ptrs[15]);
  s.ego_trans = static_cast<const float*>(ptrs[16]);
  s.hsg = static_cast<const float*>(ptrs[17]);
  s.incl_in = static_cast<const float*>(ptrs[18]);
  s.incl_out = static_cast<float*>(ptrs[19]);
  s.ovf_in = static_cast<const unsigned char*>(ptrs[20]);
  s.ovf_out = static_cast<unsigned char*>(ptrs[21]);
  s.scratch = static_cast<float*>(ptrs[22]);
  static_assert(kNumPtrs == 23, "ptrs as listed above");
  Params p;
  float* pf[kNumF] = {&p.max_slope, &p.first_min_z, &p.first_max_z, &p.lg_slope_above,
                      &p.lg_dist_below, &p.close_z, &p.close_d, &p.next_obstacle_d,
                      &p.ego_front, &p.ego_rear, &p.ego_left, &p.ego_right, &p.ego_top,
                      &p.ego_bottom, &p.fog_dist, &p.fog_incl, &p.max_distance,
                      &p.az_width};
  for (int k = 0; k < kNumF; ++k) *pf[k] = fparams[k];
  int* pi[kNumI] = {&p.fog_intensity, &p.num_cols, &p.flags, &p.sp0, &p.sp1,
                    &p.er0, &p.er1, &p.er2, &p.et0, &p.et1};
  for (int k = 0; k < kNumI; ++k) *pi[k] = iparams[k];

  const int threads = B < kMaxThreads ? (B + 31) / 32 * 32 : kMaxThreads;
  const int smem = R * (threads / 32 + 1) * static_cast<int>(sizeof(float));
  const cudaError_t err = prepare_launch(reinterpret_cast<const void*>(ground_segment_kernel),
                                         cache, smem, threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ground_segment_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(g, s, p, R, B,
                                                                                 rc);
  return static_cast<int>(cudaGetLastError());
}
