// K1: wedge neighbour search -> forward edge bitmasks.
//
// Replaces edge_bits_pallas / _edge_bits_kernel
// (continuous_clustering_tpu/ops/cc_pallas.py).  For batch point (r, b),
// column offset dc <= min(wp, H) and row offset dr in [-V, V], bit dr + V of
// bits[dc][word][r][b] is set iff
//   * the inclination walk reaches dr without a break: the test is
//     !(|inc(neighbour) - inc(point)| > mad), applied as a prefix AND; the up
//     walk starts at ok(-1) when dc == 0 and at ok(0) otherwise; the down
//     walk and dr == 0 exist only for dc > 0; NaN never breaks the walk;
//   * |dxyz|^2 < max_d2, summed as (dx*dx + dy*dy) + dz*dz without FMA
//     contraction, the plain twin's order;
//   * both cells are active, and dc <= wp.
// Rows outside [0, R) are NaN and inactive, as the Pallas padding makes them.
//
// Design: one thread per (batch point, column offset), so the 21 walks of a
// point run side by side.  A block of kThreads covers a tile of kTileB batch
// columns x kTileR rows of batch points (416 blocks at R = 64, B = 416);
// it first stages the window cells that the
// tile's walks can reach (rows r0 - V .. r0 + kTileR + V - 1 within the
// window, columns b0 .. b0 + kTileB + H - 1) in shared memory: x, y, z,
// inclination and the active byte, 17 bytes a cell, loaded coalesced along
// the row.  Every walk step then reads shared memory only.  The bits of one
// (dc, r) go out as kTileB consecutive words.
//
// Streams: the launch takes S windows stacked along a leading axis (the
// multi-sensor step launches K1 once for all its streams); blockIdx.z is the
// stream, and every pointer offsets by that stream's plane.  A single window
// is the S = 1 case.
//
// What bounds it on the card: at R = 64, B = 416, H = V = 20 it writes
// 4.5 MB of bits (mostly zero words) and reads 0.5 MB of window, 1.5 us at
// the HBM rate.  The walks are short compare chains in shared memory; on a
// dense window (20,000 active cells) they take most of the time, and the
// longest walk of a block sets its end.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kTileB = 8;
constexpr int kTileR = 8;
constexpr int kThreads = 1024;

struct Tile {
  int row_lo, rows;  // staged window rows [row_lo, row_lo + rows)
  int col_lo, cols;  // staged window columns [col_lo, col_lo + cols)
};

__global__ void __launch_bounds__(kThreads)
edge_bits_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ z, const float* __restrict__ inc,
                 const unsigned char* __restrict__ active, const float* __restrict__ mad,
                 const int* __restrict__ wp, int* __restrict__ bits, int R, int B, int H, int V,
                 float max_d2) {
  extern __shared__ float smem[];
  const int WCOL = H + B;
  // this block's stream: its window, its batch points and its bits
  const size_t s = blockIdx.z;
  const size_t win = static_cast<size_t>(R) * WCOL, pts = static_cast<size_t>(R) * B;
  x += s * win;
  y += s * win;
  z += s * win;
  inc += s * win;
  active += s * win;
  mad += s * pts;
  wp += s * pts;
  bits += s * 2 * (H + 1) * pts;
  const int b0 = blockIdx.x * kTileB;
  const int r0 = blockIdx.y * kTileR;
  Tile t;
  t.row_lo = max(r0 - V, 0);
  t.rows = min(r0 + kTileR + V, R) - t.row_lo;
  t.col_lo = b0;
  t.cols = min(b0 + kTileB + H, WCOL) - b0;
  const int cells = t.rows * t.cols;
  const int stride = (kTileR + 2 * V) * (kTileB + H);
  float* sx = smem;
  float* sy = sx + stride;
  float* sz = sy + stride;
  float* sinc = sz + stride;
  unsigned char* sact = reinterpret_cast<unsigned char*>(sinc + stride);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int sr = i / t.cols;
    const int g = (t.row_lo + sr) * WCOL + t.col_lo + (i - sr * t.cols);
    sx[i] = x[g];
    sy[i] = y[g];
    sz[i] = z[g];
    sinc[i] = inc[g];
    sact[i] = active[g];
  }
  __syncthreads();

  const size_t plane = static_cast<size_t>(R) * B;
  const int items = (H + 1) * kTileR * kTileB;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int bl = item % kTileB;
    const int rl = (item / kTileB) % kTileR;
    const int dc = item / (kTileB * kTileR);
    const int r = r0 + rl;
    const int b = b0 + bl;
    if (r >= R || b >= B) continue;
    const int idx = r * B + b;
    // the point and its neighbours in the staged tile: window column H + b
    // is tile column H + bl, window row rr is tile row rr - row_lo
    const int pc = (r - t.row_lo) * t.cols + H + bl;
    unsigned w0 = 0u, w1 = 0u;
    if (sact[pc] && dc <= min(wp[idx], H)) {
      const float xb = sx[pc], yb = sy[pc], zb = sz[pc], incb = sinc[pc];
      const float m = mad[idx];
      const int c = H + bl - dc;
      auto ok = [&](int dr) -> bool {
        const int rr = r + dr;
        if (rr < 0 || rr >= R) return true;  // NaN padding
        return !(fabsf(sinc[(rr - t.row_lo) * t.cols + c] - incb) > m);
      };
      auto edge = [&](int dr) {
        const int rr = r + dr;
        if (rr < 0 || rr >= R) return;
        const int q = (rr - t.row_lo) * t.cols + c;
        if (!sact[q]) return;
        const float dx = __fsub_rn(sx[q], xb);
        const float dy = __fsub_rn(sy[q], yb);
        const float dz = __fsub_rn(sz[q], zb);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (d2 < max_d2) {
          const int k = dr + V;
          if (k < 32) w0 |= 1u << k;
          else w1 |= 1u << (k - 32);
        }
      };
      const bool ok0 = ok(0);
      if (dc > 0 && ok0) edge(0);
      bool reach = (dc == 0) || ok0;
      for (int k = 1; k <= V && reach; ++k) {
        reach = ok(-k);
        if (reach) edge(-k);
      }
      reach = dc > 0;
      for (int k = 1; k <= V && reach; ++k) {
        reach = ok(k);
        if (reach) edge(k);
      }
    }
    bits[(2 * dc) * plane + idx] = static_cast<int>(w0);
    bits[(2 * dc + 1) * plane + idx] = static_cast<int>(w1);
  }
}

}  // namespace

extern "C" int cct_edge_bits(const float* x, const float* y, const float* z, const float* inc,
                             const unsigned char* active, const float* mad, const int* wp,
                             int* bits, int S, int R, int B, int H, int V, float max_d2,
                             void* stream) {
  static LaunchCache cache;
  const int stride = (kTileR + 2 * V) * (kTileB + H);
  const int smem = stride * static_cast<int>(4 * sizeof(float) + 1);
  const cudaError_t err = prepare_launch(reinterpret_cast<const void*>(edge_bits_kernel), cache,
                                         smem, kThreads);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kTileB - 1) / kTileB, (R + kTileR - 1) / kTileR, S);
  edge_bits_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, inc, active, mad, wp, bits, R, B, H, V, max_d2);
  return static_cast<int>(cudaGetLastError());
}
