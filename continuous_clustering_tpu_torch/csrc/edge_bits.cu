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
// What bounds it on the card: at R = 64, B = 416, H = V = 20 each point walks
// at most 21 x 41 neighbours, reading five (R, H+B) planes of 112 KB each
// that stay in L1/L2, and writes 4.5 MB of bits.  It is latency bound on
// dependent loads, not on bandwidth.  The design gives each point its own
// thread (coalesced over b) with the walk state in registers, stops a walk
// at its first break, skips every offset beyond the point's own wedge width,
// and writes no reverse masks: the CC kernel pushes along forward edges.

#include <cuda_runtime.h>

namespace {

__global__ void edge_bits_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                 const float* __restrict__ z, const float* __restrict__ inc,
                                 const int* __restrict__ active, const float* __restrict__ mad,
                                 const int* __restrict__ wp, int* __restrict__ bits,
                                 int R, int B, int H, int V, float max_d2) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * B) return;
  const int r = idx / B;
  const int b = idx - r * B;
  const int WCOL = H + B;
  const size_t plane = static_cast<size_t>(R) * B;
  const int pc = r * WCOL + H + b;
  const float xb = x[pc], yb = y[pc], zb = z[pc], incb = inc[pc];
  const float m = mad[idx];
  const int last_dc = active[pc] ? min(wp[idx], H) : -1;

  for (int dc = 0; dc <= H; ++dc) {
    unsigned w0 = 0u, w1 = 0u;
    if (dc <= last_dc) {
      const int c = H + b - dc;
      auto ok = [&](int dr) -> bool {
        const int rr = r + dr;
        if (rr < 0 || rr >= R) return true;  // NaN padding
        return !(fabsf(inc[rr * WCOL + c] - incb) > m);
      };
      auto edge = [&](int dr) {
        const int rr = r + dr;
        if (rr < 0 || rr >= R) return;
        const int q = rr * WCOL + c;
        if (!active[q]) return;
        const float dx = __fsub_rn(x[q], xb);
        const float dy = __fsub_rn(y[q], yb);
        const float dz = __fsub_rn(z[q], zb);
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
                             const int* active, const float* mad, const int* wp, int* bits,
                             int R, int B, int H, int V, float max_d2, void* stream) {
  const int threads = 256;
  const int blocks = (R * B + threads - 1) / threads;
  edge_bits_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, inc, active, mad, wp, bits, R, B, H, V, max_d2);
  return static_cast<int>(cudaGetLastError());
}
