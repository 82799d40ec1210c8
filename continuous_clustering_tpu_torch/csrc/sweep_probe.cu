// The CC sweep's building blocks, one probe variant each (see
// ops/sweep_probe.py for what every variant computes).
//
// Replaces scripts/pallas_bisect.py::probe and its kernels k0-k6, a Mosaic
// lowering bisection of the TPU sweep kernel.  The TPU kernels keep the
// labels inside an (R + 2V, PW) VMEM scratch padded with INF and take lane
// rolls of its row bands.  Here no scratch is materialised: the value of
// the padded scratch at (row, lane) is computed from its position (inside
// the label window -> the label, else the padding), and a roll by s reads
// lane (H + c - s) mod PW.  The second scratch of V4 is the (R, B) mask at
// rows [V, V + R), lanes [2H, 2H + B), zero elsewhere, so it too is read
// from its position.
//
// One block runs a variant: one thread per output cell (strided over the
// R x WCOL cells), the dc loop inside.  Every update of the label window
// reads the window as the previous update left it (V2-V5 update it in
// place between steps), so the window lives in shared memory twice, read
// from one copy and written to the other, one __syncthreads per step.
//
// What bounds it on the card: the bytes are the labels in and out (2 x
// 18,944 B at the script's shape) and, for V3, V3i and V4 only, word 0 of
// bits[dc] for dc < upper (344,064 B at upper = 21; no variant reads word
// 1), 0.01-0.11 us at 3.35 TB/s; the work is a few operations per cell and
// step.  One block on one SM keeps the steps'
// barriers cheap; the time is the steps' latency, not the card's rates.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

struct Geometry {
  int R, B, H, V, PW, WCOL, inf;
};

__device__ __forceinline__ int mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// the padded label scratch at (row, lane): labels inside the window, fill
// outside.  A masked-off candidate is INF, as in the TPU kernels, so a
// label above INF comes down to INF.
__device__ __forceinline__ int scratch_at(const int* win, const Geometry& g, int row, int lane,
                                          int fill) {
  const int r = row - g.V;
  const int c = lane - g.H;
  return (r >= 0 && r < g.R && c >= 0 && c < g.WCOL) ? win[r * g.WCOL + c] : fill;
}

// roll(scratch[row0:row0 + R], shift)[:, H:H + WCOL] at window cell (r, c)
__device__ __forceinline__ int band_at(const int* win, const Geometry& g, int row0, int shift,
                                       int r, int c, int fill) {
  return scratch_at(win, g, row0 + r, mod(g.H + c - shift, g.PW), fill);
}

// bit k % 32 of word 0 of bits[dc] at batch point (r, b)
__device__ __forceinline__ int bit_at(const int* bits, const Geometry& g, int dc, int k, int r,
                                      int b) {
  const int w = bits[(static_cast<size_t>(2 * dc) * g.R + r) * g.B + b];
  return (w >> (k % 32)) & 1;
}

__global__ void sweep_probe_kernel(int variant, const int* __restrict__ bits,
                                   const int* __restrict__ upper_p, const int* __restrict__ L,
                                   int* __restrict__ out, Geometry g) {
  extern __shared__ int smem[];
  const int n = g.R * g.WCOL;
  int* cur = smem;
  int* nxt = smem + n;
  const int upper = upper_p[0];
  for (int i = threadIdx.x; i < n; i += blockDim.x) cur[i] = L[i];
  __syncthreads();

  if (variant == 7) {  // V6: the last dc's packed word, zero padding
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / g.WCOL, c = i - (i / g.WCOL) * g.WCOL;
      int w = 0;
      if (upper > 0) {
        for (int k = 0; k < 3; ++k) {
          const int nb = band_at(cur, g, k, upper - 1, r, c, 0);
          w |= (fabsf(__int2float_rn(nb)) < 5.0f ? 1 : 0) << k;
        }
      }
      out[i] = w;
    }
    return;
  }

  // steps: V0-V1 one; V2 and V5 one per dc; V3, V3i and V4 one per (dc, dr_idx)
  const int per_dc = (variant >= 3 && variant <= 5) ? 3 : 1;
  const int n_steps = variant <= 1 ? 1 : upper * per_dc;
  for (int step = 0; step < n_steps; ++step) {
    const int dc = step / per_dc;
    const int dr_idx = 17 * (step - dc * per_dc);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / g.WCOL;
      const int c = i - r * g.WCOL;
      int v = cur[i];
      switch (variant) {
        case 1:
          v = min(v, band_at(cur, g, 3, 5, r, c, g.inf));
          break;
        case 2:
          v = min(v, band_at(cur, g, 3, dc, r, c, g.inf));
          break;
        case 3:
        case 4:
          v = min(v, c >= g.H && bit_at(bits, g, dc, dr_idx, r, c - g.H)
                         ? band_at(cur, g, dr_idx, dc, r, c, g.inf) : g.inf);
          break;
        case 5: {
          const int row = 2 * g.V - dr_idx + r;
          const int lane = mod(g.H + c + dc, g.PW);
          const int mr = row - g.V, mc = lane - 2 * g.H;
          const bool m = mr >= 0 && mr < g.R && mc >= 0 && mc < g.B &&
                         bit_at(bits, g, dc, dr_idx, mr, mc);
          v = min(v, m ? scratch_at(cur, g, row, lane, g.inf) : g.inf);
          break;
        }
        case 6: {
          int acc = fabsf(__int2float_rn(v) - 3.0f) > 1.5f ? 0 : 1;
          for (int k = 0; k < 3; ++k) {
            const int nb = band_at(cur, g, k, dc, r, c, g.inf);
            acc *= fabsf(__int2float_rn(nb)) > 2.0f ? 0 : 1;
            v = min(v, acc ? nb : g.inf);
          }
          break;
        }
        default:
          break;
      }
      nxt[i] = v;
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = cur[i];
}

}  // namespace

extern "C" int cct_sweep_probe(int variant, const int* bits, const int* upper, const int* L,
                               int* out, int R, int B, int H, int V, int PW, void* stream) {
  static LaunchCache cache;
  constexpr int kThreads = 1024;
  const Geometry g{R, B, H, V, PW, H + B, R * (H + B)};
  const int smem = 2 * g.R * g.WCOL * static_cast<int>(sizeof(int));
  const cudaError_t err = prepare_launch(reinterpret_cast<const void*>(sweep_probe_kernel), cache,
                                         smem, kThreads);
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_probe_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      variant, bits, upper, L, out, g);
  return static_cast<int>(cudaGetLastError());
}
