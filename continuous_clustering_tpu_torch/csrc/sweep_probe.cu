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
// What bounds it on the card: the bytes are the labels in and out (2 x
// 18,944 B at the script's shape) and, for V3, V3i and V4 only, word 0 of
// bits[dc] for dc < upper (344,064 B at upper = 21; no variant reads word
// 1), 0.01-0.11 us at 3.35 TB/s; the work is a few operations per cell and
// step.  Neither is reached: V2-V5 are a chain of 21-63 dependent steps
// over a 19 KB window, each step waiting for the last, so the time is the
// steps' latency on one SM.  On an H100 a step costs about 0.5 us whatever
// the block (256 to 1,024 threads tried): its chain of barrier,
// shared-memory load, min and store bounds it (PERF.md).
//
// The design keeps that chain as short as it can be:
// * One block of 1,024 threads on one SM: a step ends in one __syncthreads.
//   A grid or cluster barrier per step would cost more than the step.
// * One kernel per variant (a template), so each has its own registers.
// * Each thread owns the same <= 5 cells (thread t: cells t + 1024 k) in
//   every step.  Their (row, column) are computed once, before the step
//   loop, and their labels stay in registers; the label window lives in
//   shared memory twice (read from one copy, written to the other), so
//   neighbours read the last step's labels.  Inside the loop there is no
//   division or modulo: the roll's lane leaves [0, PW) by less than one PW,
//   so one conditional add or subtract brings it back, and the shift itself
//   is carried modulo PW by one compare.
// * V2 and V5 step only the rows whose band can hold a label (V2: 15 of
//   32, V5: 12 at the script's shape); the others only ever fall to INF,
//   so their labels are set once, in both copies.
// * The mask bits V3, V3i and V4 need (bits 0, 17 and 2 of word 0 of
//   bits[dc], for dr_idx = 0, 17, 34) are unpacked before the loop, with
//   16-byte loads, into one byte per (dc, r, b) in shared memory (86,016 B
//   at upper = 21, beside the 37,888 B of labels), so no step waits for
//   device memory.
// * V5's f32 compares of integer labels are integer compares (exact), so
//   no step waits on int-to-float conversions.
// * V0, V1 and V6 are one pass each.
//
// A window of more than 5 x 1,024 cells is refused (cudaErrorInvalidValue);
// the script's window has 4,736.  Variants that read bits stop at
// dc = H + 1, the planes bits holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kCells = 5;  // cells a thread owns

struct Geometry {
  int R, B, H, V, PW, WCOL, inf;
};

__device__ __forceinline__ bool in_range(int x, int n) {
  return static_cast<unsigned>(x) < static_cast<unsigned>(n);
}

// a lane in (-PW, PW) brought into [0, PW)
__device__ __forceinline__ int wrap_low(int lane, int PW) { return lane < 0 ? lane + PW : lane; }
// a lane in [0, 2 PW) brought into [0, PW)
__device__ __forceinline__ int wrap_high(int lane, int PW) { return lane >= PW ? lane - PW : lane; }

__device__ __forceinline__ int next_shift(int s, int PW) { return s + 1 == PW ? 0 : s + 1; }

// bits 0, 17 and 2 of an edge word (dr_idx 0, 17, 34) as bits 0, 1, 2
__device__ __forceinline__ unsigned pack3(int w) {
  return (static_cast<unsigned>(w) & 5u) | ((static_cast<unsigned>(w) >> 16) & 2u);
}

// word 0 of bits[dc] for dc < planes, one byte per (dc, r, b) of pack3
__device__ void stage_masks(const int* __restrict__ bits, unsigned char* __restrict__ mask,
                            int planes, int RB) {
  const bool vec = (RB % 4 == 0) && (reinterpret_cast<uintptr_t>(bits) % 16 == 0);
  if (vec) {
    const int q4 = RB / 4;
#pragma unroll 4
    for (int t = threadIdx.x; t < planes * q4; t += kThreads) {
      const int dc = t / q4, q = t - dc * q4;
      const int4 w = __ldg(reinterpret_cast<const int4*>(bits + static_cast<size_t>(2 * dc) * RB) + q);
      reinterpret_cast<uchar4*>(mask + static_cast<size_t>(dc) * RB)[q] =
          make_uchar4(pack3(w.x), pack3(w.y), pack3(w.z), pack3(w.w));
    }
  } else {
    for (int t = threadIdx.x; t < planes * RB; t += kThreads) {
      const int dc = t / RB, q = t - dc * RB;
      mask[t] = static_cast<unsigned char>(pack3(__ldg(bits + static_cast<size_t>(2 * dc) * RB + q)));
    }
  }
}

// the rows [lo, hi) whose band of variant VAR can hold a label: V2 reads
// the band 3 - V rows away; V5's prefix product dies at its first band, V
// rows up, where that band is padding.  The other rows' labels only ever
// fall to INF.  V3, V3i and V4 read three bands: every row.
template <int VAR>
__device__ __forceinline__ void live_rows(const Geometry& g, int& lo, int& hi) {
  const int off = VAR == 2 ? 3 - g.V : VAR == 6 ? -g.V : 0;
  lo = max(0, -off);
  hi = min(g.R, g.R - off);
  hi = max(hi, lo);
}

template <int VAR>
__global__ void __launch_bounds__(kThreads)
    sweep_probe_kernel(const int* __restrict__ bits, const int* __restrict__ upper_p,
                       const int* __restrict__ L, int* __restrict__ out, Geometry g) {
  extern __shared__ int smem[];
  constexpr bool kReadsBits = VAR >= 3 && VAR <= 5;
  constexpr bool kSteps = VAR >= 2 && VAR <= 6;
  const int n = g.R * g.WCOL;
  const int RB = g.R * g.B;
  int* cur = smem;
  int* nxt = smem + n;
  unsigned char* mask = reinterpret_cast<unsigned char*>(smem + 2 * n);
  const int upper = __ldg(upper_p);
  const int tid = threadIdx.x;

  // the thread's cells, fixed for the launch: the live rows' cells t +
  // 1024 k (all cells for the one-pass variants), their row, column and
  // label
  int lo = 0, hi = g.R;
  if (kSteps) live_rows<VAR>(g, lo, hi);
  const int first = lo * g.WCOL, n_live = (hi - lo) * g.WCOL;
  int r[kCells], c[kCells], v[kCells];
  bool own[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int a = tid + k * kThreads;
    own[k] = a < n_live;
    const int i = first + (own[k] ? a : 0);
    r[k] = i / g.WCOL;
    c[k] = i - r[k] * g.WCOL;
    v[k] = own[k] ? __ldg(L + i) : 0;
  }
  if (VAR == 0) {  // V0: the labels through the scratch
#pragma unroll
    for (int k = 0; k < kCells; ++k)
      if (own[k]) out[first + tid + k * kThreads] = v[k];
    return;
  }
  // the window, and in the other copy the dead rows' labels after a step
  for (int i = tid; i < n; i += kThreads) {
    const int x = __ldg(L + i);
    cur[i] = x;
    if (kSteps && (i < first || i >= first + n_live)) nxt[i] = min(x, g.inf);
  }
  const int planes = kReadsBits ? max(0, min(upper, g.H + 1)) : 0;
  if (planes > 0) stage_masks(bits, mask, planes, RB);
  __syncthreads();

  // label of the padded scratch at (window row rr, window column cc)
  auto at = [&](const int* win, int rr, int cc, int fill) {
    return in_range(rr, g.R) && in_range(cc, g.WCOL) ? win[rr * g.WCOL + cc] : fill;
  };
  auto publish = [&](int* dst) {
#pragma unroll
    for (int k = 0; k < kCells; ++k)
      if (own[k]) dst[first + tid + k * kThreads] = v[k];
  };

  if (VAR == 1) {  // V1: min with the band 3 - V rows away rolled by 5
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int cc = wrap_low(g.H + c[k] - 5, g.PW) - g.H;
      v[k] = min(v[k], at(cur, r[k] + 3 - g.V, cc, g.inf));
    }
    publish(out);
    return;
  }
  if (VAR == 7) {  // V6: the last dc's three compares packed, zero padding
    const int s = upper > 0 ? (upper - 1) % g.PW : 0;
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int cc = wrap_low(g.H + c[k] - s, g.PW) - g.H;
      int w = 0;
      if (upper > 0) {
#pragma unroll
        for (int kk = 0; kk < 3; ++kk)
          w |= (fabsf(__int2float_rn(at(cur, r[k] + kk - g.V, cc, 0))) < 5.0f ? 1 : 0) << kk;
      }
      v[k] = w;
    }
    publish(out);
    return;
  }

  // V2-V5: one step per dc (V2, V5) or per (dc, dr_idx) (V3, V3i, V4);
  // s = dc mod PW.  The dead rows' labels are final after the first step:
  // the second step copies them into the buffer that still holds L (read
  // by nobody in that step), and no step touches them again.
  const int n_dc = kReadsBits ? planes : max(upper, 0);
  auto finish_step = [&](int step) {
    publish(nxt);
    if (step == 1 && n_live < n) {
      for (int i = tid; i < n; i += kThreads)
        if (i < first || i >= first + n_live) nxt[i] = cur[i];
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  };
  int s = 0;
  for (int dc = 0; dc < n_dc; ++dc) {
    const unsigned char* mdc = mask + static_cast<size_t>(dc) * RB;
    if (VAR == 2) {  // V2: min with the band 3 - V rows away rolled by dc
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        const int cc = wrap_low(g.H + c[k] - s, g.PW) - g.H;
        v[k] = min(v[k], in_range(cc, g.WCOL) ? cur[(r[k] + 3 - g.V) * g.WCOL + cc] : g.inf);
      }
      finish_step(dc);
    } else if (VAR == 6) {  // V5: a running prefix product over three bands
      // the f32 compares of integer labels as integer compares, exactly:
      // |f(x) - 3| > 1.5 unless x is 2, 3 or 4; |f(x)| > 2 unless |x| <= 2
      // (a label past 2^24 rounds, and stays far past both bounds)
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        const int cc = wrap_low(g.H + c[k] - s, g.PW) - g.H;
        int acc = v[k] >= 2 && v[k] <= 4 ? 1 : 0;
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
          const int nb = at(cur, r[k] + kk - g.V, cc, g.inf);
          acc &= nb >= -2 && nb <= 2 ? 1 : 0;
          v[k] = min(v[k], acc ? nb : g.inf);
        }
      }
      finish_step(dc);
    } else if (VAR == 5) {  // V4: pull-right, mask and labels rolled by -dc
      int lane[kCells];
#pragma unroll
      for (int k = 0; k < kCells; ++k) lane[k] = wrap_high(g.H + c[k] + s, g.PW);
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
          const int mr = r[k] + g.V - 17 * kk, mc = lane[k] - 2 * g.H;
          const bool m = in_range(mr, g.R) && in_range(mc, g.B) && ((mdc[mr * g.B + mc] >> kk) & 1);
          v[k] = min(v[k], m ? cur[mr * g.WCOL + lane[k] - g.H] : g.inf);
        }
        finish_step(3 * dc + kk);
      }
    } else {  // V3, V3i: the band dr_idx - V rows away rolled by dc where the bit is set
      int cc[kCells];
      unsigned byte[kCells];
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        cc[k] = wrap_low(g.H + c[k] - s, g.PW) - g.H;
        byte[k] = c[k] >= g.H ? mdc[r[k] * g.B + c[k] - g.H] : 0u;
      }
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
        for (int k = 0; k < kCells; ++k)
          v[k] = min(v[k], ((byte[k] >> kk) & 1) ? at(cur, r[k] + 17 * kk - g.V, cc[k], g.inf)
                                                 : g.inf);
        finish_step(3 * dc + kk);
      }
    }
    s = next_shift(s, g.PW);
  }
  for (int i = tid; i < n; i += kThreads) out[i] = cur[i];
}

}  // namespace

extern "C" int cct_sweep_probe(int variant, const int* bits, const int* upper, const int* L,
                               int* out, int R, int B, int H, int V, int PW, void* stream) {
  using Kernel = void (*)(const int*, const int*, const int*, int*, Geometry);
  static const Kernel kernels[8] = {sweep_probe_kernel<0>, sweep_probe_kernel<1>,
                                    sweep_probe_kernel<2>, sweep_probe_kernel<3>,
                                    sweep_probe_kernel<4>, sweep_probe_kernel<5>,
                                    sweep_probe_kernel<6>, sweep_probe_kernel<7>};
  static LaunchCache caches[8];
  const Geometry g{R, B, H, V, PW, H + B, R * (H + B)};
  const int n = R * (H + B);
  if (variant < 0 || variant > 7 || n > kThreads * kCells || H + B + 2 * H > PW)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool reads_bits = variant >= 3 && variant <= 5;
  const int smem = 2 * n * static_cast<int>(sizeof(int)) + (reads_bits ? (H + 1) * R * B : 0);
  const cudaError_t err = prepare_launch(reinterpret_cast<const void*>(kernels[variant]),
                                         caches[variant], smem, kThreads);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernels[variant]<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(bits, upper, L, out, g);
  return static_cast<int>(cudaGetLastError());
}
