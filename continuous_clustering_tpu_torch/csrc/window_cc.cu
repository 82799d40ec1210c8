// K2: connected components of the association window, the whole min-label
// fixpoint in one launch.
//
// Replaces window_cc_pallas + sweep_pallas / _sweep_kernel
// (continuous_clustering_tpu/ops/cc_pallas.py).  Each round:
//   1. a Gauss-Seidel sweep over every forward edge of K1's bits (column
//      offsets dc < min(max_wp, H) + 1): both ends take the smaller label;
//   2. the segmented row min-scan through (dr = 0, dc = 1) links, from
//      round 0;
//   3. the segmented column min-scan through (dr = -1, dc = 0) links, from
//      round 1.
// It stops after a round that changed nothing, or after max_rounds rounds
// (then converged = 0, which the step reports as cc_failed).  Labels,
// converged and rounds stay on the device: no host sync per round.
//
// The fixpoint is the per-component minimum of the seed labels whatever the
// order of updates, so the labels equal the plain (Jacobi) twin's exactly;
// the round count may differ.
//
// What bounds it on the card: one block holds the (R, H+B) labels in
// dynamic shared memory (111,616 bytes at R = 64, B = 416), so it runs on
// 1 of 132 SMs; each round re-reads the 4.5 MB of bits from L2.  Every
// label write is a shared-memory atomicMin, so labels only ever decrease and
// no update is lost; pull-left and push-right along one forward edge are the
// same atomicMin, which makes the reverse masks of the TPU kernel
// unnecessary.  The scans run one thread per row or column, sequentially, in
// this first version.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void lower(int* L, int i, int v, int& changed) {
  if (atomicMin(&L[i], v) > v) changed = 1;
}

__global__ void __launch_bounds__(1024)
window_cc_kernel(const int* __restrict__ bits, const int* __restrict__ labels_in,
                 const int* __restrict__ max_wp, int* __restrict__ labels_out,
                 int* __restrict__ flags, int R, int B, int H, int V, int max_rounds) {
  extern __shared__ int L[];
  volatile int* Lv = L;
  const int WCOL = H + B;
  const int n = R * WCOL;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t plane = static_cast<size_t>(R) * B;
  for (int i = tid; i < n; i += nt) L[i] = labels_in[i];
  const int upper = min(max(max_wp[0], 0), H) + 1;
  // scan links: bit V of the dc = 1 plane, bit V - 1 of the dc = 0 plane
  const int* hplane = H >= 1 ? bits + (2 * 1 + V / 32) * plane : nullptr;
  const int hshift = V % 32;
  const int* vplane = V >= 1 ? bits + ((V - 1) / 32) * plane : nullptr;
  const int vshift = (V - 1) % 32;
  __syncthreads();

  int it = 0;
  int changed = 1;
  while (changed && it < max_rounds) {
    int local = 0;
    for (int p = tid; p < R * B; p += nt) {
      const int r = p / B;
      const int b = p - r * B;
      const int lp = r * WCOL + H + b;
      for (int dc = 0; dc < upper; ++dc) {
        unsigned w[2] = {static_cast<unsigned>(bits[(2 * dc) * plane + p]),
                         static_cast<unsigned>(bits[(2 * dc + 1) * plane + p])};
        for (int word = 0; word < 2; ++word) {
          while (w[word]) {
            const int k = __ffs(w[word]) - 1 + 32 * word;
            w[word] &= w[word] - 1;
            const int lq = (r + k - V) * WCOL + H + b - dc;
            const int a = Lv[lp];
            const int c = Lv[lq];
            if (c < a) lower(L, lp, c, local);
            else if (a < c) lower(L, lq, a, local);
          }
        }
      }
    }
    __syncthreads();
    if (hplane != nullptr) {
      for (int r = tid; r < R; r += nt) {
        int* row = L + r * WCOL;
        const int* link = hplane + r * B;  // link[b]: columns H+b-1 and H+b
        for (int c = H; c < WCOL; ++c) {
          if ((link[c - H] >> hshift) & 1) {
            if (row[c - 1] < row[c]) { row[c] = row[c - 1]; local = 1; }
          }
        }
        for (int c = WCOL - 2; c >= H - 1 && c >= 0; --c) {
          if ((link[c + 1 - H] >> hshift) & 1) {
            if (row[c + 1] < row[c]) { row[c] = row[c + 1]; local = 1; }
          }
        }
      }
    }
    __syncthreads();
    if (vplane != nullptr && it >= 1) {
      for (int c = H + tid; c < WCOL; c += nt) {
        const int b = c - H;
        // link of rows r-1 and r (row 0 never links upward)
        for (int r = 1; r < R; ++r) {
          if ((vplane[r * B + b] >> vshift) & 1) {
            const int up = L[(r - 1) * WCOL + c];
            if (up < L[r * WCOL + c]) { L[r * WCOL + c] = up; local = 1; }
          }
        }
        for (int r = R - 2; r >= 0; --r) {
          if ((vplane[(r + 1) * B + b] >> vshift) & 1) {
            const int dn = L[(r + 1) * WCOL + c];
            if (dn < L[r * WCOL + c]) { L[r * WCOL + c] = dn; local = 1; }
          }
        }
      }
    }
    changed = __syncthreads_or(local);
    ++it;
  }
  for (int i = tid; i < n; i += nt) labels_out[i] = L[i];
  if (tid == 0) {
    flags[0] = changed ? 0 : 1;
    flags[1] = it;
  }
}

}  // namespace

extern "C" int cct_window_cc(const int* bits, const int* labels_in, const int* max_wp,
                             int* labels_out, int* flags, int R, int B, int H, int V,
                             int max_rounds, int threads, void* stream) {
  const int smem = R * (H + B) * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      window_cc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_cc_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      bits, labels_in, max_wp, labels_out, flags, R, B, H, V, max_rounds);
  return static_cast<int>(cudaGetLastError());
}
