// K2: connected components of the association window, the whole min-label
// fixpoint in one cooperative launch over every SM.
//
// Replaces window_cc_pallas + sweep_pallas / _sweep_kernel
// (continuous_clustering_tpu/ops/cc_pallas.py).  Each round is the plain
// twin's (ops/cc_cuda.py::window_cc_reference) Jacobi round:
//   1. new = old; for every set bit p -> q of K1's bits (column offsets
//      dc < min(max_wp, H) + 1, row offsets inside the window):
//      new[p] = min(new[p], old[q]) and new[q] = min(new[q], old[p]);
//   2. the segmented row min-scan through (dr = 0, dc = 1) links, from
//      round 0: every cell takes the minimum over its linked run;
//   3. the segmented column min-scan through (dr = -1, dc = 0) links, from
//      round 1, the same way;
//   4. changed = any(new != old).
// It stops after a round that changed nothing, or after max_rounds rounds
// (then converged = 0, which the step reports as cc_failed).  Min is
// commutative, so the order in which step 1's atomics land changes nothing:
// labels, converged and the round count equal the twin's on every input.
// Nothing leaves the device: no host sync per round.
//
// Streams.  One launch takes S <= 32 windows of one shape stacked along a
// leading axis (the multi-sensor step launches K2 once for all its
// streams; a single window is S = 1).  Every window has its own column
// bound min(max_wp[s], H) + 1, its own change word per round parity, its
// own converged flag and round count.  The work loops run over all
// windows (tiles over S x n_tiles, rows over S x R, columns over S x B),
// and a bit mask `live`, the same in every thread, holds the windows that
// changed in the last round: a window that has converged is skipped from
// then on, its labels at the fixpoint and its round count the twin's.
// The rounds go on while any window changed and it < max_rounds.
//
// Layout.  The labels live in global memory twice, `old` and `labels`
// (112 KB each at R = 64, B = 416, resident in the 50 MB L2), so the window
// has no size limit but the card's memory: step 1 reads old and lowers
// labels; the last scan of a round compares each final label with old and
// copies it there, so both hold the round's result and the next round
// starts from new = old.  The grid is one block of kThreads per SM, all
// co-resident (cooperative launch); phases are separated by grid-wide
// barriers (cooperative_groups grid sync).
// Reads of labels that other blocks wrote go through L2 (__ldcg).
//   * Step 1 runs per tile of kTileR x kTileB batch points: the old labels
//     the tile's edges reach are staged in shared memory, pulls and pushes
//     are combined there with shared-memory atomics, and each lowered cell
//     goes out with one global atomicMin (relax_tile).  Edge words load
//     kPrefetch items at a time.
//   * A scan gives one warp a whole row or column, consecutive lines on
//     different SMs: each lane holds up to kCells consecutive cells in
//     registers (all loaded at once), scans them, and the warp combines the
//     lanes' results with shuffles, so no thread walks a whole line; a line
//     longer than 32 x kCells is taken in pieces with a carry.
//   * The change flags are a global word per window and round parity, set
//     by one atomicOr per block and changed window and cleared a round
//     ahead.
//
// What bounds it on the card: the bytes are the two words of K1's bits for
// each offset in use, dc < min(max_wp, H) + 1 (read once from HBM, then from
// L2 each round: 2.6 MB on a window whose widest wedge is 11 columns, 4.5 MB
// when all 21 offsets count), and the labels in and out, 0.8-1.4 us at the
// HBM rate; the work is one relaxation per set bit per round and two scans.  At the main path's windows the time is latency: per
// round 2-3 grid barriers and 4-6 dependent memory round trips (staging,
// edge words, each scan pass) on a sparse window; on a dense one (7.5 M set
// bits) step 1's per-bit work.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCells = 16;   // cells per lane in a scan
constexpr int kTileR = 32;   // batch rows and columns of a step-1 tile
constexpr int kTileB = 8;
constexpr int kPrefetch = 4;  // step-1 items whose edge words load together
constexpr unsigned kFull = 0xffffffffu;

// staged cells of one step-1 tile (one copy)
__host__ __device__ inline int tile_cells(int H, int V) {
  return (kTileR + 2 * V) * (kTileB + H);
}

struct Window {
  const int* bits;
  int R, B, H, V, WCOL;
  int plane;  // R * B
};

// The link of cell i of a line to cell i - 1 (1 <= i < n) is bit `shift`
// of words[(i + offset) * step]: a row's cells are columns H - 1 + i, its
// links bit V of word V / 32 of bits[1] at batch column i - 1; a column's
// cells are rows i, its links bit V - 1 of word (V - 1) / 32 of bits[0] at
// row i.
struct Links {
  const int* words;
  int offset, step, shift;
};

__device__ __forceinline__ bool bit(unsigned m, int j) { return (m >> j) & 1u; }

// One pass of a segmented min-scan over a line of n cells at y[i * stride],
// forward (kFwd) or backward, in place, called by a whole warp.  Lane l holds
// cells [l K, l K + K) of a piece of 32 K cells in v[0, K), K = kC, or less
// in a line shorter than one piece; the other slots, and cells past the
// line's end, are transparent (INT_MAX, begin no run).
// Every load of a piece is issued before any of them is used (clamped
// addresses, no branches), so a piece costs one memory round trip.  With
// kCmp the result is compared with x (changed -> local = 1) and copied there.
template <bool kFwd, bool kCmp, int kC>
__device__ void line_pass(int* y, int* x, int stride, int n, const Links& lk, int& local) {
  const int lane = threadIdx.x & 31;
  const int K = min(kC, (n + 31) / 32);
  const int piece = 32 * K;
  const int n_pieces = (n + piece - 1) / piece;
  int carry = INT_MAX;
  for (int pp = 0; pp < n_pieces; ++pp) {
    const int p0 = (kFwd ? pp : n_pieces - 1 - pp) * piece + lane * K;
    int v[kC], xo[kC], lw[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int i = min(p0 + j, n - 1);
      // the link that begins or continues cell i's run in this direction
      const int li = kFwd ? max(i, 1) : min(i + 1, n - 1);
      v[j] = __ldcg(y + i * stride);
      if (kCmp) xo[j] = __ldcg(x + i * stride);
      lw[j] = __ldg(lk.words + (li + lk.offset) * lk.step);
    }
    unsigned start = 0;  // bit j: cell j begins a run in the direction of travel
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int i = p0 + j;
      const bool valid = j < K && i < n;
      const bool linked = (lw[j] >> lk.shift) & 1;
      const bool s = kFwd ? (i == 0 || !linked) : (i == n - 1 || !linked);
      if (!valid) v[j] = INT_MAX;
      start |= static_cast<unsigned>(valid && s) << j;
    }
    // within the lane
    if (kFwd) {
#pragma unroll
      for (int j = 1; j < kC; ++j)
        if (!bit(start, j)) v[j] = min(v[j], v[j - 1]);
    } else {
#pragma unroll
      for (int j = kC - 2; j >= 0; --j)
        if (!bit(start, j)) v[j] = min(v[j], v[j + 1]);
    }
    // across lanes: each lane's aggregate (the value flowing out of it, and
    // whether a run begins in it), scanned in the direction of travel
    int av = kFwd ? v[kC - 1] : v[0];
    int af = start != 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ov = kFwd ? __shfl_up_sync(kFull, av, off) : __shfl_down_sync(kFull, av, off);
      const int of = kFwd ? __shfl_up_sync(kFull, af, off) : __shfl_down_sync(kFull, af, off);
      if (kFwd ? lane >= off : lane + off < 32) {
        if (!af) av = min(av, ov);
        af |= of;
      }
    }
    // what flows into this lane: the carry of the pieces before, then the
    // lanes before it
    int iv = kFwd ? __shfl_up_sync(kFull, av, 1) : __shfl_down_sync(kFull, av, 1);
    const int ifl = kFwd ? __shfl_up_sync(kFull, af, 1) : __shfl_down_sync(kFull, af, 1);
    if (lane == (kFwd ? 0 : 31)) iv = carry;
    else if (!ifl) iv = min(iv, carry);
    // cells before the lane's first run start continue the inflowing run
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const unsigned before = kFwd ? (start & ((2u << j) - 1u)) : (start >> j);
      if (before == 0u) v[j] = min(v[j], iv);
    }
    // a piece before the last is full: its last cell is lane 31's slot
    // kC - 1 (K == kC), its first lane 0's slot 0
    carry = kFwd ? __shfl_sync(kFull, v[kC - 1], 31) : __shfl_sync(kFull, v[0], 0);
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int i = p0 + j;
      if (j < K && i < n) {
        y[i * stride] = v[j];
        if (kCmp && xo[j] != v[j]) {
          x[i * stride] = v[j];
          local = 1;
        }
      }
    }
  }
  __syncwarp();
}

// Every cell of the line takes the minimum over its run of linked cells: a
// segmented min-scan forward, then one backward over the forward results,
// which gives the run's minimum.
template <int kC>
__device__ void line_min_k(int* y, int* x, int stride, int n, const Links& lk, bool compare,
                           int& local) {
  line_pass<true, false, kC>(y, x, stride, n, lk, local);
  if (compare) line_pass<false, true, kC>(y, x, stride, n, lk, local);
  else line_pass<false, false, kC>(y, x, stride, n, lk, local);
}

// the slots per lane fit the line: a 64-row column takes 2, a row of
// B + 1 = 417 cells 16 (longer lines go in pieces of 32 x kCells)
__device__ void line_min(int* y, int* x, int stride, int n, const Links& lk, bool compare,
                         int& local) {
  if (n <= 64) line_min_k<2>(y, x, stride, n, lk, compare, local);
  else if (n <= 128) line_min_k<4>(y, x, stride, n, lk, compare, local);
  else if (n <= 256) line_min_k<8>(y, x, stride, n, lk, compare, local);
  else line_min_k<kCells>(y, x, stride, n, lk, compare, local);
}

// compare cells [0, ncols) of every row of every live window with old, and
// copy them there; a window with a changed cell sets its bit of `local`
__device__ void compare_left(int* y, int* x, int S, unsigned live, int R, int WCOL, int ncols,
                             int gtid, int gsize, unsigned& local) {
  const int per = R * ncols;
  for (int idx = gtid; idx < S * per; idx += gsize) {
    const int s = idx / per;
    if (!bit(live, s)) continue;
    const int k = idx - s * per;
    const int r = k / ncols;
    const size_t i = static_cast<size_t>(s) * R * WCOL + r * WCOL + (k - r * ncols);
    const int v = __ldcg(y + i);
    if (__ldcg(x + i) != v) {
      x[i] = v;
      local |= 1u << s;
    }
  }
}

// Step 1 for one tile of kTileR x kTileB batch points.  The old labels of
// every cell the tile's edges reach (rows r0 - V .. r0 + kTileR + V - 1,
// window columns b0 .. b0 + kTileB + H - 1) are staged in shared memory,
// twice: `s_old` is read, `s_new` takes the tile's pulls and pushes with
// shared-memory atomicMin.  Then every staged cell the tile lowered goes to
// `labels` with one global atomicMin (no return value: a reduction that
// does not stall).  It is a call of its own, not inlined: at 512 threads a
// thread has 128 registers, and inlined beside the kernel's per-window
// bookkeeping its edge loop spilled and ran 2.5x slower on a dense window.
__device__ __noinline__ void relax_tile(const Window& w, int tile, int upper, const int* old,
                                        int* labels, int* s_old, int* s_new) {
  const int tiles_b = (w.B + kTileB - 1) / kTileB;
  const int r0 = (tile / tiles_b) * kTileR;
  const int b0 = (tile - (tile / tiles_b) * tiles_b) * kTileB;
  const int row_lo = max(r0 - w.V, 0);
  const int rows = min(r0 + kTileR + w.V, w.R) - row_lo;
  const int cols = min(b0 + kTileB + w.H, w.WCOL) - b0;
  const int cells = rows * cols;
#pragma unroll 4
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int sr = i / cols;
    const int v = __ldcg(old + (row_lo + sr) * w.WCOL + b0 + i - sr * cols);
    s_old[i] = v;
    s_new[i] = v;
  }
  __syncthreads();
  const int n_dr = 2 * w.V + 1;
  const unsigned keep0 = n_dr >= 32 ? kFull : (1u << n_dr) - 1u;
  const unsigned keep1 = n_dr <= 32 ? 0u : (n_dr >= 64 ? kFull : (1u << (n_dr - 32)) - 1u);
  const int items = upper * kTileR * kTileB;
  // kPrefetch items per thread at a time: their edge words are loaded
  // together, then walked
  for (int base = threadIdx.x; base < items; base += kPrefetch * blockDim.x) {
    unsigned w0[kPrefetch], w1[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int item = min(base + u * static_cast<int>(blockDim.x), items - 1);
      const int bl = item % kTileB;
      const int rl = (item / kTileB) % kTileR;
      const int dc = item / (kTileB * kTileR);
      const size_t p = static_cast<size_t>(min(r0 + rl, w.R - 1)) * w.B + min(b0 + bl, w.B - 1);
      w0[u] = static_cast<unsigned>(__ldg(w.bits + (2 * dc) * w.plane + p)) & keep0;
      w1[u] = static_cast<unsigned>(__ldg(w.bits + (2 * dc + 1) * w.plane + p)) & keep1;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int item = base + u * static_cast<int>(blockDim.x);
      const int bl = item % kTileB;
      const int rl = (item / kTileB) % kTileR;
      const int dc = item / (kTileB * kTileR);
      const int r = r0 + rl;
      const int b = b0 + bl;
      if (item >= items || r >= w.R || b >= w.B || (w0[u] | w1[u]) == 0u) continue;
      const int sp = (r - row_lo) * cols + w.H + bl;  // the point; its neighbours
      const int sq = w.H + bl - dc - row_lo * cols;   // sit at sq + rr * cols
      const int a = s_old[sp];
      int m = a;
      for (int word = 0; word < 2; ++word) {
        unsigned bw = word == 0 ? w0[u] : w1[u];
        while (bw) {
          const int rr = r + __ffs(bw) - 1 + 32 * word - w.V;
          bw &= bw - 1;
          if (rr < 0 || rr >= w.R) continue;
          const int c = s_old[sq + rr * cols];
          m = min(m, c);
          if (a < c) atomicMin(s_new + sq + rr * cols, a);
        }
      }
      if (m < a) atomicMin(s_new + sp, m);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int v = s_new[i];
    if (v < s_old[i]) {
      const int sr = i / cols;
      atomicMin(labels + (row_lo + sr) * w.WCOL + b0 + i - sr * cols, v);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
window_cc_kernel(const int* __restrict__ bits, const int* __restrict__ labels_in,
                 const int* __restrict__ max_wp, int* labels, int* old, int* flags, int S, int R,
                 int B, int H, int V, int max_rounds) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int smem[];
  __shared__ unsigned s_changed;  // the windows this block changed in the round
  const int WCOL = H + B;
  const int plane = R * B;
  const int win_bits = 2 * (H + 1) * plane;  // one window's bits
  int* s_old = smem;
  int* s_new = smem + tile_cells(H, V);
  const int n_tiles = ((R + kTileR - 1) / kTileR) * ((B + kTileB - 1) / kTileB);
  const int n = R * WCOL;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsize = gridDim.x * blockDim.x;
  // line index of this warp: consecutive lines go to different SMs
  const int gwarp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int nwarps = gsize >> 5;
  // flags: converged[S], rounds[S], then the change word of window s in a
  // round of parity p at 2 S + p S + s
  for (int i = gtid; i < S * n; i += gsize) {
    const int v = labels_in[i];
    labels[i] = v;
    old[i] = v;
  }
  if (gtid < S) flags[2 * S + gtid] = 0;
  if (threadIdx.x == 0) s_changed = 0u;
  const bool has_h = H >= 1, has_v = V >= 1;
  unsigned live = S >= 32 ? kFull : (1u << S) - 1u;
  grid.sync();

  int it = 0;
  while (live != 0u && it < max_rounds) {
    // 1. relax every forward edge, Jacobi: read old, lower labels
    for (int t = blockIdx.x; t < S * n_tiles; t += gridDim.x) {
      const int s = t / n_tiles;
      if (!bit(live, s)) continue;
      const Window w{bits + s * win_bits, R, B, H, V, WCOL, plane};
      const int upper = min(max(__ldg(max_wp + s), 0), H) + 1;
      relax_tile(w, t - s * n_tiles, upper, old + s * n, labels + s * n, s_old, s_new);
    }
    grid.sync();
    if (gtid < S) flags[(2 + ((it + 1) & 1)) * S + gtid] = 0;  // read last a round ago
    const bool col_phase = has_v && it >= 1;
    unsigned local = 0u;
    // 2. rows; they end the round when no column scan follows
    if (has_h) {
      for (int line = gwarp; line < S * R; line += nwarps) {
        const int s = line / R;
        if (!bit(live, s)) continue;
        const int row = line - s * R;
        const Links hl{bits + s * win_bits + (2 + V / 32) * plane + row * B, -1, 1, V % 32};
        const int base = s * n + row * WCOL + H - 1;
        int c = 0;
        line_min(labels + base, old + base, 1, B + 1, hl, !col_phase, c);
        if (c) local |= 1u << s;
      }
    }
    if (!col_phase)
      compare_left(labels, old, S, live, R, WCOL, has_h ? H - 1 : WCOL, gtid, gsize, local);
    // 3. columns
    if (col_phase) {
      grid.sync();
      for (int line = gwarp; line < S * B; line += nwarps) {
        const int s = line / B;
        if (!bit(live, s)) continue;
        const int b = line - s * B;
        const Links cl{bits + s * win_bits + ((V - 1) / 32) * plane + b, 0, B, (V - 1) % 32};
        const int base = s * n + H + b;
        int c = 0;
        line_min(labels + base, old + base, WCOL, R, cl, true, c);
        if (c) local |= 1u << s;
      }
      compare_left(labels, old, S, live, R, WCOL, H, gtid, gsize, local);
    }
    // 4. the change flags: the block's windows gather in shared memory, then
    // one atomicOr per block and changed window
    local = __reduce_or_sync(kFull, local);
    if ((threadIdx.x & 31) == 0 && local != 0u) atomicOr(&s_changed, local);
    __syncthreads();
    if (threadIdx.x == 0) {
      for (unsigned m = s_changed; m != 0u; m &= m - 1u) atomicOr(flags + (2 + (it & 1)) * S + __ffs(m) - 1, 1);
      s_changed = 0u;
    }
    grid.sync();
    unsigned next = 0u;
    for (int s = 0; s < S; ++s)
      if (bit(live, s) && *reinterpret_cast<volatile int*>(flags + (2 + (it & 1)) * S + s) != 0)
        next |= 1u << s;
    ++it;
    // a window that changed nothing in this round has converged after it
    if (gtid == 0) {
      for (unsigned m = live & ~next; m != 0u; m &= m - 1u) {
        flags[__ffs(m) - 1] = 1;
        flags[S + __ffs(m) - 1] = it;
      }
    }
    live = next;
  }
  // the windows still changing at the round cap
  if (gtid == 0) {
    for (unsigned m = live; m != 0u; m &= m - 1u) {
      flags[__ffs(m) - 1] = 0;
      flags[S + __ffs(m) - 1] = it;
    }
  }
}

}  // namespace

extern "C" int cct_window_cc(const int* bits, const int* labels_in, const int* max_wp,
                             int* labels, int* old, int* flags, int S, int R, int B, int H, int V,
                             int max_rounds, void* stream) {
  static LaunchCache cache;
  // at most 32 windows (the change masks are one word), offsets in 32 bits
  if (S < 1 || S > 32 || static_cast<long long>(S) * 2 * (H + 1) * R * B > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(window_cc_kernel);
  const int smem = 2 * tile_cells(H, V) * static_cast<int>(sizeof(int));
  int blocks = 0;
  cudaError_t err = prepare_launch(kernel, cache, smem, kThreads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&bits, &labels_in, &max_wp, &labels, &old, &flags, &S, &R, &B, &H, &V,
                  &max_rounds};
  err = cudaLaunchCooperativeKernel(kernel, blocks, kThreads, args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
