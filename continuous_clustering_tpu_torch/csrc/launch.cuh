// What the kernels' launchers share: the per-device set-up of a launch.
//
// A kernel that takes more than 48 KB of dynamic shared memory must be
// allowed it with cudaFuncSetAttribute.  The attribute belongs to the
// kernel on its device and lasts, so a launcher keeps one LaunchCache per
// kernel and sets it only when a launch needs more than before.  A
// cooperative kernel's grid (one block per SM, checked to be co-resident) is
// kept in the same cache.

#pragma once

#include <cuda_runtime.h>

constexpr int kMaxDevices = 64;

struct LaunchCache {
  int smem[kMaxDevices];  // dynamic shared memory allowed so far
  int grid[kMaxDevices];  // cooperative grid, 0 until computed
};

// Lets `kernel` use `smem` bytes of dynamic shared memory on the current
// device.  With `coop_grid`, also returns the grid of a cooperative launch of
// `threads` per block: one block per SM, all co-resident.
inline cudaError_t prepare_launch(const void* kernel, LaunchCache& cache, int smem, int threads,
                                  int* coop_grid = nullptr) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > cache.smem[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cache.smem[dev] = smem;
    cache.grid[dev] = 0;  // co-residency depends on the shared memory
  }
  if (coop_grid == nullptr) return cudaSuccess;
  if (cache.grid[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, cache.smem[dev]);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache.grid[dev] = sms;
  }
  *coop_grid = cache.grid[dev];
  return cudaSuccess;
}
