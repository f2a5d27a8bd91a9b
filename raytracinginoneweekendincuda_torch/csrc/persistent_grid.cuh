// The launch shape of a persistent kernel (host side), for K1
// (mega2_render.cu), K2 (mega2_trace.cu) and K6 (closest_geo.cu).
//
// A persistent kernel's blocks loop over their work items (a lane queue,
// or a grid stride), so its grid is at most the blocks the card holds at
// once: the SMs times the blocks a SM holds at the block size and dynamic
// shared memory, and never more blocks than the items need.  The caller
// picks the block size:
// - queue_threads, for K1 and K2, whose threads take lane ids from a queue
//   and so stay busy whatever the grid: the kernel's block, or the items
//   rounded up to a warp when they are fewer (K1's rule).
// - spread_threads, for K6, whose threads take rays by a grid stride: the
//   items over the SMs, rounded up to a warp, so that the SM with the most
//   warps holds ceil(n / (32 SMs)) of them, the fewest any shape can give
//   it.  On 131,072 rays over 132 SMs that is 128 blocks of 1024 threads:
//   4 SMs hold no block, but 4,096 warps put 32 on some SM whatever the
//   shape, and a block size under 1024 would leave a second, partial round
//   to one block of the grid stride.

#pragma once

#include <cuda_runtime.h>

namespace persistent {

constexpr int kMaxDevices = 64;

// The device's SMs and the opt-in shared memory a block may use, queried
// once a device.
inline cudaError_t device_limits(int& sms, int& smem_optin) {
  static int cache[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev][0] == 0) {
    int n = 0, optin = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cache[dev][1] = optin;
    cache[dev][0] = n;
  }
  sms = cache[dev][0];
  smem_optin = cache[dev][1];
  return cudaSuccess;
}

// Threads a block for a kernel with a lane queue: max_threads, or n
// rounded up to a warp when n is smaller.
inline int queue_threads(int n, int max_threads) {
  return n < max_threads ? ((n + 31) / 32) * 32 : max_threads;
}

// Threads a block for a grid-stride kernel on `sms` SMs: n over the SMs,
// rounded up to a warp, and at most max_threads.
inline int spread_threads(int n, int sms, int max_threads) {
  const long spread = ((long)n + sms - 1) / sms;
  return spread < max_threads ? (int)((spread + 31) / 32) * 32 : max_threads;
}

// shape = (blocks, threads, shared bytes) of `kernel` over n >= 1 items
// with `threads` a block and `smem_bytes` of dynamic shared memory a
// block.  Raises the kernel's dynamic shared-memory limit to smem_bytes
// when that is above the default 48 KB.
template <class Kernel>
cudaError_t launch_shape(Kernel kernel, int n, int threads, int smem_bytes,
                         int shape[3]) {
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(sms, optin);
  if (err != cudaSuccess) return err;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long need = ((long)n + threads - 1) / threads;
  const long resident = (long)sms * per_sm;
  shape[0] = (int)(need < resident ? need : resident);
  shape[1] = threads;
  shape[2] = smem_bytes;
  return cudaSuccess;
}

}  // namespace persistent
