// K2: the winner-tape trace kernel for Hopper (sm_90a).
//
// Replaces the Pallas trace kernel
// raytracinginoneweekendincuda_tpu/ops/mega2.py::_make_kernel(mode="trace")
// (launched by _trace_span_impl).  One thread per (pixel, sample) lane runs
// up to max_bounces bounces of mega2::bounce with textures compiled out and
// writes each bounce's winner kernel row to tape[b * n + lane]: -1 for a
// miss and for every bounce after the path ended (light, metal absorb,
// miss).  Rays come from the in-kernel raygen (bit-identical to
// ops/raygen.py) or, when `rays` is non-null, from [n, 7] rows (origin,
// direction, time).
//
// What bounds it: the same FP32 pair-loop work as K1 per lane-bounce (every
// bounce tests every sphere, loose quad and box slab), plus warp divergence
// in path length.  Tables stay in L1/L2 and are read as warp-wide
// broadcasts; the tape writes are coalesced across lanes (4 bytes per
// lane-bounce).  The design keeps one lane's path in registers for its
// whole life; no shared memory, and no lane refill (K1 has it).  A world
// whose tables cull chunks runs the culled instantiation of the bounce
// (mega2_bounce.cuh), each thread testing its own ray against a chunk's
// box: threads past n return at once, so no warp-wide vote is valid here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "mega2_bounce.cuh"

namespace {

constexpr int kBlock = 128;

template <bool kCull>
__global__ void __launch_bounds__(kBlock)
mega2_trace_kernel(const mega2::Params p, const int* __restrict__ pix,
                   const int* __restrict__ samp,
                   const float* __restrict__ rays, int n,
                   int* __restrict__ tape) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int pid = pix[k];
  int b = 0;
  if (pid >= 0) {
    const uint32_t pix_ctr = (uint32_t)pid ^ p.seed;
    const uint32_t s = (uint32_t)samp[k];
    mega2::Ray r;
    if (rays != nullptr) {
      const float* q = rays + 7 * (size_t)k;
      r.ox = q[0];
      r.oy = q[1];
      r.oz = q[2];
      r.dx = q[3];
      r.dy = q[4];
      r.dz = q[5];
      r.tm = q[6];
    } else {
      r = mega2::raygen(p, pix_ctr, s, (float)(pid % p.width),
                        (float)(pid / p.width));
    }
    const mega2::PairRows rows = mega2::global_rows(p);
    float thr[3] = {1.0f, 1.0f, 1.0f};
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (; b < p.max_bounces;) {
      int win;
      const bool alive = mega2::bounce<false, false, kCull>(
          p, rows, pix_ctr, s, (uint32_t)b, r, thr, acc, win);
      tape[(size_t)b * n + k] = win;
      ++b;
      if (!alive) break;
    }
  }
  for (; b < p.max_bounces; ++b) tape[(size_t)b * n + k] = -1;
}

}  // namespace

// Launches K2 on `stream` for n lanes: `pix` / `samp` device int32 [n]
// (pix < 0: padding), `rays` device f32 [n, 7] or null, `tape` device
// int32 [max_bounces, n]; the culled instantiation when the tables cull
// pair or box chunks.  Returns the launch's cudaGetLastError().
extern "C" int mega2_trace_launch(const mega2::Params* params,
                                  const void* pix, const void* samp,
                                  const void* rays, int n, void* tape,
                                  void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    const mega2::Params& p = *params;
    auto* kernel = (p.cull_pairs || p.cull_boxes) ? mega2_trace_kernel<true>
                                                  : mega2_trace_kernel<false>;
    kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        p, (const int*)pix, (const int*)samp, (const float*)rays, n,
        (int*)tape);
  }
  return (int)cudaGetLastError();
}

// sizeof(mega2::Params), so the host can check its mirror of the struct.
extern "C" int mega2_trace_params_size() {
  return (int)sizeof(mega2::Params);
}
