// K1: the mega2 render kernel for Hopper (sm_90a).
//
// Replaces the persistent Pallas render kernel
// raytracinginoneweekendincuda_tpu/ops/mega2.py::_make_kernel(mode="render").
// One thread per pixel id, in the SIMT shape of the CUDA original
// (kernel.cu:122-154): the thread runs its pixel's spp samples in order,
// each up to max_bounces bounces of mega2::bounce, and adds a sample's
// radiance to the pixel sum when its path ends -- the same sum order as the
// TPU kernel's sample-sequential refill.  Tables are read from global
// memory (the whole warp reads one primitive row at a time, so loads are
// broadcasts served from L1/L2); no shared memory.  Divergence and FP32 ALU
// work in the pair loops bound it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "mega2_bounce.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
mega2_render_kernel(const mega2::Params p, const int* __restrict__ pix,
                    int n, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int pid = pix[k];
  float lane[3] = {0.0f, 0.0f, 0.0f};
  if (pid >= 0) {
    const uint32_t pix_ctr = (uint32_t)pid ^ p.seed;
    const float i_f = (float)(pid % p.width);
    const float j_f = (float)(pid / p.width);
    for (int s = 0; s < p.spp; ++s) {
      mega2::Ray r = mega2::raygen(p, pix_ctr, (uint32_t)s, i_f, j_f);
      float thr[3] = {1.0f, 1.0f, 1.0f};
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int b = 0;; ++b) {
        int win;
        bool alive = mega2::bounce(p, pix_ctr, (uint32_t)s, (uint32_t)b, r,
                                   thr, acc, win);
        if (!alive || b + 1 >= p.max_bounces) break;
      }
      lane[0] = lane[0] + acc[0];
      lane[1] = lane[1] + acc[1];
      lane[2] = lane[2] + acc[2];
    }
  }
  out[3 * k + 0] = lane[0];
  out[3 * k + 1] = lane[1];
  out[3 * k + 2] = lane[2];
}

}  // namespace

// Launches K1 on `stream` for the n pixel ids in `pix` (device int32; ids
// < 0 give zeros), writing radiance sums [n, 3] f32 to `out`.  Returns the
// launch's cudaGetLastError().
extern "C" int mega2_render_launch(const mega2::Params* params,
                                   const void* pix, int n, void* out,
                                   void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    mega2_render_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        *params, (const int*)pix, n, (float*)out);
  }
  return (int)cudaGetLastError();
}

// sizeof(mega2::Params), so the host can check its mirror of the struct.
extern "C" int mega2_params_size() { return (int)sizeof(mega2::Params); }
