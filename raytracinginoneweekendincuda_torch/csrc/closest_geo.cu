// K6: closest geometry hit (t, prim) over all spheres and quads, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel
// raytracinginoneweekendincuda_tpu/ops/pallas_hit.py::_make_kernel (the hit
// stage of the wavefront_pallas engine).  One thread per ray: it reads its
// ray (32 bytes), walks every active sphere and quad with the pair tests of
// xla_pair.cuh, and writes (t, prim) -- 40 bytes of traffic per ray, as on
// the TPU.  The tables are read from global memory through the read-only
// cache; the whole warp reads one primitive at a time.  FP32 ALU work in
// the pair loop bounds it (S + Q pair tests per ray); staging the tables in
// shared memory is left for later (scene 9's tables exceed 48 KB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "xla_pair.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kSphActive = 9;   // pack_geometry's sphere active row
constexpr int kQuadActive = 12;

__global__ void __launch_bounds__(kBlock)
closest_geo_kernel(const float* __restrict__ rays, int n,
                   const float* __restrict__ sph, int s_pad,
                   const float* __restrict__ quad, int q_pad, float t_min,
                   float* __restrict__ t_out, int* __restrict__ p_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float4 r0 = reinterpret_cast<const float4*>(rays)[2 * k];
  const float4 r1 = reinterpret_cast<const float4*>(rays)[2 * k + 1];
  const xla::GeoRay r = xla::geo_ray(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                                     r1.z);
  float t;
  int win;
  xla::closest_geo(r, sph, s_pad, kSphActive, quad, q_pad, kQuadActive,
                   t_min, t, win);
  t_out[k] = t;
  p_out[k] = win;
}

}  // namespace

// Launches K6 on `stream` for n rays `rays` [n, 8] f32 (o, d, time, pad;
// 16-byte aligned), tables sph [10, s_pad] and quad [13, q_pad] f32,
// writing t [n] f32 and prim [n] i32.  Returns the launch's
// cudaGetLastError().
extern "C" int closest_geo_launch(const void* rays, int n, const void* sph,
                                  int s_pad, const void* quad, int q_pad,
                                  float t_min, void* t_out, void* p_out,
                                  void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    closest_geo_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)rays, n, (const float*)sph, s_pad, (const float*)quad,
        q_pad, t_min, (float*)t_out, (int*)p_out);
  }
  return (int)cudaGetLastError();
}
