// K6: closest geometry hit (t, prim) over all spheres and quads, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel
// raytracinginoneweekendincuda_tpu/ops/pallas_hit.py::_make_kernel (the hit
// stage of the wavefront_pallas engine).  A thread takes one ray at a time
// (32 bytes), walks every active sphere and quad with the pair tests of
// xla_pair.cuh, and writes (t, prim) -- 40 bytes of traffic per ray, as on
// the TPU.  What bounds it is the pair loop's instruction issue: FP32 work
// and the reads of each pair's row (S + Q pair tests per ray), with every
// thread of a warp reading the same row.
//
// What the design does about it:
// - Tables in shared memory.  Each block copies the sphere and quad tables
//   once into rows of 12 and 16 floats (three and four float4s: field r of
//   pack_geometry's table at float r of the row), transposing them in the
//   copy, so a pair reads its row as three or four 16-byte broadcasts
//   instead of 10 or 13 scalar loads through the read-only cache.
// - A persistent grid: at most the blocks the card holds at once at this
//   shared size, each looping over rays with a grid stride, so the tables
//   are copied once a block and not once every block of rays.  Blocks of
//   up to 1024 threads (scene 9's tables, 200 KB of rows, leave room for
//   one block a SM), fewer when the rays are too few to fill every SM
//   (persistent_grid.cuh's spread_threads).
// - Tables whose rows exceed a block's opt-in shared memory run the other
//   instantiation of the same kernel, which reads the rows from global
//   memory, chosen at launch by the rows' size.
// Both run the same pair tests (xla_pair.cuh's row sources), so t and prim
// are the same whichever memory holds the rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "persistent_grid.cuh"
#include "xla_pair.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kSphRows = 10, kQuadRows = 13;  // pack_geometry's fields
constexpr int kSphActive = 9;                 // their active fields
constexpr int kQuadActive = 12;
constexpr int kSphF4 = 3, kQuadF4 = 4;        // float4s a staged row

template <bool kStaged>
__global__ void __launch_bounds__(kBlock)
closest_geo_kernel(const float* __restrict__ rays, int n,
                   const float* __restrict__ sph, int s_pad,
                   const float* __restrict__ quad, int q_pad, float t_min,
                   float* __restrict__ t_out, int* __restrict__ p_out) {
  extern __shared__ float4 staged[];
  if (kStaged) {
    // field c of primitive j goes to float c of row j: coalesced reads,
    // strided shared-memory writes, once a block
    float* srow = reinterpret_cast<float*>(staged);
    for (int i = threadIdx.x; i < kSphRows * s_pad; i += blockDim.x) {
      const int c = i / s_pad;
      srow[4 * kSphF4 * (i - c * s_pad) + c] = __ldg(sph + i);
    }
    float* qrow = srow + 4 * kSphF4 * s_pad;
    for (int i = threadIdx.x; i < kQuadRows * q_pad; i += blockDim.x) {
      const int c = i / q_pad;
      qrow[4 * kQuadF4 * (i - c * q_pad) + c] = __ldg(quad + i);
    }
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const float4 r0 = reinterpret_cast<const float4*>(rays)[2 * k];
    const float4 r1 = reinterpret_cast<const float4*>(rays)[2 * k + 1];
    const xla::GeoRay r = xla::geo_ray(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                                       r1.z);
    float t;
    int win;
    if (kStaged)
      xla::closest_geo(r, xla::StagedRows<kSphF4>{staged}, s_pad,
                       kSphActive,
                       xla::StagedRows<kQuadF4>{staged + kSphF4 * s_pad},
                       q_pad, kQuadActive, t_min, t, win);
    else
      xla::closest_geo(r, xla::TabRows{sph, s_pad}, s_pad, kSphActive,
                       xla::TabRows{quad, q_pad}, q_pad, kQuadActive, t_min,
                       t, win);
    t_out[k] = t;
    p_out[k] = win;
  }
}

template <bool kStaged>
cudaError_t launch(const float* rays, int n, const float* sph, int s_pad,
                   const float* quad, int q_pad, float t_min, float* t_out,
                   int* p_out, int threads, int smem_bytes, int shape[3],
                   cudaStream_t stream) {
  const cudaError_t err = persistent::launch_shape(
      closest_geo_kernel<kStaged>, n, threads, smem_bytes, shape);
  if (err != cudaSuccess) return err;
  closest_geo_kernel<kStaged><<<shape[0], shape[1], smem_bytes, stream>>>(
      rays, n, sph, s_pad, quad, q_pad, t_min, t_out, p_out);
  return cudaGetLastError();
}

}  // namespace

// Launches K6 on `stream` for n rays `rays` [n, 8] f32 (o, d, time, pad;
// 16-byte aligned), tables sph [10, s_pad] and quad [13, q_pad] f32,
// writing t [n] f32 and prim [n] i32.  The tables go to shared memory when
// their staged rows fit a block's opt-in shared memory, else the kernel
// reads them from global memory.  `shape` receives (blocks, threads a
// block, shared bytes: 0 for tables in global memory).  Returns a CUDA
// error code: the launch's cudaGetLastError(), or that of a device query.
extern "C" int closest_geo_launch(const void* rays, int n, const void* sph,
                                  int s_pad, const void* quad, int q_pad,
                                  float t_min, void* t_out, void* p_out,
                                  int* shape, void* stream) {
  shape[0] = shape[1] = shape[2] = 0;
  if (n < 1) return (int)cudaGetLastError();
  int sms = 0, optin = 0;
  cudaError_t err = persistent::device_limits(sms, optin);
  if (err != cudaSuccess) return (int)err;
  const long bytes = (long)sizeof(float4)
                     * ((long)kSphF4 * s_pad + (long)kQuadF4 * q_pad);
  const auto* r = (const float*)rays;
  const auto* s = (const float*)sph;
  const auto* q = (const float*)quad;
  auto* t = (float*)t_out;
  auto* p = (int*)p_out;
  const auto st = (cudaStream_t)stream;
  const int threads = persistent::spread_threads(n, sms, kBlock);
  if (bytes <= optin)
    err = launch<true>(r, n, s, s_pad, q, q_pad, t_min, t, p, threads,
                       (int)bytes, shape, st);
  else
    err = launch<false>(r, n, s, s_pad, q, q_pad, t_min, t, p, threads, 0,
                        shape, st);
  return (int)err;
}
