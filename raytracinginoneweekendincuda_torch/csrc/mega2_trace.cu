// K2: the winner-tape trace kernel for Hopper (sm_90a).
//
// Replaces the Pallas trace kernel
// raytracinginoneweekendincuda_tpu/ops/mega2.py::_make_kernel(mode="trace")
// (launched by _trace_span_impl).  Each (pixel, sample) lane runs up to
// max_bounces bounces of mega2::bounce with textures compiled out and
// writes each bounce's winner kernel row to tape[b * n + lane]: -1 for a
// miss and for every bounce after the path ended (light, metal absorb,
// miss).  Rays come from the in-kernel raygen (bit-identical to
// ops/raygen.py) or, when `rays` is non-null, from [n, 7] rows (origin,
// direction, time).
//
// What bounds it: the same FP32 pair-loop work as K1 per lane-bounce (every
// bounce tests every sphere, loose quad and box slab), so the lane-bounces
// times the rows over the rate at which threads do useful work.  Lanes are
// sample-major, so with one thread a lane a warp holds 32 adjacent pixels
// of one sample and runs until its longest path ends: about half the
// thread slots do useful work at the training step's shape
// (tools/lane_share.py).
//
// What the design does about it (K1's levers, mega2_render.cu):
// - A persistent grid with a lane queue.  A thread holds one lane's path;
//   when the path ends it takes the next lane id from one counter (one
//   warp-aggregated atomicAdd a warp and round) and starts that lane in
//   the same iteration, so threads stay busy until the queue is empty.
//   Which thread traces which lane changes from run to run; a lane's tape
//   does not (the RNG is keyed on pixel, sample and bounce).
// - Pair rows in shared memory where they fit a block's opt-in shared
//   memory (K1's staging loop); otherwise read from global memory, in the
//   other instantiation.  With the chunk cull of large worlds
//   (mega2_bounce.cuh; the test is per lane, no warp vote) that makes four
//   instantiations, chosen at launch as K1's are.
// - The tape is filled with -1 (one memset) before the kernel, which
//   writes only the bounces a path ran; padding lanes (pix < 0) write
//   nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "mega2_bounce.cuh"
#include "persistent_grid.cuh"

namespace {

// 384 threads a block (at most), two blocks a SM: registers capped at 85
// a thread, and two copies of scene 9's 96 KB of pair rows fit a SM's
// shared memory (K1's shape).
constexpr int kBlock = 384;
constexpr int kMinBlocks = 2;
constexpr unsigned kFull = 0xffffffffu;

template <bool kSmemRows, bool kCull>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
mega2_trace_kernel(const mega2::Params p, const int* __restrict__ pix,
                   const int* __restrict__ samp,
                   const float* __restrict__ rays, int n,
                   int* __restrict__ tape, unsigned* __restrict__ queue) {
  extern __shared__ float4 smem_rows[];
  mega2::PairRows rows = mega2::global_rows(p);
  if (kSmemRows) {
    const float4* sph = reinterpret_cast<const float4*>(p.sph);
    const float4* lquad = reinterpret_cast<const float4*>(p.quad);
    const float4* box = reinterpret_cast<const float4*>(rows.box);
    const int n_s = 4 * p.s_pad, n_l = 4 * p.nl_pad, n_b = 4 * p.b_pad;
    for (int i = threadIdx.x; i < n_s + n_l + n_b; i += blockDim.x) {
      smem_rows[i] = i < n_s ? __ldg(sph + i)
                   : i < n_s + n_l ? __ldg(lquad + (i - n_s))
                                   : __ldg(box + (i - n_s - n_l));
    }
    __syncthreads();
    const float* base = reinterpret_cast<const float*>(smem_rows);
    rows = {base, base + mega2::SPH_COLS * p.s_pad,
            base + mega2::SPH_COLS * (p.s_pad + p.nl_pad)};
  }

  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned k = 0u;               // the thread's lane id
  int pid = 0;
  uint32_t pix_ctr = 0u, s = 0u;
  int b = 0;                     // the path's bounce
  bool need = true;              // the thread needs a lane
  bool done = false;             // the queue is empty for this thread
  bool fresh = false;            // the path starts this iteration
  mega2::Ray r{};
  float thr[3] = {1.0f, 1.0f, 1.0f};
  float acc[3] = {0.0f, 0.0f, 0.0f};

  // Every thread of the warp stays in this loop until the whole warp is
  // done, so the warp-wide intrinsics below always see all 32 lanes.
  while (true) {
    // refill: threads whose path ended take the next ids, one atomicAdd a
    // warp and round; a padding id (pix < 0) is skipped in another round
    unsigned want;
    while ((want = __ballot_sync(kFull, need)) != 0u) {
      const int leader = __ffs(want) - 1;
      unsigned base = 0u;
      if (lane == leader) base = atomicAdd(queue, (unsigned)__popc(want));
      base = __shfl_sync(kFull, base, leader);
      if (need) {
        k = base + (unsigned)__popc(want & below);
        if (k >= (unsigned)n) {
          done = true;
          need = false;
        } else {
          pid = pix[k];
          if (pid >= 0) {
            need = false;
            fresh = true;
          }
        }
      }
    }
    if (!__any_sync(kFull, !done)) break;
    if (done) continue;

    if (fresh) {
      pix_ctr = (uint32_t)pid ^ p.seed;
      s = (uint32_t)samp[k];
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
      thr[0] = thr[1] = thr[2] = 1.0f;
      acc[0] = acc[1] = acc[2] = 0.0f;
      b = 0;
      fresh = false;
    }
    int win;
    const bool alive = mega2::bounce<false, kSmemRows, kCull>(
        p, rows, pix_ctr, s, (uint32_t)b, r, thr, acc, win);
    tape[(size_t)b * n + k] = win;
    need = !alive || ++b >= p.max_bounces;
  }
}

template <bool kSmemRows, bool kCull>
cudaError_t launch(const mega2::Params& p, const int* pix, const int* samp,
                   const float* rays, int n, int* tape, unsigned* queue,
                   int smem_bytes, int shape[3], cudaStream_t stream) {
  const cudaError_t err = persistent::launch_shape(
      mega2_trace_kernel<kSmemRows, kCull>, n,
      persistent::queue_threads(n, kBlock), smem_bytes, shape);
  if (err != cudaSuccess) return err;
  mega2_trace_kernel<kSmemRows, kCull>
      <<<shape[0], shape[1], smem_bytes, stream>>>(p, pix, samp, rays, n,
                                                   tape, queue);
  return cudaGetLastError();
}

template <bool kCull>
cudaError_t launch_rows(const mega2::Params& p, const int* pix,
                        const int* samp, const float* rays, int n, int* tape,
                        unsigned* queue, int smem_optin, int shape[3],
                        cudaStream_t stream) {
  const long rows = (long)p.s_pad + p.nl_pad + p.b_pad;
  const long bytes = rows * mega2::SPH_COLS * (long)sizeof(float);
  if (bytes > 0 && bytes <= smem_optin)
    return launch<true, kCull>(p, pix, samp, rays, n, tape, queue,
                               (int)bytes, shape, stream);
  return launch<false, kCull>(p, pix, samp, rays, n, tape, queue, 0, shape,
                              stream);
}

}  // namespace

// Launches K2 on `stream` for n lanes: `pix` / `samp` device int32 [n]
// (pix < 0: padding), `rays` device f32 [n, 7] or null, `tape` device
// int32 [max_bounces, n], which the launch fills with -1 first; `queue` is
// one device uint32, which the launch zeroes.  The pair rows go to shared
// memory when they fit a block's opt-in shared memory, else the kernel
// reads them from global memory; the culled instantiation runs when the
// tables cull pair or box chunks.  `shape` receives (blocks, threads a
// block, shared bytes: 0 for rows in global memory).  Returns a CUDA error
// code: that of the launch, of a memset or of a device query.
extern "C" int mega2_trace_launch(const mega2::Params* params,
                                  const void* pix, const void* samp,
                                  const void* rays, int n, void* tape,
                                  void* queue, int* shape, void* stream) {
  shape[0] = shape[1] = shape[2] = 0;
  if (n < 1) return (int)cudaGetLastError();
  const mega2::Params& p = *params;
  const auto st = (cudaStream_t)stream;
  int sms = 0, optin = 0;
  cudaError_t err = persistent::device_limits(sms, optin);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(tape, 0xFF,
                          (size_t)p.max_bounces * n * sizeof(int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(queue, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const auto* px = (const int*)pix;
  const auto* sm = (const int*)samp;
  const auto* ry = (const float*)rays;
  auto* tp = (int*)tape;
  auto* qu = (unsigned*)queue;
  if (p.cull_pairs || p.cull_boxes)
    err = launch_rows<true>(p, px, sm, ry, n, tp, qu, optin, shape, st);
  else
    err = launch_rows<false>(p, px, sm, ry, n, tp, qu, optin, shape, st);
  return (int)err;
}

// sizeof(mega2::Params), so the host can check its mirror of the struct.
extern "C" int mega2_trace_params_size() {
  return (int)sizeof(mega2::Params);
}
