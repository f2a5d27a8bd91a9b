// K3: the replay forward kernel for Hopper (sm_90a).
//
// Replaces the Pallas replay forward
// raytracinginoneweekendincuda_tpu/ops/pallas_replay.py::_fwd_kernel_factory.
// One thread per lane replays up to K bounces with the winners fixed by
// the tape (tape[k * n + lane], rows of the merged replay table): per
// bounce one row read of the winner (an indexed load -- the TPU kernel's
// one-hot MXU contraction is a workaround for the lack of a lane gather),
// its re-intersection, media t, textures, emission and scatter
// (replay_bounce.cuh), summing the radiance to out[lane * 3 + c].  A lane
// stops at its first inactive bounce: every later bounce of the TPU
// kernel's fixed-depth loop leaves its state and radiance unchanged.
//
// What bounds it: per lane-bounce one ~108-byte table row (hot rows stay in
// L1/L2) and ~150 FP32 operations (more on Perlin winners); per lane 28
// bytes of ray, 4 bytes of tape per bounce and 12 bytes of radiance in
// device memory.  At training sizes it is memory- and latency-bound with
// little arithmetic; the design reads each lane's inputs once, coalesced
// across the warp, and keeps the path state in registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "replay_bounce.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
replay_fwd_kernel(const replay::Params p, const float* __restrict__ rays,
                  const int* __restrict__ tape,
                  const int* __restrict__ pix_ctr,
                  float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n) return;
  const float* q = rays + 7 * (size_t)lane;
  replay::State s;
  s.o = replay::V3{q[0], q[1], q[2]};
  s.d = replay::V3{q[3], q[4], q[5]};
  const float tm = q[6];
  s.thr[0] = s.thr[1] = s.thr[2] = 1.0f;
  const uint32_t pc = (uint32_t)pix_ctr[lane];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < p.K; ++k) {
    replay::Rec r;
    float dacc[3];
    const bool alive = replay::bounce_fwd(p, tape[(size_t)k * p.n + lane],
                                          tm, pc, k, s, r, dacc);
    acc[0] = acc[0] + dacc[0];
    acc[1] = acc[1] + dacc[1];
    acc[2] = acc[2] + dacc[2];
    if (!alive) break;
  }
  out[3 * (size_t)lane + 0] = acc[0];
  out[3 * (size_t)lane + 1] = acc[1];
  out[3 * (size_t)lane + 2] = acc[2];
}

}  // namespace

// Launches K3 on `stream`: rays f32 [n, 7], tape int32 [K, n], pix_ctr
// int32 [n] (uint32 bits), out f32 [n, 3].  Returns cudaGetLastError().
extern "C" int replay_fwd_launch(const replay::Params* params,
                                 const void* rays, const void* tape,
                                 const void* pix_ctr, void* out,
                                 void* stream) {
  if (params->n > 0) {
    const int grid = (params->n + kBlock - 1) / kBlock;
    replay_fwd_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        *params, (const float*)rays, (const int*)tape, (const int*)pix_ctr,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

// sizeof(replay::Params), so the host can check its mirror of the struct.
extern "C" int replay_params_size() { return (int)sizeof(replay::Params); }
