// K4: the replay backward kernel for Hopper (sm_90a).
//
// Replaces the Pallas replay backward
// raytracinginoneweekendincuda_tpu/ops/pallas_replay.py::_bwd_kernel_factory.
// One thread per lane first recomputes the forward bounce states (o, d,
// thr; up to KMAX bounces, in local memory -- the TPU kernel kept 10 rows
// per bounce in VMEM scratch), then sweeps the bounces in reverse: each
// bounce is recomputed from its state and its hand-written adjoint
// (replay_bounce.cuh: bounce_bwd) maps the cotangents of its outputs to
// those of its inputs.  Outputs:
//
//   d_rays [n, 7]   cotangents of origin, direction and time, per lane;
//   d_bg   [n, 3]   background cotangent per lane (the wrapper sums it);
//   d_rep  [NP, 27] the table cotangent summed over all lanes.
//
// The TPU kernel summed d_rep over a sequential grid; blocks here run in
// no order, so each lane-bounce adds its row with atomicAdd into a zeroed
// buffer.  All threads of a warp step through the reverse sweep together;
// where the warp's active lanes share one winner row (common: neighbouring
// pixels hit the same primitive), the warp sums each column with shuffles
// and one lane adds it, otherwise each lane adds its nonzero columns.
//
// What bounds it: the recompute (two forward bounces per bounce) and the
// adjoint arithmetic, ~3x the forward's FP32 work, plus same-address atomic
// contention on the hot rows (the ground sphere of scene 0 takes most
// lane-bounces).  Per lane it reads 28 + 4K + 4 + 12 bytes and writes 40.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "replay_bounce.cuh"

namespace {

constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;

// Adds the lane's row cotangent `v` to d_rep[key] (key < 0: nothing).
// Called by all 32 threads of the warp together.
__device__ __forceinline__ void add_row(float* __restrict__ d_rep, int key,
                                        const float v[replay::REP_COLS]) {
  const int kmax = __reduce_max_sync(kFull, key);
  if (kmax < 0) return;
  const bool uniform = __all_sync(kFull, key < 0 || key == kmax);
  if (uniform) {
    const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
    for (int c = 0; c < replay::REP_COLS; ++c) {
      float x = key >= 0 ? v[c] : 0.0f;
      if (!__any_sync(kFull, x != 0.0f)) continue;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = x + __shfl_xor_sync(kFull, x, off);
      if (lead) atomicAdd(d_rep + (size_t)kmax * replay::REP_COLS + c, x);
    }
  } else if (key >= 0) {
#pragma unroll
    for (int c = 0; c < replay::REP_COLS; ++c)
      if (v[c] != 0.0f)
        atomicAdd(d_rep + (size_t)key * replay::REP_COLS + c, v[c]);
  }
}

__global__ void __launch_bounds__(kBlock)
replay_bwd_kernel(const replay::Params p, const float* __restrict__ rays,
                  const int* __restrict__ tape,
                  const int* __restrict__ pix_ctr,
                  const float* __restrict__ g_out,
                  float* __restrict__ d_rays, float* __restrict__ d_rep,
                  float* __restrict__ d_bg) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < p.n;       // every thread takes part in add_row
  replay::State st[replay::KMAX];
  float tm = 0.0f;
  uint32_t pc = 0u;
  float gacc[3] = {0.0f, 0.0f, 0.0f};
  int nact = 0;
  if (valid) {
    const float* q = rays + 7 * (size_t)lane;
    replay::State s;
    s.o = replay::V3{q[0], q[1], q[2]};
    s.d = replay::V3{q[3], q[4], q[5]};
    tm = q[6];
    s.thr[0] = s.thr[1] = s.thr[2] = 1.0f;
    pc = (uint32_t)pix_ctr[lane];
    for (int c = 0; c < 3; ++c) gacc[c] = g_out[3 * (size_t)lane + c];
    // forward recompute: the state each active bounce starts from
    for (int k = 0; k < p.K; ++k) {
      st[k] = s;
      replay::Rec r;
      float dacc[3];
      nact = k + 1;
      if (!replay::bounce_fwd(p, tape[(size_t)k * p.n + lane], tm, pc, k, s,
                              r, dacc))
        break;
    }
  }

  // reverse sweep
  replay::State dout;
  dout.o = replay::V3{0.0f, 0.0f, 0.0f};
  dout.d = dout.o;
  dout.thr[0] = dout.thr[1] = dout.thr[2] = 0.0f;
  replay::Grad g;
  g.tm = 0.0f;
  g.bg[0] = g.bg[1] = g.bg[2] = 0.0f;
  for (int k = p.K - 1; k >= 0; --k) {
#pragma unroll
    for (int c = 0; c < replay::REP_COLS; ++c) g.row[c] = 0.0f;
    int key = -1;
    if (k < nact) {
      const replay::State s = st[k];
      replay::State s2 = s;
      replay::Rec r;
      float dacc[3];
      replay::bounce_fwd(p, tape[(size_t)k * p.n + lane], tm, pc, k, s2, r,
                         dacc);
      replay::bounce_bwd(p, tm, s, r, dout, gacc, g);
      dout.o = g.o;
      dout.d = g.d;
      for (int c = 0; c < 3; ++c) dout.thr[c] = g.thr[c];
      key = r.hit ? r.idx : -1;
    }
    __syncwarp();
    add_row(d_rep, key, g.row);
  }
  if (valid) {
    float* o = d_rays + 7 * (size_t)lane;
    o[0] = dout.o.x;
    o[1] = dout.o.y;
    o[2] = dout.o.z;
    o[3] = dout.d.x;
    o[4] = dout.d.y;
    o[5] = dout.d.z;
    o[6] = g.tm;
    for (int c = 0; c < 3; ++c) d_bg[3 * (size_t)lane + c] = g.bg[c];
  }
}

}  // namespace

// Launches K4 on `stream`: rays f32 [n, 7], tape int32 [K, n], pix_ctr
// int32 [n], g f32 [n, 3] (the radiance cotangent); writes d_rays f32
// [n, 7] and d_bg f32 [n, 3], and adds into d_rep f32 [np_rows, 27], which
// the caller zeroes.  K must not exceed replay::KMAX.  Returns
// cudaGetLastError().
extern "C" int replay_bwd_launch(const replay::Params* params,
                                 const void* rays, const void* tape,
                                 const void* pix_ctr, const void* g,
                                 void* d_rays, void* d_rep, void* d_bg,
                                 void* stream) {
  if (params->K > replay::KMAX) return (int)cudaErrorInvalidValue;
  if (params->n > 0) {
    const int grid = (params->n + kBlock - 1) / kBlock;
    replay_bwd_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        *params, (const float*)rays, (const int*)tape, (const int*)pix_ctr,
        (const float*)g, (float*)d_rays, (float*)d_rep, (float*)d_bg);
  }
  return (int)cudaGetLastError();
}

// sizeof(replay::Params), so the host can check its mirror of the struct.
extern "C" int replay_params_size() { return (int)sizeof(replay::Params); }

// The deepest replay the backward takes (replay::KMAX).
extern "C" int replay_bwd_kmax() { return replay::KMAX; }
