// K4: the replay backward kernel for Hopper (sm_90a).
//
// Replaces the Pallas replay backward
// raytracinginoneweekendincuda_tpu/ops/pallas_replay.py::_bwd_kernel_factory.
// Each lane first recomputes the forward bounce states (o, d, thr), then
// sweeps the bounces in reverse: each bounce is recomputed from its state
// and its hand-written adjoint (replay_bounce.cuh: bounce_bwd) maps the
// cotangents of its outputs to those of its inputs.  Outputs:
//
//   d_rays [n, 7]   cotangents of origin, direction and time, per lane;
//   d_bg   [n, 3]   background cotangent per lane (the wrapper sums it);
//   d_rep  [NP, 27] the table cotangent summed over all lanes.
//
// What bounds it: the recompute (two forward bounces per bounce) and the
// adjoint arithmetic, ~3.6x the forward's FP32 work, at the occupancy that
// a lane's 168 registers leave (12 warps a SM): latency, not the FP32 rate;
// and the d_rep sum, in which most lane-bounces add to a few hot rows (the
// ground sphere of scene 0 takes 47% of the step's hits).  Per lane it
// reads 28 + 4K + 4 + 12 bytes and writes 40.
//
// What the design does about it, against the TPU kernel's use of VMEM:
// - The bounce states live in dynamic shared memory, [K][9][threads]
//   floats (structure of arrays: a warp's 32 threads read 32 consecutive
//   words, no bank conflicts), where the TPU kernel kept them in VMEM
//   scratch; not in a run-time-indexed local array, which went to L2.
// - d_rep is summed in shared memory, [NP, 27] floats a block, where the
//   TPU kernel kept a VMEM-resident accumulator across its sequential
//   grid; each lane-bounce adds its row's nonzero columns there, one
//   atomic each (shuffle sums over the warp first cost more than they
//   save here, PERF.md).  When the queue is empty the block adds its
//   nonzero entries to the global d_rep once.  Tables whose d_rep does
//   not fit beside the states (above the 227 KB opt-in; the wrapper
//   decides, ops/replay_cuda.py::bwd_rep_in_shared) run the other
//   instantiation, which adds into the global d_rep directly, groups of
//   lanes that share a row summed by shuffles first (add_row).  Atomics
//   make d_rep's summation order change from run to run; the gates hold
//   it to rel-L2 1e-3 of autograd's for that reason.  d_rays and d_bg are
//   per lane and do not depend on the order.
// - A persistent grid (persistent_grid.cuh) whose warps take 32 lanes at
//   a time from a queue, so a block's accumulator covers many lanes and
//   the short paths' tail balances over the card.  A warp's reverse sweep
//   starts at its longest path, not at K - 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "persistent_grid.cuh"
#include "replay_bounce.cuh"

namespace {

// 384 threads a block, one block a SM: registers capped at 170 (ptxas
// uses 168, no spills: 12 warps a SM), and the states with scene 0's d_rep
// (166 KB) fit its shared memory.  320 threads (10 warps) and 448 (128
// registers, spilling) took longer at the train step's shape (PERF.md).
constexpr int kBlock = 384;
constexpr int kMinBlocks = 1;
constexpr int kStateWords = 9;      // o, d, thr
constexpr int kGroup = 8;           // lanes a row that add_row sums first
constexpr unsigned kFull = 0xffffffffu;

// Bounce k's start state of thread t, in the [K][9][threads] layout.
__device__ __forceinline__ void put_state(float* st, int k, int threads,
                                          int t, const replay::State& s) {
  float* q = st + (size_t)k * kStateWords * threads + t;
  q[0] = s.o.x;
  q[threads] = s.o.y;
  q[2 * threads] = s.o.z;
  q[3 * threads] = s.d.x;
  q[4 * threads] = s.d.y;
  q[5 * threads] = s.d.z;
  q[6 * threads] = s.thr[0];
  q[7 * threads] = s.thr[1];
  q[8 * threads] = s.thr[2];
}

__device__ __forceinline__ replay::State get_state(const float* st, int k,
                                                   int threads, int t) {
  const float* q = st + (size_t)k * kStateWords * threads + t;
  replay::State s;
  s.o = replay::V3{q[0], q[threads], q[2 * threads]};
  s.d = replay::V3{q[3 * threads], q[4 * threads], q[5 * threads]};
  s.thr[0] = q[6 * threads];
  s.thr[1] = q[7 * threads];
  s.thr[2] = q[8 * threads];
  return s;
}

// Adds the lane's row cotangent `v` to acc[key] (key < 0: nothing).  Called
// by all 32 threads of the warp together.  Into the block's shared d_rep
// (kSmemRep) each lane adds its nonzero columns, one atomic each.  Into the
// global d_rep, where a hot row's atomics queue at one L2 address, the
// lanes that share a row with at least kGroup - 1 others first sum each
// column with shuffles and one of them adds it; the rest add their own.
template <bool kSmemRep>
__device__ __forceinline__ void add_row(float* acc, int key,
                                        const float v[replay::REP_COLS]) {
  bool alone = key >= 0;
  if (!kSmemRep) {
    const unsigned grp = __match_any_sync(kFull, key);
    alone = alone && __popc(grp) < kGroup;
    unsigned todo = __ballot_sync(kFull, key >= 0 && !alone);
    while (todo != 0u) {
      const int lead = __ffs(todo) - 1;
      const int row = __shfl_sync(kFull, key, lead);
      const bool in = key == row && !alone;
      todo &= ~__ballot_sync(kFull, in);
#pragma unroll
      for (int c = 0; c < replay::REP_COLS; ++c) {
        float x = in ? v[c] : 0.0f;
        if (!__any_sync(kFull, x != 0.0f)) continue;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x = x + __shfl_xor_sync(kFull, x, off);
        if ((threadIdx.x & 31) == lead)
          atomicAdd(acc + (size_t)row * replay::REP_COLS + c, x);
      }
    }
  }
  if (alone) {
#pragma unroll
    for (int c = 0; c < replay::REP_COLS; ++c)
      if (v[c] != 0.0f)
        atomicAdd(acc + (size_t)key * replay::REP_COLS + c, v[c]);
  }
}

template <bool kSmemRep>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
replay_bwd_kernel(const replay::Params p, const float* __restrict__ rays,
                  const int* __restrict__ tape,
                  const int* __restrict__ pix_ctr,
                  const float* __restrict__ g_out,
                  float* __restrict__ d_rays, float* __restrict__ d_rep,
                  float* __restrict__ d_bg, unsigned* __restrict__ queue) {
  extern __shared__ float smem[];
  const int threads = blockDim.x, t = threadIdx.x;
  float* st = smem;                                    // [K][9][threads]
  const int rep_words = p.np_rows * replay::REP_COLS;
  float* acc = kSmemRep ? smem + (size_t)p.K * kStateWords * threads : d_rep;
  if (kSmemRep) {
    for (int i = t; i < rep_words; i += threads) acc[i] = 0.0f;
    __syncthreads();
  }

  // Each round the warp takes the next 32 lanes (blockDim.x is a multiple
  // of 32, so every warp is whole); all its threads stay in the loop until
  // the queue is empty, so the warp intrinsics see all 32.
  while (true) {
    unsigned base = 0u;
    if ((t & 31) == 0) base = atomicAdd(queue, 32u);
    base = __shfl_sync(kFull, base, 0);
    if (base >= (unsigned)p.n) break;
    const int lane = (int)base + (t & 31);
    const bool valid = lane < p.n;
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
        put_state(st, k, threads, t, s);
        replay::Rec r;
        float dacc[3];
        nact = k + 1;
        if (!replay::bounce_fwd(p, tape[(size_t)k * p.n + lane], tm, pc, k,
                                s, r, dacc))
          break;
      }
    }

    // reverse sweep, from the warp's longest path
    replay::State dout;
    dout.o = replay::V3{0.0f, 0.0f, 0.0f};
    dout.d = dout.o;
    dout.thr[0] = dout.thr[1] = dout.thr[2] = 0.0f;
    replay::Grad g;
    g.tm = 0.0f;
    g.bg[0] = g.bg[1] = g.bg[2] = 0.0f;
    for (int k = __reduce_max_sync(kFull, nact) - 1; k >= 0; --k) {
#pragma unroll
      for (int c = 0; c < replay::REP_COLS; ++c) g.row[c] = 0.0f;
      int key = -1;
      if (k < nact) {
        const replay::State s = get_state(st, k, threads, t);
        replay::State s2 = s;
        replay::Rec r;
        float dacc[3];
        replay::bounce_fwd(p, tape[(size_t)k * p.n + lane], tm, pc, k, s2,
                           r, dacc);
        replay::bounce_bwd(p, tm, s, r, dout, gacc, g);
        dout.o = g.o;
        dout.d = g.d;
        for (int c = 0; c < 3; ++c) dout.thr[c] = g.thr[c];
        key = r.hit ? r.idx : -1;
      }
      add_row<kSmemRep>(acc, key, g.row);
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

  if (kSmemRep) {
    __syncthreads();
    for (int i = t; i < rep_words; i += threads) {
      const float v = acc[i];
      if (v != 0.0f) atomicAdd(d_rep + i, v);
    }
  }
}

template <bool kSmemRep>
cudaError_t launch(const replay::Params& p, const float* rays,
                   const int* tape, const int* pix_ctr, const float* g,
                   float* d_rays, float* d_rep, float* d_bg, unsigned* queue,
                   int smem_bytes, int shape[3], cudaStream_t stream) {
  const cudaError_t err = persistent::launch_shape(
      replay_bwd_kernel<kSmemRep>, p.n, persistent::queue_threads(p.n, kBlock),
      smem_bytes, shape);
  if (err != cudaSuccess) return err;
  replay_bwd_kernel<kSmemRep><<<shape[0], shape[1], smem_bytes, stream>>>(
      p, rays, tape, pix_ctr, g, d_rays, d_rep, d_bg, queue);
  return cudaGetLastError();
}

}  // namespace

// Launches K4 on `stream`: rays f32 [n, 7], tape int32 [K, n], pix_ctr
// int32 [n], g f32 [n, 3] (the radiance cotangent); writes d_rays f32
// [n, 7] and d_bg f32 [n, 3], and adds into d_rep f32 [np_rows, 27], which
// the caller zeroes.  `queue` is one device uint32, which the launch
// zeroes.  rep_shared != 0 sums d_rep in shared memory first (the wrapper's
// rule, ops/replay_cuda.py::bwd_rep_in_shared; refused with
// cudaErrorInvalidValue when the states and d_rep exceed the opt-in).  K
// must not exceed replay::KMAX.  `shape` receives (blocks, threads a
// block, shared bytes).  Returns a CUDA error code: that of the launch, of
// the memset or of a device query.
extern "C" int replay_bwd_launch(const replay::Params* params,
                                 const void* rays, const void* tape,
                                 const void* pix_ctr, const void* g,
                                 void* d_rays, void* d_rep, void* d_bg,
                                 void* queue, int rep_shared, int* shape,
                                 void* stream) {
  shape[0] = shape[1] = shape[2] = 0;
  const replay::Params& p = *params;
  if (p.K > replay::KMAX) return (int)cudaErrorInvalidValue;
  if (p.n < 1) return (int)cudaGetLastError();
  int sms = 0, optin = 0;
  cudaError_t err = persistent::device_limits(sms, optin);
  if (err != cudaSuccess) return (int)err;
  const auto st = (cudaStream_t)stream;
  err = cudaMemsetAsync(queue, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const long threads = persistent::queue_threads(p.n, kBlock);
  const long states = (long)sizeof(float) * kStateWords * p.K * threads;
  const long rep = (long)sizeof(float) * replay::REP_COLS * p.np_rows;
  const auto* r = (const float*)rays;
  const auto* tp = (const int*)tape;
  const auto* pc = (const int*)pix_ctr;
  const auto* gg = (const float*)g;
  auto* dr = (float*)d_rays;
  auto* dp = (float*)d_rep;
  auto* db = (float*)d_bg;
  auto* qu = (unsigned*)queue;
  if (rep_shared) {
    if (states + rep > optin) return (int)cudaErrorInvalidValue;
    err = launch<true>(p, r, tp, pc, gg, dr, dp, db, qu,
                       (int)(states + rep), shape, st);
  } else {
    err = launch<false>(p, r, tp, pc, gg, dr, dp, db, qu, (int)states,
                        shape, st);
  }
  return (int)err;
}

// sizeof(replay::Params), so the host can check its mirror of the struct.
extern "C" int replay_params_size() { return (int)sizeof(replay::Params); }

// The deepest replay the backward takes (replay::KMAX).
extern "C" int replay_bwd_kmax() { return replay::KMAX; }

// K4's largest block, which the host's shared-memory rule assumes.
extern "C" int replay_bwd_block() { return kBlock; }

// The opt-in shared memory a block may use on the current device, bytes
// (0 if the query fails).
extern "C" int replay_bwd_smem_optin() {
  int sms = 0, optin = 0;
  return persistent::device_limits(sms, optin) == cudaSuccess ? optin : 0;
}
