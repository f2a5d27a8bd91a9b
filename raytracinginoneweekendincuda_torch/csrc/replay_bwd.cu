// K4: the replay backward kernel for Hopper (sm_90a).
//
// Replaces the Pallas replay backward
// raytracinginoneweekendincuda_tpu/ops/pallas_replay.py::_bwd_kernel_factory.
// Each lane first recomputes the forward bounce states (o, d, thr), then
// sweeps the bounces in reverse: each bounce is recomputed from its state
// and its hand-written adjoint (replay_bounce.cuh: bounce_bwd) maps the
// cotangents of its outputs to those of its inputs.  Outputs:
//
//   d_rays [n, 7]      cotangents of origin, direction and time, per lane;
//   d_bg   [n, 3]      background cotangent per lane (the wrapper sums it);
//   rows   [K, n, 27]  each lane-bounce's cotangent of its winner's table
//   keys   [K, n]      row, and that row (-1: none); the wrapper sums them
//                      into d_rep [NP, 27] in a fixed order.
//
// What bounds it: the recompute (two forward bounces per bounce) and the
// adjoint arithmetic, ~3.6x the forward's FP32 work, at the occupancy that
// a lane's 168 registers leave (12 warps a SM): latency, not the FP32 rate;
// and the row writes, 4 + 108 bytes a lane-bounce that hits.  Per lane it
// reads 28 + 4K + 4 + 12 bytes and writes 40 + 4K.
//
// What the design does about it, against the TPU kernel's use of VMEM:
// - The bounce states live in dynamic shared memory, [K][9][threads]
//   floats (structure of arrays: a warp's 32 threads read 32 consecutive
//   words, no bank conflicts), where the TPU kernel kept them in VMEM
//   scratch; not in a run-time-indexed local array, which went to L2.
// - d_rep is not summed here.  The TPU kernel kept a VMEM-resident
//   accumulator across its sequential grid, an order fixed by the grid;
//   on Hopper the blocks run in no order, and atomics (shared or global)
//   add in an order that changes from run to run, so a train step would
//   not repeat.  Instead each lane-bounce writes its row cotangent and
//   its winner row to its own slot, rows [K, n, 27] and keys [K, n] (-1:
//   no row; the row is then left unwritten), slots fixed by (bounce,
//   lane) whatever lane order the queue hands out.  rep_sum.cu then sums
//   them in an order fixed by the keys alone (after a stable sort of the
//   keys; its plain version ops/replay_cuda.py::rep_sum_plain, through
//   ops/hit.py::row_sum), so d_rep repeats bit for bit.  d_rays and d_bg
//   are per lane.
// - A persistent grid (persistent_grid.cuh) whose warps take 32 lanes at
//   a time from a queue, so the short paths' tail balances over the
//   card.  A warp's reverse sweep starts at its longest path, not at
//   K - 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "persistent_grid.cuh"
#include "replay_bounce.cuh"

namespace {

// 384 threads a block, one block a SM: registers capped at 170 (12 warps
// a SM), the states (110 KB at K 8) in its shared memory.  320 threads
// (10 warps) and 448 (128 registers, spilling) took longer at the train
// step's shape (PERF.md).
constexpr int kBlock = 384;
constexpr int kMinBlocks = 1;
constexpr int kStateWords = 9;      // o, d, thr
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

__global__ void __launch_bounds__(kBlock, kMinBlocks)
replay_bwd_kernel(const replay::Params p, const float* __restrict__ rays,
                  const int* __restrict__ tape,
                  const int* __restrict__ pix_ctr,
                  const float* __restrict__ g_out,
                  float* __restrict__ d_rays, float* __restrict__ d_bg,
                  float* __restrict__ rows, int* __restrict__ keys,
                  unsigned* __restrict__ queue) {
  extern __shared__ float smem[];
  const int threads = blockDim.x, t = threadIdx.x;
  float* st = smem;                                    // [K][9][threads]

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

    // reverse sweep, from the warp's longest path; each lane-bounce's row
    // cotangent goes to its own slot (k, lane)
    replay::State dout;
    dout.o = replay::V3{0.0f, 0.0f, 0.0f};
    dout.d = dout.o;
    dout.thr[0] = dout.thr[1] = dout.thr[2] = 0.0f;
    replay::Grad g;
    g.tm = 0.0f;
    g.bg[0] = g.bg[1] = g.bg[2] = 0.0f;
    const int kmax = __reduce_max_sync(kFull, nact);
    for (int k = kmax - 1; k >= 0; --k) {
      int key = -1;
      if (k < nact) {
        const replay::State s = get_state(st, k, threads, t);
        replay::State s2 = s;
        replay::Rec r;
        float dacc[3];
        replay::bounce_fwd(p, tape[(size_t)k * p.n + lane], tm, pc, k, s2,
                           r, dacc);
#pragma unroll
        for (int c = 0; c < replay::REP_COLS; ++c) g.row[c] = 0.0f;
        replay::bounce_bwd(p, tm, s, r, dout, gacc, g);
        dout.o = g.o;
        dout.d = g.d;
        for (int c = 0; c < 3; ++c) dout.thr[c] = g.thr[c];
        key = r.hit ? r.idx : -1;
      }
      if (valid) {
        const size_t slot = (size_t)k * p.n + lane;
        keys[slot] = key;
        if (key >= 0) {
          float* o = rows + slot * replay::REP_COLS;
#pragma unroll
          for (int c = 0; c < replay::REP_COLS; ++c) o[c] = g.row[c];
        }
      }
    }
    if (valid) {
      for (int k = kmax; k < p.K; ++k) keys[(size_t)k * p.n + lane] = -1;
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
}

}  // namespace

// Launches K4 on `stream`: rays f32 [n, 7], tape int32 [K, n], pix_ctr
// int32 [n], g f32 [n, 3] (the radiance cotangent); writes d_rays f32
// [n, 7], d_bg f32 [n, 3], keys int32 [K, n] (every slot: the winner row
// of lane-bounce (k, lane), or -1) and rows f32 [K, n, 27] (the slots
// whose key is >= 0; the others are left as they were).  `queue` is one
// device uint32, which the launch zeroes.  K must not exceed
// replay::KMAX, and the states (K x 9 words a thread) must fit the opt-in
// shared memory (cudaErrorInvalidValue otherwise).  `shape` receives
// (blocks, threads a block, shared bytes).  Returns a CUDA error code:
// that of the launch, of the memset or of a device query.
extern "C" int replay_bwd_launch(const replay::Params* params,
                                 const void* rays, const void* tape,
                                 const void* pix_ctr, const void* g,
                                 void* d_rays, void* d_bg, void* rows,
                                 void* keys, void* queue, int* shape,
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
  if (states > optin) return (int)cudaErrorInvalidValue;
  err = persistent::launch_shape(replay_bwd_kernel, p.n, (int)threads,
                                 (int)states, shape);
  if (err != cudaSuccess) return (int)err;
  replay_bwd_kernel<<<shape[0], shape[1], (int)states, st>>>(
      p, (const float*)rays, (const int*)tape, (const int*)pix_ctr,
      (const float*)g, (float*)d_rays, (float*)d_bg, (float*)rows,
      (int*)keys, (unsigned*)queue);
  return (int)cudaGetLastError();
}

// sizeof(replay::Params), so the host can check its mirror of the struct.
extern "C" int replay_params_size() { return (int)sizeof(replay::Params); }

// The deepest replay the backward takes (replay::KMAX).
extern "C" int replay_bwd_kmax() { return replay::KMAX; }
