// K3: the replay forward kernel for Hopper (sm_90a).
//
// Replaces the Pallas replay forward
// raytracinginoneweekendincuda_tpu/ops/pallas_replay.py::_fwd_kernel_factory.
// Each lane (a camera ray) replays up to K bounces with the winners fixed
// by the tape (tape[k * n + lane], rows of the merged replay table): per
// bounce one row read of the winner (an indexed load -- the TPU kernel's
// one-hot MXU contraction is a workaround for the lack of a lane gather),
// its re-intersection, media t, textures, emission and scatter
// (replay_bounce.cuh), summing the radiance to out[lane * 3 + c] in bounce
// order.  A lane stops at its first inactive bounce: every later bounce of
// the TPU kernel's fixed-depth loop leaves its state and radiance
// unchanged.
//
// What bounds it: per lane-bounce one ~108-byte table row (hot rows stay in
// L1/L2: the ground sphere of scene 0 takes 47% of the train step's hits)
// and ~160 FP32 operations (more on Perlin winners); per lane 28 bytes of
// ray, 4 bytes of tape per bounce and 12 bytes of radiance in device
// memory.  The bytes give the least time, yet what it takes is issue and
// latency: a bounce is a long dependent chain (tape, row, intersection,
// IEEE divisions and roots, sinf / cosf, scatter), and paths end after 1
// to K bounces.  One thread a lane on a one-shot grid kept about half of
// the thread slots busy on the step's tapes, each warp waiting for its
// longest path.
//
// What the design does about it, K1's (mega2_render.cu):
// - One flat loop a thread.  A thread holds one lane's path (ray state,
//   time, counter, bounce, radiance) and runs one bounce_fwd on it each
//   iteration.  When the path ends (the bounce was inactive, or K bounces
//   ran) it writes the lane's sum and, in the same iteration, takes the
//   next lane, so no thread waits for the longest path of its warp.
// - A lane queue: one zeroed counter, one warp-aggregated atomicAdd a warp
//   and refill round; the threads that need a lane take consecutive ids,
//   so their ray loads share cache lines.  A warp whose claim reaches the
//   end of the lanes stops asking: the paths it still runs end without an
//   atomic's round trip each (the tail of the launch).  Which thread
//   replays which lane changes from run to run; a lane's sum does not
//   (its bounces are summed in order and the RNG is keyed on its counter
//   and bounce).
// - A persistent grid (persistent_grid.cuh) of 384-thread blocks: the
//   blocks the card holds at once, two a SM.
// - The table rows stay in global memory: the hot rows live in L1, and
//   staging them in shared memory a block cost more than it saved, as did
//   reading the rays through shared memory, warps taking 32 lanes a round
//   and 128- or 256-thread blocks (PERF.md, tools/replay_split.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "persistent_grid.cuh"
#include "replay_bounce.cuh"

namespace {

constexpr int kBlock = 384;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kBlock)
replay_fwd_kernel(const replay::Params p, const float* __restrict__ rays,
                  const int* __restrict__ tape,
                  const int* __restrict__ pix_ctr,
                  float* __restrict__ out, unsigned* __restrict__ queue) {
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  unsigned lane = 0u;            // the lane whose path this thread replays
  int k = p.K;                   // its bounce; K: the thread needs a lane
  bool done = false;             // the queue is empty for this thread
  bool drained = false;          // the queue is empty for this warp
  replay::State s;
  float tm = 0.0f;
  uint32_t pc = 0u;
  float acc[3] = {0.0f, 0.0f, 0.0f};

  // Every thread of the warp stays in this loop until the whole warp is
  // done, so the warp-wide intrinsics below always see all 32.
  while (true) {
    // refill: threads whose path ended take the next lanes, one atomicAdd
    // a warp; once a claim reached the end, lane ids >= n, without asking
    const bool need = !done && k >= p.K;
    const unsigned want = __ballot_sync(kFull, need);
    if (want != 0u) {
      unsigned base = (unsigned)p.n;
      if (!drained) {
        const int leader = __ffs(want) - 1;
        if (wl == leader) base = atomicAdd(queue, (unsigned)__popc(want));
        base = __shfl_sync(kFull, base, leader);
        drained = base + (unsigned)__popc(want) >= (unsigned)p.n;
      }
      if (need) {
        lane = base + (unsigned)__popc(want & below);
        if (lane >= (unsigned)p.n) {
          done = true;
        } else {
          const float* q = rays + 7 * (size_t)lane;
          s.o = replay::V3{q[0], q[1], q[2]};
          s.d = replay::V3{q[3], q[4], q[5]};
          tm = q[6];
          s.thr[0] = s.thr[1] = s.thr[2] = 1.0f;
          pc = (uint32_t)pix_ctr[lane];
          acc[0] = acc[1] = acc[2] = 0.0f;
          k = 0;
        }
      }
    }
    if (!__any_sync(kFull, !done)) break;
    if (done) continue;

    replay::Rec r;
    float dacc[3];
    const bool alive = replay::bounce_fwd(p, tape[(size_t)k * p.n + lane],
                                          tm, pc, k, s, r, dacc);
    acc[0] = acc[0] + dacc[0];
    acc[1] = acc[1] + dacc[1];
    acc[2] = acc[2] + dacc[2];
    if (alive && k + 1 < p.K) {
      ++k;
      continue;
    }
    k = p.K;
    out[3 * (size_t)lane + 0] = acc[0];
    out[3 * (size_t)lane + 1] = acc[1];
    out[3 * (size_t)lane + 2] = acc[2];
  }
}

}  // namespace

// Launches K3 on `stream`: rays f32 [n, 7], tape int32 [K, n], pix_ctr
// int32 [n] (uint32 bits), out f32 [n, 3].  `queue` is one device uint32,
// which the launch zeroes.  K < 1 writes zeros (no bounce).  The grid is
// persistent (persistent_grid.cuh); `shape` receives (blocks, threads a
// block, shared bytes).  Returns a CUDA error code: that of the launch, of
// a memset or of a device query.
extern "C" int replay_fwd_launch(const replay::Params* params,
                                 const void* rays, const void* tape,
                                 const void* pix_ctr, void* out, void* queue,
                                 int* shape, void* stream) {
  shape[0] = shape[1] = shape[2] = 0;
  const replay::Params& p = *params;
  if (p.n < 1) return (int)cudaGetLastError();
  const auto st = (cudaStream_t)stream;
  if (p.K < 1)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * 3 * (size_t)p.n, st);
  cudaError_t err = cudaMemsetAsync(queue, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  err = persistent::launch_shape(replay_fwd_kernel, p.n,
                                 persistent::queue_threads(p.n, kBlock), 0,
                                 shape);
  if (err != cudaSuccess) return (int)err;
  replay_fwd_kernel<<<shape[0], shape[1], 0, st>>>(
      p, (const float*)rays, (const int*)tape, (const int*)pix_ctr,
      (float*)out, (unsigned*)queue);
  return (int)cudaGetLastError();
}

// sizeof(replay::Params), so the host can check its mirror of the struct.
extern "C" int replay_params_size() { return (int)sizeof(replay::Params); }

