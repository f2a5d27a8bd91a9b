// K1: the mega2 render kernel for Hopper (sm_90a).
//
// Replaces the persistent Pallas render kernel
// raytracinginoneweekendincuda_tpu/ops/mega2.py::_make_kernel(mode="render").
//
// What bounds it: a lane-bounce's closest hit.  Before the sphere tree,
// every lane-bounce of an unculled world (all the reference scenes) tested
// every sphere, loose quad and box slab row, and the pair loop's
// instruction issue bound the frame: on scene 0 at 1440x720@10 it ran
// sphere rows at about 80% of the rate of a bare quadratic over the whole
// card (the issue slots go to loads, compares and selects), 512 rows a
// lane-bounce where the reference's BVH walk makes ~38 box and ~2 sphere
// tests.  No gain was left in a cheaper row; the gain was in testing
// fewer rows.  Now a world with several sphere chunks walks a tree of its
// spheres (mega2_bounce.cuh, `sphere_walk`): ~34 box and ~2 sphere tests
// a lane-bounce on the benchmark's worlds (tools/tree_walk.py), a warp
// paying about its worst lane, ~55.  What bounds K1 there is the walk's
// issue: a node visit is two slab tests (~60 instructions with the loads
// and the branch), and the lanes of a warp, each at its own node and
// bounce, diverge (PERF.md: 5.2x on scene 0, 5.7x on book1_final).  The
// tree's leaves are single rows: leaves of 2 and 4 rows, or testing a leaf
// child's rows at its parent, or the child ordered by a split axis with a
// climb loop, all ran slower on the card.  The crossover: the tree was
// faster on every world of 16 or more small spheres timed; the rule takes
// it from two 64-row sphere chunks (65 rows), as no reference scene lies
// between (scenes 1-8 hold at most 3 spheres).  Before the flat loop,
// lanes idled while their warp finished a longer path (paths end after 1
// to max_bounces bounces): a sample loop around a bounce loop kept about
// 40% of the lane slots busy there.
//
// What the design does about it:
// - One flat loop a lane.  A lane holds one path (pixel, sample, bounce,
//   ray, thr, acc) and its pixel's running sum; each iteration runs one
//   mega2::bounce on every lane that has a path.  A lane whose path ends
//   (miss, light, no scatter, or max_bounces) adds acc to the pixel's sum
//   -- in sample order, from 0, as the plain version does -- and in the
//   same iteration starts the pixel's next sample, or writes the sum and
//   takes the next pixel.  No lane waits at an inner loop's exit for the
//   longest path of its warp.
// - A pixel queue.  Lanes take indices into `pix` from one counter, one
//   warp-aggregated atomicAdd a warp and refill round, so every lane keeps
//   a path until the queue is empty; only the frame's tail idles.  Which
//   lane renders which pixel changes from run to run; a pixel's sum does
//   not (samples are summed in order and the RNG is keyed on pixel, sample
//   and bounce), so the output is bit-identical from run to run.
// - A persistent grid: the SMs times the blocks a SM holds at this block
//   size and shared memory, and never more warps than the ids need
//   (persistent_grid.cuh).
// - Pair rows in shared memory.  Each block copies the sphere, loose-quad
//   and box rows once (float4 copies); the pair loops then read them from
//   shared memory, which K1 needs: with the rows in global memory (L1
//   broadcasts) scene 0 at 1440x720@10 takes 1.2x as long (PERF.md).  A
//   world whose rows exceed a block's opt-in shared memory reads them from
//   global memory instead, in the other instantiation of the same kernel,
//   chosen here by the rows' size.  The attr, media, Perlin and texel
//   tables stay in global memory: only the winner reads them, once a
//   bounce.
// - The chunk cull of large worlds (the JAX kernel's, mega2_bounce.cuh):
//   a world whose tables say so (the packer's cull flags) runs the
//   instantiation whose closest hit walks 64-row chunks and skips, lane
//   by lane, the chunks its ray cannot meet.
// - The sphere tree of an unculled world with several sphere chunks (the
//   packer's tree_n > 0): the instantiation whose closest sphere walks
//   the tree, its nodes beside the rows (in shared memory when both fit).
//   The others run the loops over every row: six instantiations, rows in
//   shared or global memory times culled, tree or neither, chosen in the
//   launch.
// - A sample window, as the JAX kernel's SMEM scalar samp0: the launch
//   renders local samples [0, spp), and raygen and every draw key on the
//   global sample s + Params.samp0 (the sample axis of a sharded render,
//   parallel/render.py); samp0 = 0 is the whole-frame render.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "mega2_bounce.cuh"
#include "persistent_grid.cuh"

namespace {

// 384 threads a block (at most), two blocks a SM: registers capped at 85
// a thread (ptxas takes 79-80, no spills), 24 warps a SM; two copies of
// scene 0's rows and tree nodes (62 KB) fit a SM's shared memory, one of
// scene 9's (159 KB: 96 KB of rows, 64 KB of nodes).
constexpr int kBlock = 384;
constexpr int kMinBlocks = 2;
constexpr unsigned kFull = 0xffffffffu;

template <bool kSmemRows, bool kCull, bool kTree>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
mega2_render_kernel(const mega2::Params p, const int* __restrict__ pix,
                    int n, float* __restrict__ out,
                    unsigned* __restrict__ queue) {
  extern __shared__ float4 smem_rows[];
  mega2::PairRows rows = mega2::global_rows(p);
  if (kSmemRows) {
    const float4* sph = reinterpret_cast<const float4*>(p.sph);
    const float4* lquad = reinterpret_cast<const float4*>(p.quad);
    const float4* box = reinterpret_cast<const float4*>(rows.box);
    const float4* tree = reinterpret_cast<const float4*>(p.tree);
    const int n_s = 4 * p.s_pad, n_l = 4 * p.nl_pad, n_b = 4 * p.b_pad;
    const int n_r = n_s + n_l + n_b;
    const int n_t = kTree ? 4 * p.tree_n : 0;   // 2n nodes, 2 float4 each
    for (int i = threadIdx.x; i < n_r + n_t; i += blockDim.x) {
      smem_rows[i] = i < n_s ? __ldg(sph + i)
                   : i < n_s + n_l ? __ldg(lquad + (i - n_s))
                   : i < n_r ? __ldg(box + (i - n_s - n_l))
                             : __ldg(tree + (i - n_r));
    }
    __syncthreads();
    const float* base = reinterpret_cast<const float*>(smem_rows);
    rows = {base, base + mega2::SPH_COLS * p.s_pad,
            base + mega2::SPH_COLS * (p.s_pad + p.nl_pad),
            base + 4 * n_r};
  }

  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned kx = 0u;              // the lane's index into pix
  uint32_t pix_ctr = 0u;
  float i_f = 0.0f, j_f = 0.0f;
  int s = p.spp;                 // the path's sample; >= spp: needs a pixel
  int b = 0;                     // the path's bounce
  bool done = false;             // the queue is empty for this lane
  bool fresh = false;            // the path starts this iteration
  mega2::Ray r{};
  float thr[3] = {1.0f, 1.0f, 1.0f};
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float sum[3] = {0.0f, 0.0f, 0.0f};

  // Every lane of the warp stays in this loop until the whole warp is
  // done, so the warp-wide intrinsics below always see all 32 lanes.
  while (true) {
    // refill: lanes whose pixel is finished take the next ids, one
    // atomicAdd a warp and round; an id < 0 gives zeros and another round
    bool need = !done && s >= p.spp;
    unsigned want;
    while ((want = __ballot_sync(kFull, need)) != 0u) {
      const int leader = __ffs(want) - 1;
      unsigned base = 0u;
      if (lane == leader) base = atomicAdd(queue, (unsigned)__popc(want));
      base = __shfl_sync(kFull, base, leader);
      if (need) {
        kx = base + (unsigned)__popc(want & below);
        if (kx >= (unsigned)n) {
          done = true;
          need = false;
        } else {
          const int pid = pix[kx];
          if (pid < 0 || p.spp <= 0) {
            out[3 * kx + 0] = 0.0f;
            out[3 * kx + 1] = 0.0f;
            out[3 * kx + 2] = 0.0f;
          } else {
            need = false;
            pix_ctr = (uint32_t)pid ^ p.seed;
            i_f = (float)(pid % p.width);
            j_f = (float)(pid / p.width);
            s = 0;
            sum[0] = sum[1] = sum[2] = 0.0f;
            fresh = true;
          }
        }
      }
    }
    if (!__any_sync(kFull, !done)) break;
    if (done) continue;

    if (fresh) {
      r = mega2::raygen(p, pix_ctr, (uint32_t)(s + p.samp0), i_f, j_f);
      thr[0] = thr[1] = thr[2] = 1.0f;
      acc[0] = acc[1] = acc[2] = 0.0f;
      b = 0;
      fresh = false;
    }
    int win;
    const bool alive = mega2::bounce<true, kSmemRows, kCull, kTree>(
        p, rows, pix_ctr, (uint32_t)(s + p.samp0), (uint32_t)b, r, thr, acc,
        win);
    if (alive && b + 1 < p.max_bounces) {
      ++b;
      continue;
    }
    sum[0] = sum[0] + acc[0];
    sum[1] = sum[1] + acc[1];
    sum[2] = sum[2] + acc[2];
    if (++s < p.spp) {
      fresh = true;
    } else {
      out[3 * kx + 0] = sum[0];
      out[3 * kx + 1] = sum[1];
      out[3 * kx + 2] = sum[2];
    }
  }
}

template <bool kSmemRows, bool kCull, bool kTree>
cudaError_t launch(const mega2::Params& p, const int* pix, int n,
                   float* out, unsigned* queue, int smem_bytes, int shape[3],
                   cudaStream_t stream) {
  const cudaError_t err = persistent::launch_shape(
      mega2_render_kernel<kSmemRows, kCull, kTree>, n,
      persistent::queue_threads(n, kBlock), smem_bytes, shape);
  if (err != cudaSuccess) return err;
  mega2_render_kernel<kSmemRows, kCull, kTree>
      <<<shape[0], shape[1], smem_bytes, stream>>>(p, pix, n, out, queue);
  return cudaGetLastError();
}

// The rows (and the tree's nodes) in shared memory when they fit a block's
// opt-in, else in global memory.
template <bool kCull, bool kTree>
cudaError_t launch_rows(const mega2::Params& p, const int* pix, int n,
                        float* out, unsigned* queue, int smem_optin,
                        int shape[3], cudaStream_t stream) {
  const long rows = (long)p.s_pad + p.nl_pad + p.b_pad;
  const long bytes = rows * mega2::SPH_COLS * (long)sizeof(float)
                     + (kTree ? 2L * p.tree_n * mega2::TREE_COLS
                                    * (long)sizeof(float)
                              : 0L);
  if (bytes > 0 && bytes <= smem_optin)
    return launch<true, kCull, kTree>(p, pix, n, out, queue, (int)bytes,
                                      shape, stream);
  return launch<false, kCull, kTree>(p, pix, n, out, queue, 0, shape,
                                     stream);
}

}  // namespace

// Launches K1 on `stream` for the n pixel ids in `pix` (device int32; ids
// < 0 give zeros), writing radiance sums [n, 3] f32 to `out`.  `queue` is
// one device uint32, zero at launch.  The pair rows go to shared memory
// when they fit a block's opt-in shared memory, else the kernel reads them
// from global memory; the culled instantiation runs when the tables cull
// pair or box chunks.  The grid is persistent (persistent_grid.cuh): at
// most the blocks the card holds at once, never more threads than ids
// (rounded up to a warp).  An unculled world with a sphere tree
// (p.tree_n > 0) runs the instantiation that walks it, with its nodes
// where the rows are.  `shape` receives (blocks, threads a block,
// shared bytes: 0 for rows in global memory).  Returns a CUDA error code:
// the launch's cudaGetLastError(), or the error of a device query.
extern "C" int mega2_render_launch(const mega2::Params* params,
                                   const void* pix, int n, void* out,
                                   void* queue, int* shape, void* stream) {
  shape[0] = shape[1] = shape[2] = 0;
  if (n < 1) return (int)cudaGetLastError();
  int sms = 0, optin = 0;
  cudaError_t err = persistent::device_limits(sms, optin);
  if (err != cudaSuccess) return (int)err;
  const mega2::Params& p = *params;
  if (p.cull_pairs || p.cull_boxes)
    err = launch_rows<true, false>(p, (const int*)pix, n, (float*)out,
                                   (unsigned*)queue, optin, shape,
                                   (cudaStream_t)stream);
  else if (p.tree_n > 0)
    err = launch_rows<false, true>(p, (const int*)pix, n, (float*)out,
                                   (unsigned*)queue, optin, shape,
                                   (cudaStream_t)stream);
  else
    err = launch_rows<false, false>(p, (const int*)pix, n, (float*)out,
                                    (unsigned*)queue, optin, shape,
                                    (cudaStream_t)stream);
  return (int)err;
}

// sizeof(mega2::Params), so the host can check its mirror of the struct.
extern "C" int mega2_params_size() { return (int)sizeof(mega2::Params); }
