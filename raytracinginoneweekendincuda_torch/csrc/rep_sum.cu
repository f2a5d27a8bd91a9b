// K4's fixed-order sum for Hopper (sm_90a): d_rep from K4's slots.
//
// Part of the port of the Pallas replay backward
// raytracinginoneweekendincuda_tpu/ops/pallas_replay.py::_bwd_kernel_factory,
// whose d_rep accumulator the TPU kernel kept in VMEM across its sequential
// grid.  K4 (replay_bwd.cu) writes each lane-bounce's row cotangent to its
// own slot (rows [S, 27], keys [S]: the winner row, or -1); this sums them
// into d_rep [np_rows, 27] in an order fixed by the keys alone, so a train
// step repeats bit for bit (float atomics add in an order that changes
// from run to run).
//
// The host (ops/replay_cuda.py::rep_sum_cuda) sorts the keys (a stable
// sort: a row's slots in slot order) and cuts each row's run of the sorted
// slots into chunks of kChunk; chunk_first[r] is the first chunk of row r
// (an exclusive prefix sum, chunk_first[np_rows] chunks in all), starts[r]
// its first sorted position.  Then two kernels:
//
//   chunk_sum  one block a chunk: thread t adds the chunk's entries t,
//              t + kBlock, ... in order, then a shared-memory tree (fixed
//              pairs) sums the threads; one partial row [27] a chunk.
//   row_sum    one thread a (row, column): the row's chunk partials in
//              chunk order.
//
// Every sum's order is a function of the keys, never of scheduling.
//
// What bounds it: the slots with a row (270 k of the train step's 1.84 M
// at scene 0, 108 bytes each) read once, gathered through the sort's
// permutation, and the keys (4 bytes a slot) read by the host's sort; a
// few FP32 adds a byte.  Memory, then the launches.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 27;        // replay::REP_COLS
constexpr int kBlock = 256;      // threads of a chunk_sum block
constexpr int kChunk = 2048;     // sorted entries a chunk: 8 a thread

// The chunk's row: the r with chunk_first[r] <= b < chunk_first[r + 1]
// (binary search; rows without entries have no chunk).
__device__ __forceinline__ int row_of(const int* __restrict__ chunk_first,
                                      int np_rows, int b) {
  int lo = 0, hi = np_rows;      // chunk_first[lo] <= b < chunk_first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_first[mid] <= b) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kBlock)
chunk_sum_kernel(const float* __restrict__ rows,
                 const int64_t* __restrict__ order,
                 const int* __restrict__ starts,
                 const int* __restrict__ chunk_first, int np_rows,
                 float* __restrict__ partial) {
  __shared__ float red[kCols][kBlock];
  const int b = blockIdx.x, t = threadIdx.x;
  if (b >= chunk_first[np_rows]) return;          // the grid's spare blocks
  const int r = row_of(chunk_first, np_rows, b);
  const int first = starts[r] + (b - chunk_first[r]) * kChunk;
  const int end = min(starts[r + 1], first + kChunk);
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  for (int e = first + t; e < end; e += kBlock) {
    const float* v = rows + (size_t)order[e] * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = acc[c] + v[c];
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) red[c][t] = acc[c];
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[c][t] = red[c][t] + red[c][t + s];
    }
    __syncthreads();
  }
  if (t < kCols) partial[(size_t)b * kCols + t] = red[t][0];
}

__global__ void row_sum_kernel(const float* __restrict__ partial,
                               const int* __restrict__ chunk_first,
                               int np_rows, float* __restrict__ d_rep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np_rows * kCols) return;
  const int r = i / kCols, c = i % kCols;
  float s = 0.0f;
  for (int q = chunk_first[r]; q < chunk_first[r + 1]; ++q)
    s = s + partial[(size_t)q * kCols + c];
  d_rep[i] = s;
}

}  // namespace

// Launches the two kernels on `stream`: rows f32 [S, 27] (K4's slots),
// order int64 [S] (the stable sort of the keys: sorted position ->
// slot), starts int32 [np_rows + 1] (row r's sorted entries are positions
// starts[r] .. starts[r + 1] - 1), chunk_first int32 [np_rows + 1] (the
// chunks of kChunk entries before row r), max_chunks (the grid; at least
// chunk_first[np_rows]), partial f32 [max_chunks, 27] (scratch), d_rep
// f32 [np_rows, 27] (written whole).  Returns a CUDA error code.
extern "C" int rep_sum_launch(const void* rows, const void* order,
                              const void* starts, const void* chunk_first,
                              int np_rows, int max_chunks, void* partial,
                              void* d_rep, void* stream) {
  const auto st = (cudaStream_t)stream;
  if (np_rows < 1) return (int)cudaGetLastError();
  if (max_chunks > 0) {
    chunk_sum_kernel<<<max_chunks, kBlock, 0, st>>>(
        (const float*)rows, (const int64_t*)order, (const int*)starts,
        (const int*)chunk_first, np_rows, (float*)partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = np_rows * kCols;
  row_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (const int*)chunk_first, np_rows,
      (float*)d_rep);
  return (int)cudaGetLastError();
}

// Entries a chunk (kChunk), so the host sizes the chunks alike.
extern "C" int rep_sum_chunk() { return kChunk; }
