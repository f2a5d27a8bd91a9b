// P3: the kernel-design probes of the Pallas TPU backend, as Hopper
// (sm_90a) kernels.
//
// Replaces the eleven Pallas probes of tools/probe_mosaic.py (pallas_call
// at :53, 69, 86, 102, 122, 136, 154, 171, 188, 215, 240).  On the TPU each
// asked whether Mosaic could lower a pattern the render kernel needed; here
// each is the plain CUDA form of the same computation, and the question is
// what it costs on the card:
//
//   while_vector_cond   one block loops until __syncthreads_or says no
//                       element is below 10 (the persistent-loop exit)
//   gather_lane         a lane gather from a row held in shared memory
//   gather_rows         take_along_axis on axis 1 (gather_lane_full, the
//                       gather_wide probes, the int32 image-texel table):
//                       a row that fits in 48 KB is staged in shared memory,
//                       a wider one (the 256 KB and 2 MB tables; a block has
//                       at most 227 KB) is read from global memory
//   gather_sublane      take_along_axis on axis 0 from the [256, 128] table:
//                       one block a row of idx, each thread one __ldg of
//                       its index and one of its element
//   dot_chunks          sum over chunks of [M, K] x [K, N] (the dynamic
//                       sublane slice + dot, and the f32 matmul): one thread
//                       an output, K terms left to right on CUDA cores, B in
//                       shared memory; no tensor cores, no library call
//   onehot_dot          a^T . (w == hot): the one-hot winner read, a block
//                       a 4 x 32 tile of the output, the tile's columns of
//                       w and a staged in shared memory by cp.async
//   gather_timing       REP gathers from a [24, 256] table (the Perlin access
//                       shape) in shared memory, summed
//   trig                acos(clip(x, -1, 1)) + atan2(x, 1 - x)
//
// The gathers clamp an index outside the table to its edge (jnp's
// mode="clip"; the probes' indices are in range), so a launch needs no
// host-side check.  Each entry point returns the launch's
// cudaGetLastError().
//
// What bounds them: all are tiny, so at the probes' shapes a launch's
// fixed cost and, inside it, the
// longest chain of dependent steps of one block bound them; none comes
// near the card's memory or FP32 rate.  Hence the two that lost to their
// PyTorch call (PERF.md) were reshaped to shorten their one-block chains:
//   gather_sublane      first staged the whole 128 KB table in the shared
//                       memory of one block of 1024 threads (32 serial
//                       loads a thread, and the opt-in attribute set on
//                       every launch) to read 1,024 elements of it; it now
//                       reads only those, over a block per row of idx
//                       (8 blocks), one dependent load pair a thread.
//   onehot_dot          ran 4 blocks of 1024 threads on 132 SMs, each
//                       first staging all of a (32 KB), then a 256-step
//                       chain a thread with a global load of w at each
//                       step, whose latency the chain waited out.  It now
//                       runs 32 blocks of 128 threads, each staging only
//                       its tile's columns of w and a (36 KB) by cp.async,
//                       every copy in flight at once, and runs the chain
//                       from shared memory.  The sum stays left to right,
//                       each term a[n, c] * (0 or 1) as in the plain
//                       version, so a cold term's +-0 and a NaN or inf in
//                       a still reach the result as there.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kStaticSmem = 48 * 1024;  // shared memory without opt-in
// onehot_dot's tile: rows c and columns j of out a block, rows n of w and
// a staged at a time (36 KB)
constexpr int kOhC = 4, kOhJ = 32, kOhN = 256;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

__global__ void while_vector_cond_kernel(const float* __restrict__ x, int n,
                                         float* __restrict__ out) {
  const int t = threadIdx.x;
  float v = t < n ? x[t] : 0.0f;
  int count = 0;
  while (__syncthreads_or(t < n && v < 10.0f)) {
    v = v + 1.0f;
    ++count;
  }
  if (t < n) out[t] = v + (float)count;
}

// out[r, j] = row_r[idx[r, j] mod 128], row_r = t[r, :128] * 0 + t[r, :128]
__global__ void gather_lane_kernel(const float* __restrict__ t, int width,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out) {
  __shared__ float row[128];
  const int r = blockIdx.x, j = threadIdx.x;
  const float v = t[r * width + j];
  row[j] = v * 0.0f + v;
  __syncthreads();
  const int i = idx[r * 128 + j] % 128;
  out[r * 128 + j] = row[i < 0 ? i + 128 : i];
}

// out[r, j] = t[r, clamp(idx[r, j], 0, width - 1)] on 32-bit words, one
// block a row
template <bool kShared>
__global__ void gather_rows_kernel(const unsigned* __restrict__ t, int width,
                                   const int* __restrict__ idx, int m,
                                   unsigned* __restrict__ out) {
  extern __shared__ unsigned smem_rows[];
  const int r = blockIdx.x;
  const unsigned* src = t + (size_t)r * width;
  if (kShared) {
    for (int k = threadIdx.x; k < width; k += blockDim.x) {
      smem_rows[k] = src[k];
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int i = min(max(idx[r * m + j], 0), width - 1);
    out[r * m + j] = kShared ? smem_rows[i] : __ldg(src + i);
  }
}

// out[r, j] = t[clamp(idx[r, j], 0, n_rows - 1), j]; t [n_rows, cols] read
// from global memory, one block a row of idx
__global__ void gather_sublane_kernel(const float* __restrict__ t,
                                      int n_rows, int cols,
                                      const int* __restrict__ idx,
                                      float* __restrict__ out) {
  const size_t row = (size_t)blockIdx.x * cols;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    const int i = min(max(__ldg(idx + row + j), 0), n_rows - 1);
    out[row + j] = __ldg(t + (size_t)i * cols + j);
  }
}

// out[i, j] = 0 + sum_c (sum_k a[c*M + i, k] * b[k, j]), sums left to right
__global__ void dot_chunks_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b, int M, int K,
                                  int N, int chunks,
                                  float* __restrict__ out) {
  extern __shared__ float smem_b[];
  for (int k = threadIdx.x; k < K * N; k += blockDim.x) smem_b[k] = b[k];
  __syncthreads();
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= M * N) return;
  const int i = o / N, j = o % N;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const float* ar = a + (size_t)(c * M + i) * K;
    float s = ar[0] * smem_b[j];
    for (int k = 1; k < K; ++k) s = s + ar[k] * smem_b[k * N + j];
    acc = acc + s;
  }
  out[o] = acc;
}

// Copies 4 bytes from global to shared memory without a register
// (cp.async); cp_async_wait makes the thread's copies visible to it.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// out[c, j] = sum_n a[n, c] * (w[n, j] == hot), n left to right.  A block
// computes a kOhC x kOhJ tile of out: one warp a row c (a[n, c] a
// broadcast), its lanes the columns j.  It stages kOhN rows of w's and a's
// columns at a time in shared memory by cp.async, so every load of the
// chunk is in flight at once, then runs the chain of adds from there.
__global__ void __launch_bounds__(kOhC * kOhJ)
onehot_dot_kernel(const int* __restrict__ w, const float* __restrict__ a,
                  int np, int nc, int r, int hot, float* __restrict__ out) {
  __shared__ int sw[kOhN * kOhJ];
  __shared__ float sa[kOhN * kOhC];
  const int c0 = blockIdx.x * kOhC, j0 = blockIdx.y * kOhJ;
  const int ci = threadIdx.x / kOhJ, ji = threadIdx.x % kOhJ;
  const bool live = c0 + ci < nc && j0 + ji < r;
  float s = 0.0f;
  for (int n0 = 0; n0 < np; n0 += kOhN) {
    const int rows = min(kOhN, np - n0);
    for (int k = threadIdx.x; k < rows * kOhJ; k += blockDim.x) {
      const int jj = k % kOhJ;
      if (j0 + jj < r)
        cp_async4(sw + k, w + (size_t)(n0 + k / kOhJ) * r + j0 + jj);
    }
    for (int k = threadIdx.x; k < rows * kOhC; k += blockDim.x) {
      const int cc = k % kOhC;
      if (c0 + cc < nc)
        cp_async4(sa + k, a + (size_t)(n0 + k / kOhC) * nc + c0 + cc);
    }
    cp_async_wait();
    __syncthreads();
    if (live) {
      int n = 0;
      if (n0 == 0) {
        s = sa[ci] * (sw[ji] == hot ? 1.0f : 0.0f);
        n = 1;
      }
#pragma unroll 8
      for (; n < rows; ++n) {
        s = s + sa[n * kOhC + ci] * (sw[n * kOhJ + ji] == hot ? 1.0f : 0.0f);
      }
    }
    __syncthreads();
  }
  if (live) out[(size_t)(c0 + ci) * r + j0 + ji] = s;
}

// out[r, j] = 0 + sum_k t[r, (idx[r, j] + k) & mask], k = 0 .. rep-1
__global__ void gather_timing_kernel(const float* __restrict__ t, int width,
                                     const int* __restrict__ idx, int m,
                                     int rep, int mask,
                                     float* __restrict__ out) {
  extern __shared__ float smem_row[];
  const int r = blockIdx.x;
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    smem_row[k] = t[r * width + k];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int i0 = idx[r * m + j];
    float acc = 0.0f;
    for (int k = 0; k < rep; ++k) acc = acc + smem_row[(i0 + k) & mask];
    out[r * m + j] = acc;
  }
}

__global__ void trig_kernel(const float* __restrict__ x, int n,
                            float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float v = x[k];
  const float c = v != v ? v : fminf(fmaxf(v, -1.0f), 1.0f);  // NaN stays
  out[k] = acosf(c) + atan2f(v, 1.0f - v);
}

// Launches a kernel that needs `smem` bytes of dynamic shared memory,
// opting in above 48 KB.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > kStaticSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n] f32, n <= 1024 -> out [n]
extern "C" int while_vector_cond_launch(const void* x, int n, void* out,
                                        void* stream) {
  if (n < 1 || n > kMaxThreads) return (int)cudaErrorInvalidValue;
  return launch(while_vector_cond_kernel, 1, ceil_div(n, 32) * 32, 0,
                (cudaStream_t)stream, (const float*)x, n, (float*)out);
}

// t [rows, width >= 128] f32, idx [rows, 128] i32 -> out [rows, 128]
extern "C" int gather_lane_launch(const void* t, int rows, int width,
                                  const void* idx, void* out, void* stream) {
  if (rows < 1 || width < 128) return (int)cudaErrorInvalidValue;
  return launch(gather_lane_kernel, rows, 128, 0, (cudaStream_t)stream,
                (const float*)t, width, (const int*)idx, (float*)out);
}

// t [rows, width] 32-bit words, idx [rows, m] i32 -> out [rows, m]
extern "C" int gather_rows_launch(const void* t, int rows, int width,
                                  const void* idx, int m, void* out,
                                  void* stream) {
  if (rows < 1 || width < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const int threads = m < kMaxThreads ? ceil_div(m, 32) * 32 : kMaxThreads;
  const size_t row_bytes = (size_t)width * sizeof(unsigned);
  if (row_bytes <= kStaticSmem) {
    return launch(gather_rows_kernel<true>, rows, threads, row_bytes,
                  (cudaStream_t)stream, (const unsigned*)t, width,
                  (const int*)idx, m, (unsigned*)out);
  }
  return launch(gather_rows_kernel<false>, rows, threads, 0,
                (cudaStream_t)stream, (const unsigned*)t, width,
                (const int*)idx, m, (unsigned*)out);
}

// t [n_rows, cols] f32, idx [rows, cols] i32 -> out [rows, cols]
extern "C" int gather_sublane_launch(const void* t, int n_rows, int cols,
                                     const void* idx, int rows, void* out,
                                     void* stream) {
  if (n_rows < 1 || cols < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const int threads = cols < kMaxThreads ? ceil_div(cols, 32) * 32
                                         : kMaxThreads;
  return launch(gather_sublane_kernel, rows, threads, 0,
                (cudaStream_t)stream, (const float*)t, n_rows, cols,
                (const int*)idx, (float*)out);
}

// a [chunks * M, K], b [K, N] f32 -> out [M, N]
extern "C" int dot_chunks_launch(const void* a, const void* b, int M, int K,
                                 int N, int chunks, void* out,
                                 void* stream) {
  if (M < 1 || K < 1 || N < 1 || chunks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(dot_chunks_kernel, ceil_div(M * N, kMaxThreads), kMaxThreads,
                (size_t)K * N * sizeof(float), (cudaStream_t)stream,
                (const float*)a, (const float*)b, M, K, N, chunks,
                (float*)out);
}

// w [np, r] i32, a [np, nc] f32 -> out [nc, r]
extern "C" int onehot_dot_launch(const void* w, const void* a, int np,
                                 int nc, int r, int hot, void* out,
                                 void* stream) {
  if (np < 1 || nc < 1 || r < 1) return (int)cudaErrorInvalidValue;
  return launch(onehot_dot_kernel, dim3(ceil_div(nc, kOhC), ceil_div(r, kOhJ)),
                kOhC * kOhJ, 0, (cudaStream_t)stream, (const int*)w,
                (const float*)a, np, nc, r, hot, (float*)out);
}

// t [rows, width] f32, idx [rows, m] i32 -> out [rows, m]; indices are
// masked with `mask` (width - 1 for a power-of-two width)
extern "C" int gather_timing_launch(const void* t, int rows, int width,
                                    const void* idx, int m, int rep,
                                    int mask, void* out, void* stream) {
  if (rows < 1 || width < 1 || m < 1 || rep < 0 || mask < 0 ||
      mask >= width) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = m < kMaxThreads ? ceil_div(m, 32) * 32 : kMaxThreads;
  return launch(gather_timing_kernel, rows, threads,
                (size_t)width * sizeof(float), (cudaStream_t)stream,
                (const float*)t, width, (const int*)idx, m, rep, mask,
                (float*)out);
}

// x [n] f32 -> out [n]
extern "C" int trig_launch(const void* x, int n, void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  return launch(trig_kernel, ceil_div(n, 256), 256, 0, (cudaStream_t)stream,
                (const float*)x, n, (float*)out);
}
