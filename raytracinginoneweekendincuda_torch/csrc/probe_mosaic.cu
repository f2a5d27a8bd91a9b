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
//   gather_sublane      take_along_axis on axis 0, the [256, 128] table
//                       (128 KB) staged in dynamic shared memory
//   dot_chunks          sum over chunks of [M, K] x [K, N] (the dynamic
//                       sublane slice + dot, and the f32 matmul): one thread
//                       an output, K terms left to right on CUDA cores, B in
//                       shared memory; no tensor cores, no library call
//   onehot_dot          a^T . (w == hot): the one-hot winner read, a in
//                       shared memory, w read from global memory
//   gather_timing       REP gathers from a [24, 256] table (the Perlin access
//                       shape) in shared memory, summed
//   trig                acos(clip(x, -1, 1)) + atan2(x, 1 - x)
//
// The gathers clamp an index outside the table to its edge (jnp's
// mode="clip"; the probes' indices are in range), so a launch needs no
// host-side check.  All are tiny; launch latency bounds them at the
// probes' shapes.  Each entry point returns the launch's
// cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kStaticSmem = 48 * 1024;  // shared memory without opt-in

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

// out[r, j] = t[clamp(idx[r, j], 0, n_rows - 1), j]; t [n_rows, cols]
// staged in shared memory
__global__ void gather_sublane_kernel(const float* __restrict__ t,
                                      int n_rows, int cols,
                                      const int* __restrict__ idx, int rows,
                                      float* __restrict__ out) {
  extern __shared__ float smem_tab[];
  for (int k = threadIdx.x; k < n_rows * cols; k += blockDim.x) {
    smem_tab[k] = t[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < rows * cols; k += blockDim.x) {
    out[k] = smem_tab[min(max(idx[k], 0), n_rows - 1) * cols + k % cols];
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

// out[c, j] = sum_n a[n, c] * (w[n, j] == hot), n left to right
__global__ void onehot_dot_kernel(const int* __restrict__ w,
                                  const float* __restrict__ a, int np,
                                  int nc, int r, int hot,
                                  float* __restrict__ out) {
  extern __shared__ float smem_a[];
  for (int k = threadIdx.x; k < np * nc; k += blockDim.x) smem_a[k] = a[k];
  __syncthreads();
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= nc * r) return;
  const int c = o / r, j = o % r;
  float s = smem_a[c] * (w[j] == hot ? 1.0f : 0.0f);
  for (int n = 1; n < np; ++n) {
    s = s + smem_a[n * nc + c] * (w[n * r + j] == hot ? 1.0f : 0.0f);
  }
  out[o] = s;
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

// t [n_rows, cols] f32 (at most 227 KB), idx [rows, cols] i32 ->
// out [rows, cols]
extern "C" int gather_sublane_launch(const void* t, int n_rows, int cols,
                                     const void* idx, int rows, void* out,
                                     void* stream) {
  if (n_rows < 1 || cols < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  return launch(gather_sublane_kernel, 1, kMaxThreads,
                (size_t)n_rows * cols * sizeof(float), (cudaStream_t)stream,
                (const float*)t, n_rows, cols, (const int*)idx, rows,
                (float*)out);
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
  return launch(onehot_dot_kernel, ceil_div(nc * r, kMaxThreads),
                kMaxThreads, (size_t)np * nc * sizeof(float),
                (cudaStream_t)stream, (const int*)w, (const float*)a, np, nc,
                r, hot, (float*)out);
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
