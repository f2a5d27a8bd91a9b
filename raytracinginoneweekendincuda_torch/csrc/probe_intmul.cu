// P2: the cost of 32-bit integer multiplies against adds, xors, shifts and
// f32 multiplies, as a Hopper (sm_90a) micro-benchmark.
//
// Replaces the Pallas probe tools/probe_intmul.py::make (pallas_call at
// :53), which asked whether pcg4d's integer multiplies bound the render
// kernel.  One thread per element of the [8, 128] input; each runs `iters`
// iterations of an 8-op dependent chain on its element's bits
// (__float_as_uint in, __uint_as_float out, as pltpu.bitcast did):
//
//   f32mul     x = x * fm + fa                  (FMUL + FADD: --fmad=false)
//   i32mul     x = x * m + add                  (one IMAD)
//   u32mul     x = x * m + add                  (one IMAD)
//   u32addxor  x = (x + add) ^ (x >> 16)
//   u32mix     4 x {x = x * m + add; x = x ^ (x >> 16)}   (pcg4d's mix)
//
// i32mul and u32mul are one instruction on Hopper: the low 32 bits of a
// product do not depend on the sign, so both run in unsigned arithmetic
// (which wraps in C++, as int32 and uint32 do in XLA).  The multiplier and
// the addend are kernel arguments, not constants: with constants the
// compiler may fold the 8 multiply-adds of a linear recurrence into one,
// and the chain would time one operation for eight.  chip_smoke.py counts
// the IMADs of each loop in the SASS.  The TPU shape is one block of 1024
// threads (32 warps, enough to hide a chain's latency): one SM of 132;
// `copies` repeats the block over blockIdx.y to fill the card.  Integer
// (or FP32) issue bounds it; there is no memory traffic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

enum Flavour : int {
  kF32Mul = 0,
  kI32Mul,
  kU32Mul,
  kU32AddXor,
  kU32Mix,
  kFlavours
};

template <int F>
__global__ void __launch_bounds__(kMaxThreads)
probe_intmul_kernel(const float* __restrict__ x, int n, int iters, float fm,
                    float fa, unsigned m, unsigned add,
                    float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  if (F == kF32Mul) {
    float v = x[t];
#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v = v * fm + fa;
    }
    out[blockIdx.y * n + t] = v;
    return;
  }
  unsigned v = __float_as_uint(x[t]);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    if (F == kI32Mul || F == kU32Mul) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v = v * m + add;
    } else if (F == kU32AddXor) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v = (v + add) ^ (v >> 16);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v = v * m + add;
        v = v ^ (v >> 16);
      }
    }
  }
  out[blockIdx.y * n + t] = __uint_as_float(v);
}

const void* const kKernels[kFlavours] = {
    (const void*)probe_intmul_kernel<kF32Mul>,
    (const void*)probe_intmul_kernel<kI32Mul>,
    (const void*)probe_intmul_kernel<kU32Mul>,
    (const void*)probe_intmul_kernel<kU32AddXor>,
    (const void*)probe_intmul_kernel<kU32Mix>,
};

int block_threads(int n) { return n < kMaxThreads ? n : kMaxThreads; }

}  // namespace

// Launches flavour `flavour` (0-4, the Flavour ids) on `stream` over the n
// f32 words of `x`, writing out [copies, n] (every copy the same bits).
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for a
// bad flavour or size.
extern "C" int probe_intmul_launch(int flavour, const void* x, int n,
                                   int iters, float fm, float fa, unsigned m,
                                   unsigned add, int copies, void* out,
                                   void* stream) {
  if (flavour < 0 || flavour >= kFlavours || n < 1 || iters < 0 ||
      copies < 1 || copies > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = block_threads(n);
  const dim3 grid((n + threads - 1) / threads, copies);
  void* args[] = {&x, &n, &iters, &fm, &fa, &m, &add, &out};
  cudaLaunchKernel(kKernels[flavour], grid, dim3(threads), args, 0,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Resident blocks of flavour `flavour` per SM for n threads.
extern "C" int probe_intmul_blocks_per_sm(int flavour, int n, int* blocks) {
  if (flavour < 0 || flavour >= kFlavours || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kKernels[flavour], block_threads(n), 0);
}
