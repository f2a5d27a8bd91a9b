// P1: the dense sphere-pair section of the render kernel as a Hopper
// (sm_90a) micro-benchmark.
//
// Replaces the Pallas probe tools/probe_pair.py::make_probe (pallas_call
// at :316).  For each of SUB x 128 ray lanes, REP times: the pair key of
// every one of C primitives (the smaller root above akey, BIG = 1e30 for
// none), their minimum and its first index, mn + idx * 1e-9, summed over
// REP.  The ray's dx moves by it * 1e-20 each iteration (anti-hoist) and
// the sum is carried (anti-dead-code), as in the probe.
//
// One thread per (sub-row, lane); each thread walks all C primitives in
// order and reads the [2C, 16] coefficient table from global memory with
// the whole warp on one address -- K1's sphere-loop pattern
// (mega2_bounce.cuh), which this probe times.  FP32 operations bound it
// (the `full` variant: ~79 a pair); the loop moves no device-memory bytes
// beyond the L1-resident table.  The probe's TPU shape, [SUB, 128] with
// SUB = 8, is one block of 1024 threads: one SM of the card's 132.
// `copies` repeats the same block over blockIdx.y, each copy writing its
// own output, so a launch can fill the card.
//
// Variants (kernel ids below).  The coefficient dots are 16-term (k8dot:
// 8-term) sums on CUDA cores in f32, left to right; bf16dot rounds both
// inputs to bf16 (round to nearest even) and sums the exact products in
// f32, which is what the MXU did to them.  The probe's variants that differ
// only in TPU scheduling (dotsfirst, fuseddot, the tree reductions,
// wide8_dotsonly) compute the same values as one of these and launch it;
// tools/probe_pair.py holds the map.  noreduce and dotsonly return
// primitive 0's value only, so the compiler may drop the other C - 1
// primitives of their loop; chip_smoke.py times them against C to say.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kR = 128;          // lanes of a sub-row
constexpr int kCols = 16;        // coefficient columns
constexpr int kMaxThreads = 1024;
constexpr float kBig = 1.0e30f;

enum Variant : int {
  kFull = 0,
  kBf16Dot,
  kNoDots,
  kNoSqrt,
  kNoSelect,
  kNoIdx,
  kNoReduce,
  kDotsOnly,
  kK8Dot,
  kDirect,
  kVariants
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// c[0] * f[0] + c[1] * f[1] + ... + c[N-1] * f[N-1], left to right.
template <int N, bool kBf16>
__device__ __forceinline__ float dot(const float* __restrict__ c,
                                     const float (&f)[N]) {
  float s = (kBf16 ? bf16_round(__ldg(c)) : __ldg(c)) * f[0];
#pragma unroll
  for (int k = 1; k < N; ++k) {
    s = s + (kBf16 ? bf16_round(__ldg(c + k)) : __ldg(c + k)) * f[k];
  }
  return s;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
probe_pair_kernel(const float* __restrict__ coef,
                  const float* __restrict__ ray, int n_prim, int sub,
                  int rep, float* __restrict__ out) {
  const int lanes = sub * kR;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  // ray rows: feature k of sub-row s at row k * sub + s
  const float* rr = ray + t;
  const float dx0 = rr[0], dy = rr[lanes], dz = rr[2 * lanes];
  const float opx = rr[3 * lanes], opy = rr[4 * lanes], opz = rr[5 * lanes];
  const float tmv = rr[6 * lanes], a = rr[7 * lanes], akey = rr[10 * lanes];
  const float oo = opx * opx + opy * opy + opz * opz;
  const float* c_rows = coef + n_prim * kCols;  // rows C .. 2C-1

  float acc = 0.0f;
  for (int it = 0; it < rep; ++it) {
    const float dx = dx0 + (float)it * 1e-20f;
    const float od = opx * dx + opy * dy + opz * dz;
    float f[kCols] = {dx,        dy,        dz,        tmv * dx,
                      tmv * dy,  tmv * dz,  opx,       opy,
                      opz,       tmv * opx, tmv * opy, tmv * opz,
                      1.0f,      tmv,       tmv * tmv, 0.0f};
    if (V == kBf16Dot) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) f[k] = bf16_round(f[k]);
    }
    const float f8[8] = {dx, dy, dz, opx, opy, opz, 1.0f, 0.0f};

    float mn = INFINITY, row = 0.0f;
    int idx = n_prim;
    bool nan = false;
    for (int c = 0; c < n_prim; ++c) {
      const float* pb = coef + c * kCols;
      const float* pc = c_rows + c * kCols;
      float b, cc;
      if (V == kDirect) {
        // the exact quadratic: centre (cols 0-2) and radius (col 3)
        const float ocx = opx - __ldg(pb), ocy = opy - __ldg(pb + 1),
                    ocz = opz - __ldg(pb + 2), rad = __ldg(pb + 3);
        b = ocx * dx + ocy * dy + ocz * dz;
        cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
      } else if (V == kNoDots) {
        b = __ldg(pb) + od;
        cc = __ldg(pc) + oo;
      } else if (V == kK8Dot) {
        b = dot<8, false>(pb, f8) + od;
        cc = dot<8, false>(pc, f8) + oo;
      } else {
        b = dot<kCols, V == kBf16Dot>(pb, f) + od;
        cc = dot<kCols, V == kBf16Dot>(pc, f) + oo;
      }
      if (V == kDotsOnly) {
        if (c == 0) row = b + cc;
        continue;
      }
      const float disc = b * b - a * cc;
      const float sq = (V == kNoSqrt) ? disc * 0.5f : sqrtf(disc);
      const float k1 = -b - sq;
      const float k2 = -b + sq;
      float key;
      if (V == kNoSelect) {
        key = k1 + k2;                 // NaN where disc < 0
        nan = nan || key != key;
      } else {
        key = (k1 > akey) ? k1 : k2;
        key = (disc > 0.0f && key > akey) ? key : kBig;
      }
      if (V == kNoReduce) {
        if (c == 0) row = key;
        continue;
      }
      if (key < mn) {                  // strict: the first index wins ties
        mn = key;
        idx = c;
      }
    }
    if (V != kNoReduce && V != kDotsOnly) {
      // the probe's min propagates NaN, and no index then equals it
      if (nan) {
        mn = __int_as_float(0x7fc00000);
        idx = n_prim;
      }
      row = (V == kNoIdx) ? mn : mn + (float)idx * 1e-9f;
    }
    acc = acc + row;
  }
  out[blockIdx.y * lanes + t] = acc;
}

const void* const kKernels[kVariants] = {
    (const void*)probe_pair_kernel<kFull>,
    (const void*)probe_pair_kernel<kBf16Dot>,
    (const void*)probe_pair_kernel<kNoDots>,
    (const void*)probe_pair_kernel<kNoSqrt>,
    (const void*)probe_pair_kernel<kNoSelect>,
    (const void*)probe_pair_kernel<kNoIdx>,
    (const void*)probe_pair_kernel<kNoReduce>,
    (const void*)probe_pair_kernel<kDotsOnly>,
    (const void*)probe_pair_kernel<kK8Dot>,
    (const void*)probe_pair_kernel<kDirect>,
};

int block_threads(int sub) {
  const int lanes = sub * kR;
  return lanes < kMaxThreads ? lanes : kMaxThreads;
}

}  // namespace

// Launches kernel `variant` (0-9, the Variant ids) on `stream`: coef
// [2 * n_prim, 16] f32, ray [11 * sub, 128] f32, writing out
// [copies, sub, 128] f32 (every copy the same values).  Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a bad variant
// or size.
extern "C" int probe_pair_launch(int variant, const void* coef,
                                 const void* ray, int n_prim, int sub,
                                 int rep, int copies, void* out,
                                 void* stream) {
  if (variant < 0 || variant >= kVariants || n_prim < 1 || sub < 1 ||
      copies < 1 || copies > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = block_threads(sub);
  const dim3 grid((sub * kR + threads - 1) / threads, copies);
  void* args[] = {&coef, &ray, &n_prim, &sub, &rep, &out};
  cudaLaunchKernel(kKernels[variant], grid, dim3(threads), args, 0,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Resident blocks of kernel `variant` per SM at `sub`'s block size, for a
// launch that fills the card.  Returns the CUDA error code.
extern "C" int probe_pair_blocks_per_sm(int variant, int sub, int* blocks) {
  if (variant < 0 || variant >= kVariants || sub < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kKernels[variant], block_threads(sub), 0);
}
