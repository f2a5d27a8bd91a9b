// Sphere and quad pair tests of the XLA engine family, per thread.
//
// The formulas of raytracinginoneweekendincuda_tpu/ops/pallas_hit.py:118-154
// (kernel K6) and ops/mega.py:242-294 (kernel K5), which are the same:
// moving-sphere centre, half-b quadratic with inv_a = 1/a, the nearest root
// beyond t_min (strict), and the quad's plane hit with its (alpha, beta)
// interior test (t >= t_min inclusive).  This is the t-space test of those
// kernels, not mega2_bounce.cuh's key-space (t*a) test.
//
// Tables are row-major [rows, ld]: row r of primitive j is tab[r * ld + j],
// so the 32 threads of a warp, walking the primitives in the same order,
// read one address at a time (a broadcast), and a warp whose lanes take
// primitives j, j + 1, ... (closest_geo_warp) reads one coalesced line.  Arithmetic follows the plain
// PyTorch versions (ops/pallas_hit.py, ops/mega.py) op for op, in the same
// association order, compiled with --fmad=false.

#pragma once

#include <stdint.h>

namespace xla {

constexpr float BIG = 0x1.93e594p+99f;        // 1e30
constexpr float HALF_BIG = 0x1.93e594p+98f;   // 5e29
constexpr float EPS8 = 0x1.5798eep-27f;       // 1e-8, Quad.h:59
constexpr float EPS4 = 0x1.a36e2ep-14f;       // 1e-4, ConstantMedium.h:63
constexpr float INV24 = 0x1p-24f;

struct GeoRay {
  float ox, oy, oz, dx, dy, dz, tm, a;  // a = |d|^2
};

__device__ __forceinline__ GeoRay geo_ray(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float tm) {
  GeoRay r{ox, oy, oz, dx, dy, dz, tm, 0.0f};
  r.a = dx * dx + dy * dy + dz * dz;
  return r;
}

// t of sphere j (rows 0:3 c0, 3:6 dc, 6 t0, 7 inv_dt, 8 rad), or BIG.  The
// caller has checked the sphere's active row.
__device__ __forceinline__ float sphere_t(const GeoRay& r,
                                          const float* __restrict__ tab,
                                          int ld, int j, float t_min) {
  const float frac = (r.tm - __ldg(tab + 6 * ld + j)) * __ldg(tab + 7 * ld + j);
  const float cx = __ldg(tab + 0 * ld + j) + frac * __ldg(tab + 3 * ld + j);
  const float cy = __ldg(tab + 1 * ld + j) + frac * __ldg(tab + 4 * ld + j);
  const float cz = __ldg(tab + 2 * ld + j) + frac * __ldg(tab + 5 * ld + j);
  const float ocx = r.ox - cx;
  const float ocy = r.oy - cy;
  const float ocz = r.oz - cz;
  const float b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float rad = __ldg(tab + 8 * ld + j);
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = b * b - r.a * cc;
  if (!(disc > 0.0f)) return BIG;
  const float sq = sqrtf(disc);
  const float inv_a = 1.0f / r.a;
  const float r1 = (-b - sq) * inv_a;
  const float r2 = (-b + sq) * inv_a;
  const float t = r1 > t_min ? r1 : r2;
  return t > t_min ? t : BIG;
}

// t of quad j (rows 0:3 n_unit, 3 d_plane, 4:7 vxw, 7 q.vxw, 8:11 wxu,
// 11 q.wxu), or BIG.  The caller has checked the quad's active row.
__device__ __forceinline__ float quad_t(const GeoRay& r,
                                        const float* __restrict__ tab,
                                        int ld, int j, float t_min) {
  const float nx = __ldg(tab + 0 * ld + j);
  const float ny = __ldg(tab + 1 * ld + j);
  const float nz = __ldg(tab + 2 * ld + j);
  const float denom = r.dx * nx + r.dy * ny + r.dz * nz;
  const bool den_ok = fabsf(denom) >= EPS8;
  const float t = (__ldg(tab + 3 * ld + j) - (r.ox * nx + r.oy * ny + r.oz * nz))
                  / (den_ok ? denom : 1.0f);
  const float px = r.ox + t * r.dx;
  const float py = r.oy + t * r.dy;
  const float pz = r.oz + t * r.dz;
  const float alpha = px * __ldg(tab + 4 * ld + j) + py * __ldg(tab + 5 * ld + j)
                      + pz * __ldg(tab + 6 * ld + j) - __ldg(tab + 7 * ld + j);
  const float beta = px * __ldg(tab + 8 * ld + j) + py * __ldg(tab + 9 * ld + j)
                     + pz * __ldg(tab + 10 * ld + j) - __ldg(tab + 11 * ld + j);
  const bool ok = den_ok && t >= t_min && alpha >= 0.0f && alpha <= 1.0f
                  && beta >= 0.0f && beta <= 1.0f;
  return ok ? t : BIG;
}

// Closest geometry over all spheres, then all quads.  A strictly smaller t
// replaces the winner, so the first index wins a tie -- the chunked
// first-index-of-min of the TPU kernels.  win: sphere lane j, or s_pad + q
// for quad q, or -1 when nothing was hit (t = BIG).
__device__ __forceinline__ void closest_geo(const GeoRay& r,
                                            const float* __restrict__ sph,
                                            int s_pad, int s_active_row,
                                            const float* __restrict__ quad,
                                            int q_pad, int q_active_row,
                                            float t_min, float& t_best,
                                            int& win) {
  t_best = BIG;
  win = -1;
  for (int j = 0; j < s_pad; ++j) {
    if (!(__ldg(sph + s_active_row * s_pad + j) > 0.5f)) continue;
    const float t = sphere_t(r, sph, s_pad, j, t_min);
    if (t < t_best) {
      t_best = t;
      win = j;
    }
  }
  for (int q = 0; q < q_pad; ++q) {
    if (!(__ldg(quad + q_active_row * q_pad + q) > 0.5f)) continue;
    const float t = quad_t(r, quad, q_pad, q, t_min);
    if (t < t_best) {
      t_best = t;
      win = s_pad + q;
    }
  }
}

// closest_geo shared by the 32 lanes of a warp: lane l tests spheres l,
// l + 32, ... and then quads l, l + 32, ..., keeping its own first minimum
// (strict <), and a butterfly over the warp takes the smallest (t, win),
// the lower win on equal t.  win orders spheres before quads and rows
// upwards, and t < BIG only where win >= 0, so every lane ends with the
// serial loop's (t_best, win).  All 32 lanes must call it.
__device__ __forceinline__ void closest_geo_warp(
    const GeoRay& r, const float* __restrict__ sph, int s_pad,
    int s_active_row, const float* __restrict__ quad, int q_pad,
    int q_active_row, float t_min, int lane, float& t_best, int& win) {
  t_best = BIG;
  win = -1;
  for (int j = lane; j < s_pad; j += 32) {
    if (!(__ldg(sph + s_active_row * s_pad + j) > 0.5f)) continue;
    const float t = sphere_t(r, sph, s_pad, j, t_min);
    if (t < t_best) {
      t_best = t;
      win = j;
    }
  }
  for (int q = lane; q < q_pad; q += 32) {
    if (!(__ldg(quad + q_active_row * q_pad + q) > 0.5f)) continue;
    const float t = quad_t(r, quad, q_pad, q, t_min);
    if (t < t_best) {
      t_best = t;
      win = s_pad + q;
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float t_o = __shfl_xor_sync(0xffffffffu, t_best, m);
    const int w_o = __shfl_xor_sync(0xffffffffu, win, m);
    if (t_o < t_best || (t_o == t_best && (unsigned)w_o < (unsigned)win)) {
      t_best = t_o;
      win = w_o;
    }
  }
}

}  // namespace xla
