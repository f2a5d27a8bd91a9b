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
// primitives j, j + 1, ... (closest_geo_warp) reads one coalesced line.
// The pair tests read a primitive's fields through a row source: `TabCol`
// reads field r of primitive j from such a table in global memory, one
// scalar __ldg a field; `Staged` holds a primitive's fields as float4s
// that K6 has loaded from its block's shared-memory copy of the tables
// (field r at float r of the row).  Arithmetic follows the plain PyTorch
// versions (ops/pallas_hit.py, ops/mega.py) op for op, in the same
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

// Field r of primitive j of a row-major table [rows, ld] in global
// memory, through the read-only cache.
struct TabCol {
  const float* tab;
  int ld, j;
  __device__ __forceinline__ float operator[](int r) const {
    return __ldg(tab + r * ld + j);
  }
};

// A primitive's fields as kN float4s (field r at float r); with r known
// at compile time, operator[] picks a register.
template <int kN>
struct Staged {
  float4 v[kN];
  __device__ __forceinline__ float operator[](int r) const {
    const float4 q = v[r >> 2];
    return (r & 3) == 0 ? q.x : (r & 3) == 1 ? q.y : (r & 3) == 2 ? q.z : q.w;
  }
};

// t of a sphere (fields 0:3 c0, 3:6 dc, 6 t0, 7 inv_dt, 8 rad), or BIG.
// The caller has checked the sphere's active field.
template <class Row>
__device__ __forceinline__ float sphere_t(const GeoRay& r, const Row& s,
                                          float t_min) {
  const float frac = (r.tm - s[6]) * s[7];
  const float cx = s[0] + frac * s[3];
  const float cy = s[1] + frac * s[4];
  const float cz = s[2] + frac * s[5];
  const float ocx = r.ox - cx;
  const float ocy = r.oy - cy;
  const float ocz = r.oz - cz;
  const float b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float rad = s[8];
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

// t of a quad (fields 0:3 n_unit, 3 d_plane, 4:7 vxw, 7 q.vxw, 8:11 wxu,
// 11 q.wxu), or BIG.  The caller has checked the quad's active field.
template <class Row>
__device__ __forceinline__ float quad_t(const GeoRay& r, const Row& q,
                                        float t_min) {
  const float nx = q[0];
  const float ny = q[1];
  const float nz = q[2];
  const float denom = r.dx * nx + r.dy * ny + r.dz * nz;
  const bool den_ok = fabsf(denom) >= EPS8;
  const float t = (q[3] - (r.ox * nx + r.oy * ny + r.oz * nz))
                  / (den_ok ? denom : 1.0f);
  const float px = r.ox + t * r.dx;
  const float py = r.oy + t * r.dy;
  const float pz = r.oz + t * r.dz;
  const float alpha = px * q[4] + py * q[5] + pz * q[6] - q[7];
  const float beta = px * q[8] + py * q[9] + pz * q[10] - q[11];
  const bool ok = den_ok && t >= t_min && alpha >= 0.0f && alpha <= 1.0f
                  && beta >= 0.0f && beta <= 1.0f;
  return ok ? t : BIG;
}

// The rows of a whole table: operator()(j) gives primitive j's row
// source.  `TabRows` reads a row-major [rows, ld] table in global memory;
// `StagedRows<kN>` a table staged as kN float4s a primitive (K6's shared
// memory), loading primitive j's row in kN 16-byte reads.
struct TabRows {
  const float* tab;
  int ld;
  __device__ __forceinline__ TabCol operator()(int j) const {
    return {tab, ld, j};
  }
};

template <int kN>
struct StagedRows {
  const float4* rows;
  __device__ __forceinline__ Staged<kN> operator()(int j) const {
    Staged<kN> s;
#pragma unroll
    for (int i = 0; i < kN; ++i) s.v[i] = rows[kN * j + i];
    return s;
  }
};

// Closest geometry over all spheres, then all quads.  A strictly smaller t
// replaces the winner, so the first index wins a tie -- the chunked
// first-index-of-min of the TPU kernels.  win: sphere lane j, or s_pad + q
// for quad q, or -1 when nothing was hit (t = BIG).  Field s_active of a
// sphere's row (q_active of a quad's) is its explicit active mask.
template <class SphRows, class QuadRows>
__device__ __forceinline__ void closest_geo(const GeoRay& r,
                                            const SphRows& sph, int s_pad,
                                            int s_active,
                                            const QuadRows& quad, int q_pad,
                                            int q_active, float t_min,
                                            float& t_best, int& win) {
  t_best = BIG;
  win = -1;
  for (int j = 0; j < s_pad; ++j) {
    const auto s = sph(j);
    if (!(s[s_active] > 0.5f)) continue;
    const float t = sphere_t(r, s, t_min);
    if (t < t_best) {
      t_best = t;
      win = j;
    }
  }
  for (int q = 0; q < q_pad; ++q) {
    const auto row = quad(q);
    if (!(row[q_active] > 0.5f)) continue;
    const float t = quad_t(r, row, t_min);
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
    const float t = sphere_t(r, TabCol{sph, s_pad, j}, t_min);
    if (t < t_best) {
      t_best = t;
      win = j;
    }
  }
  for (int q = lane; q < q_pad; q += 32) {
    if (!(__ldg(quad + q_active_row * q_pad + q) > 0.5f)) continue;
    const float t = quad_t(r, TabCol{quad, q_pad, q}, t_min);
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
