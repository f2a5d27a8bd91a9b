// K5: the K-bounce ray-pool kernel of the mega engine, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// raytracinginoneweekendincuda_tpu/ops/mega.py::_make_kernel.  One thread
// per ray of the pool advances it up to K bounces: closest hit over every
// active sphere and quad (xla_pair.cuh, shared with K6), the winner's
// attribute row, constant media with their MEDIUM_STREAM draw, miss ->
// background, the solid / checker texture, emission, the five materials'
// scatter on SCATTER_STREAM, and the throughput / liveness update.  The ray
// state stays in registers for the K bounces; a lane that is not active is
// left as it is (a bounce changes nothing on such a lane).
//
// What the TPU design did and what this does instead:
// - the winner's attributes were a one-hot MXU contraction; here they are an
//   indexed load of one attr row, and a miss (win == -1) reads zeros, the
//   row the one-hot produced;
// - the media rows were compile-time constants; here they are a runtime
//   table [n_media, 22] (col 15 holds radius^2, squared in f64 on the host
//   as the Pallas kernel squares its python-float radius), so a scene
//   needs no rebuild.
// FP32 ALU work in the pair loop bounds it; tables stay in L2 and are read
// through the read-only cache.
//
// Arithmetic follows mega_bounces_plain (ops/mega.py) op for op, in the same
// association order, compiled with --fmad=false.  The Pallas kernel's
// `x ** 0.5` is sqrtf here and a correctly rounded sqrt there; lax.rsqrt(a)
// is 1.0f / sqrtf(a) in both (the card's rsqrtf is approximate);
// `u3 ** (1/3)` is powf in both.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see utils/cuda_build.py).

#include <cuda_runtime.h>

#include "xla_pair.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kSphActive = 11;   // pack_mega_tables' sphere active row
constexpr int kQuadActive = 12;
constexpr int kAttrCols = 21;
constexpr int kMedCols = 22;
constexpr int kMedBox = 1;

constexpr uint32_t SCATTER_STREAM = 0x5CA70000u;
constexpr uint32_t MEDIUM_STREAM = 0x3ED00000u;
constexpr float TWO_PI = 0x1.921fb6p+2f;
constexpr float ONE_THIRD = 0x1.555556p-2f;
constexpr float MAT_LAMBERTIAN = 0.0f;
constexpr float MAT_METAL = 1.0f;
constexpr float MAT_DIELECTRIC = 2.0f;
constexpr float MAT_DIFFUSE_LIGHT = 3.0f;
constexpr float MAT_ISOTROPIC = 4.0f;
constexpr float TEX_CHECKER = 1.0f;

}  // namespace

// Everything one launch reads besides the ray state.  Mirrored field for
// field by the ctypes Structure in ops/mega.py.
struct MegaParams {
  const float* sph;    // [24, s_pad]
  const float* quad;   // [24, q_pad]
  const float* attr;   // [s_pad + q_pad, 21]
  const float* med;    // [max(n_media, 1), 22]
  float bg[3];
  float t_min;
  int s_pad, q_pad, n_media, k_bounces, max_bounces;
};

namespace {

// NaN-propagating min / max, as torch.minimum / torch.maximum.
__device__ __forceinline__ float fmin_p(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float fmax_p(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ void pcg4d(uint32_t& v0, uint32_t& v1,
                                      uint32_t& v2, uint32_t& v3) {
  v0 = v0 * 1664525u + 1013904223u;
  v1 = v1 * 1664525u + 1013904223u;
  v2 = v2 * 1664525u + 1013904223u;
  v3 = v3 * 1664525u + 1013904223u;
  v0 = v0 + v1 * v3;
  v1 = v1 + v2 * v0;
  v2 = v2 + v0 * v1;
  v3 = v3 + v1 * v2;
  v0 = v0 ^ (v0 >> 16);
  v1 = v1 ^ (v1 >> 16);
  v2 = v2 ^ (v2 >> 16);
  v3 = v3 ^ (v3 >> 16);
  v0 = v0 + v1 * v3;
  v1 = v1 + v2 * v0;
  v2 = v2 + v0 * v1;
  v3 = v3 + v1 * v2;
}

__device__ __forceinline__ float unit(uint32_t w) {
  return (float)(w >> 8) * xla::INV24;
}

// One medium (row md) against the ray: true and its scatter t when the
// sampled point lies inside the boundary.
__device__ __forceinline__ bool medium(const float* __restrict__ md,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz, float a,
                                       float t_min, float u_m, float& t_m) {
  float t0, t1;
  bool valid;
  if ((int)__ldg(md + 0) == kMedBox) {
    const float c2 = __ldg(md + 11), s2 = __ldg(md + 12);
    const float pox = ox - __ldg(md + 16);
    const float poy = oy - __ldg(md + 17);
    const float poz = oz - __ldg(md + 18);
    const float o1 = c2 * pox - s2 * poz;
    const float o2 = poy;
    const float o3 = s2 * pox + c2 * poz;
    const float e1 = c2 * dx - s2 * dz;
    const float e2 = dy;
    const float e3 = s2 * dx + c2 * dz;
    const float iv1 = 1.0f / e1, iv2 = 1.0f / e2, iv3 = 1.0f / e3;
    const float ta1 = (__ldg(md + 5) - o1) * iv1, tb1 = (__ldg(md + 8) - o1) * iv1;
    const float ta2 = (__ldg(md + 6) - o2) * iv2, tb2 = (__ldg(md + 9) - o2) * iv2;
    const float ta3 = (__ldg(md + 7) - o3) * iv3, tb3 = (__ldg(md + 10) - o3) * iv3;
    t0 = fmax_p(fmax_p(fmin_p(ta1, tb1), fmin_p(ta2, tb2)), fmin_p(ta3, tb3));
    t1 = fmin_p(fmin_p(fmax_p(ta1, tb1), fmax_p(ta2, tb2)), fmax_p(ta3, tb3));
    valid = t1 > t0;
  } else {
    const float ocx = ox - __ldg(md + 1);
    const float ocy = oy - __ldg(md + 2);
    const float ocz = oz - __ldg(md + 3);
    const float b = ocx * dx + ocy * dy + ocz * dz;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - __ldg(md + 15);
    const float disc = b * b - a * cc;
    const float sq = sqrtf(fmax_p(disc, 0.0f));
    t0 = (-b - sq) / a;
    t1 = (-b + sq) / a;
    valid = disc > 0.0f;
  }
  valid = valid && (t1 > t0 + xla::EPS4);
  const float t0c = fmax_p(fmax_p(t0, t_min), 0.0f);
  valid = valid && (t0c < t1);
  const float ray_len = sqrtf(a);
  const float dist_in = (t1 - t0c) * ray_len;
  const float hit_d = __ldg(md + 13) * logf(u_m);
  valid = valid && (hit_d <= dist_in);
  t_m = t0c + hit_d / ray_len;
  return valid;
}

__global__ void __launch_bounds__(kBlock)
mega_bounces_kernel(const MegaParams p, const float* __restrict__ rf,
                    const int* __restrict__ ri, int n,
                    float* __restrict__ rf_out, int* __restrict__ ri_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float* s = rf + 13 * k;
  float ox = s[0], oy = s[1], oz = s[2];
  float dx = s[3], dy = s[4], dz = s[5];
  const float tm = s[6];
  float thr[3] = {s[7], s[8], s[9]};
  float acc[3] = {s[10], s[11], s[12]};
  const uint32_t pix_ctr = (uint32_t)ri[4 * k + 0];
  const uint32_t samp = (uint32_t)ri[4 * k + 1];
  int bounce = ri[4 * k + 2];
  bool active = ri[4 * k + 3] > 0;

  for (int kb = 0; kb < p.k_bounces && active; ++kb) {
    const xla::GeoRay r = xla::geo_ray(ox, oy, oz, dx, dy, dz, tm);
    const float a = r.a;
    float t_best;
    int win;
    xla::closest_geo(r, p.sph, p.s_pad, kSphActive, p.quad, p.q_pad,
                     kQuadActive, p.t_min, t_best, win);

    // the winner's attribute row (zeros for a miss)
    float aw[kAttrCols];
#pragma unroll
    for (int c = 0; c < kAttrCols; ++c)
      aw[c] = win >= 0 ? __ldg(p.attr + win * kAttrCols + c) : 0.0f;
    const float frac_w = (tm - aw[6]) * aw[7];
    const float wcx = aw[0] + frac_w * aw[3];   // center(t) | n_unit
    const float wcy = aw[1] + frac_w * aw[4];
    const float wcz = aw[2] + frac_w * aw[5];
    const float wrad = aw[8];
    bool is_quad = aw[9] > 0.5f;
    float kind = aw[10];

    // ---- stochastic media (ConstantMedium.h)
    bool is_med = false;
    float alb[3] = {0.0f, 0.0f, 0.0f};
    for (int m = 0; m < p.n_media; ++m) {
      const float* md = p.med + m * kMedCols;
      uint32_t w0 = pix_ctr, w1 = samp, w2 = MEDIUM_STREAM | (uint32_t)bounce,
               w3 = (uint32_t)m;
      pcg4d(w0, w1, w2, w3);
      const float u_m = unit(w0) + xla::INV24;            // (0, 1]
      float t_m;
      const bool valid = medium(md, ox, oy, oz, dx, dy, dz, a, p.t_min, u_m,
                                t_m);
      if (valid && t_m < t_best) {
        t_best = t_m;
        is_med = true;
        is_quad = false;
        alb[0] = __ldg(md + 19);
        alb[1] = __ldg(md + 20);
        alb[2] = __ldg(md + 21);
        kind = MAT_ISOTROPIC;
      }
    }

    const bool hit = t_best < xla::HALF_BIG;
    // ---- miss -> background (kernel.cu:74-79)
    if (!hit) {
      acc[0] = acc[0] + thr[0] * p.bg[0];
      acc[1] = acc[1] + thr[1] * p.bg[1];
      acc[2] = acc[2] + thr[2] * p.bg[2];
      bounce = bounce + 1;
      active = false;
      break;
    }

    // ---- record
    const float px = ox + t_best * dx;
    const float py = oy + t_best * dy;
    const float pz = oz + t_best * dz;
    const float inv_rad = 1.0f / (wrad != 0.0f ? wrad : 1.0f);
    float n_out[3];
    n_out[0] = is_quad ? wcx : (px - wcx) * inv_rad;
    n_out[1] = is_quad ? wcy : (py - wcy) * inv_rad;
    n_out[2] = is_quad ? wcz : (pz - wcz) * inv_rad;
    if (is_med) {
      n_out[0] = 1.0f;
      n_out[1] = 0.0f;
      n_out[2] = 0.0f;
    }
    const float d_dot_n = dx * n_out[0] + dy * n_out[1] + dz * n_out[2];
    const bool front = (d_dot_n < 0.0f) || is_med;
    const float flip = front ? 1.0f : -1.0f;
    const float nx_ = n_out[0] * flip;
    const float ny_ = n_out[1] * flip;
    const float nz_ = n_out[2] * flip;

    // ---- texture value (solid | checker), media: albedo
    float tex[3] = {aw[14], aw[15], aw[16]};
    if (aw[13] == TEX_CHECKER) {
      const int cx = (int)floorf(aw[20] * px);
      const int cy = (int)floorf(aw[20] * py);
      const int cz = (int)floorf(aw[20] * pz);
      const bool even =
          (((uint32_t)cx + (uint32_t)cy + (uint32_t)cz) & 1u) == 0u;
      if (!even) {
        tex[0] = aw[17];
        tex[1] = aw[18];
        tex[2] = aw[19];
      }
    }
    if (is_med) {
      tex[0] = alb[0];
      tex[1] = alb[1];
      tex[2] = alb[2];
    }

    const float fuzz = aw[11];
    const float ior = aw[12];
    const bool is_light = kind == MAT_DIFFUSE_LIGHT;
    if (is_light) {   // emission (Material.h:114-117)
      acc[0] = acc[0] + thr[0] * tex[0];
      acc[1] = acc[1] + thr[1] * tex[1];
      acc[2] = acc[2] + thr[2] * tex[2];
    }

    // ---- scatter (SCATTER_STREAM | bounce)
    uint32_t w0 = pix_ctr, w1 = samp, w2 = SCATTER_STREAM | (uint32_t)bounce,
             w3 = 0u;
    pcg4d(w0, w1, w2, w3);
    const float u1 = unit(w0), u2 = unit(w1), u3 = unit(w2), u4 = unit(w3);
    const float zb = 1.0f - 2.0f * u1;
    const float rxy = sqrtf(fabsf(1.0f - zb * zb));
    const float phi_b = TWO_PI * u2;
    const float sb = sinf(phi_b);
    const float cb = cosf(phi_b);
    const float rad_b = powf(u3, ONE_THIRD);
    const float bx = rad_b * rxy * cb;
    const float by = rad_b * rxy * sb;
    const float bz = rad_b * zb;

    const float inv_dlen = 1.0f / sqrtf(a);
    const float udx = dx * inv_dlen, udy = dy * inv_dlen, udz = dz * inv_dlen;

    float ndx, ndy, ndz;
    bool scattered = true;
    if (kind == MAT_LAMBERTIAN) {
      ndx = nx_ + bx;
      ndy = ny_ + by;
      ndz = nz_ + bz;
      if (fabsf(ndx) < xla::EPS8 && fabsf(ndy) < xla::EPS8
          && fabsf(ndz) < xla::EPS8) {
        ndx = nx_;
        ndy = ny_;
        ndz = nz_;
      }
    } else if (kind == MAT_METAL || kind == MAT_DIELECTRIC) {
      const float ddn = udx * nx_ + udy * ny_ + udz * nz_;
      const float rx = udx - 2.0f * ddn * nx_;
      const float ry = udy - 2.0f * ddn * ny_;
      const float rz = udz - 2.0f * ddn * nz_;
      if (kind == MAT_METAL) {
        ndx = rx + fuzz * bx;
        ndy = ry + fuzz * by;
        ndz = rz + fuzz * bz;
        scattered = (ndx * nx_ + ndy * ny_ + ndz * nz_) > 0.0f;
      } else {
        const float ratio = front ? 1.0f / ior : ior;
        const float cos_t = fmin_p(-(udx * nx_ + udy * ny_ + udz * nz_), 1.0f);
        const float sin_t = sqrtf(fmax_p(1.0f - cos_t * cos_t, 0.0f));
        const bool cannot = ratio * sin_t > 1.0f;
        float r0 = (1.0f - ratio) / (1.0f + ratio);
        r0 = r0 * r0;
        const float one_m = 1.0f - cos_t;
        const float om2 = one_m * one_m;
        const float refl5 = r0 + (1.0f - r0) * om2 * om2 * one_m;
        if (cannot || refl5 > u4) {
          ndx = rx;
          ndy = ry;
          ndz = rz;
        } else {
          const float fx = ratio * (udx + cos_t * nx_);
          const float fy = ratio * (udy + cos_t * ny_);
          const float fz = ratio * (udz + cos_t * nz_);
          const float plen = fabsf(1.0f - (fx * fx + fy * fy + fz * fz));
          const float par = -sqrtf(plen);
          ndx = fx + par * nx_;
          ndy = fy + par * ny_;
          ndz = fz + par * nz_;
        }
      }
    } else if (kind == MAT_ISOTROPIC) {
      ndx = rxy * cb;
      ndy = rxy * sb;
      ndz = zb;
    } else {
      ndx = udx;
      ndy = udy;
      ndz = udz;
    }
    if (is_light) scattered = false;   // Material.h:120-128

    bounce = bounce + 1;
    if (!scattered) {
      active = false;
      break;
    }
    const float att[3] = {kind == MAT_DIELECTRIC ? 1.0f : tex[0],
                          kind == MAT_DIELECTRIC ? 1.0f : tex[1],
                          kind == MAT_DIELECTRIC ? 1.0f : tex[2]};
    thr[0] = thr[0] * att[0];
    thr[1] = thr[1] * att[1];
    thr[2] = thr[2] * att[2];
    ox = px;
    oy = py;
    oz = pz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
    active = bounce < p.max_bounces;
  }

  float* o = rf_out + 13 * k;
  o[0] = ox; o[1] = oy; o[2] = oz;
  o[3] = dx; o[4] = dy; o[5] = dz;
  o[6] = tm;
  o[7] = thr[0]; o[8] = thr[1]; o[9] = thr[2];
  o[10] = acc[0]; o[11] = acc[1]; o[12] = acc[2];
  ri_out[4 * k + 0] = (int)pix_ctr;
  ri_out[4 * k + 1] = (int)samp;
  ri_out[4 * k + 2] = bounce;
  ri_out[4 * k + 3] = active ? 1 : 0;
}

}  // namespace

// Launches K5 on `stream` for the n rays of rf [n, 13] f32 and ri [n, 4]
// i32, writing the advanced state to rf_out / ri_out.  Returns the
// launch's cudaGetLastError().
extern "C" int mega_bounces_launch(const MegaParams* params, const void* rf,
                                   const void* ri, int n, void* rf_out,
                                   void* ri_out, void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    mega_bounces_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        *params, (const float*)rf, (const int*)ri, n, (float*)rf_out,
        (int*)ri_out);
  }
  return (int)cudaGetLastError();
}

// sizeof(MegaParams), so the host can check its mirror of the struct.
extern "C" int mega_params_size() { return (int)sizeof(MegaParams); }
