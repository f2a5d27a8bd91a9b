// One replayed bounce and its adjoint, per thread.
//
// Port of the pure bounce function `_make_bounce` of
// raytracinginoneweekendincuda_tpu/ops/pallas_replay.py, which the replay
// forward (K3, replay_fwd.cu) runs and the replay backward (K4,
// replay_bwd.cu) differentiates.  On the TPU the backward applied a
// trace-time jax.vjp of that function; here every forward stage has its
// hand-written adjoint beside it:
//
//   winner row read          row = rep + idx * REP_COLS  | atomicAdd (K4)
//   sphere re-intersection   sphere_fwd, sphere_t        | sphere_bwd
//   quad re-intersection     quad_fwd                    | quad_bwd
//   medium t                 medium_fwd                  | medium_bwd
//   hit point, normal        record_fwd                  | in bounce_bwd
//   checker                  texture_fwd (no derivative  | texture_bwd
//                            in the hit point)
//   Perlin marble            texture_fwd, turb_grad      | texture_bwd
//   image texel              image_fwd (integer index)   | none
//   miss / emission          emit_fwd                    | in bounce_bwd
//   scatter, five materials  scatter_fwd                 | scatter_bwd,
//                                                          unit_dir_bwd
//
// The forward follows ops/replay.py::_replay_bounce op for op, in the same
// association order, and is compiled with --fmad=false: PyTorch's
// elementwise ops never contract a*b+c, so neither may this.  The adjoints
// give what torch autograd gives through that function: zero through the
// masked side of every select, half the cotangent to each side of a
// minimum / maximum tie, and every guarded root or division
// differentiated only where its guard passes, so no 0 * inf appears.
// Square-root adjoints run in double, as autograd does through
// `sqrt_f32` (sqrt of the f64 value, rounded).

#pragma once

#include <stdint.h>

#include "mega2_bounce.cuh"

namespace replay {

constexpr int REP_COLS = 27;
constexpr int MED_COLS = 17;    // ops/replay.py MED_COLS
constexpr int KMAX = 16;        // deepest replay the backward keeps states of

// Everything a replay launch reads besides the per-lane inputs.  Mirrored
// field for field by the ctypes Structure in ops/replay_cuda.py.
struct Params {
  const float* rep;       // [np_rows, 27] merged replay table
  const float* med;       // [max(n_media,1), 17] medium boundaries
  const int* perm;        // [8 * n_noise, 256]
  const float* vec;       // [24 * n_noise, 256]
  const int* texels;      // [rows, tex_cols] packed (r<<16)|(g<<8)|b
  const int* img_dims;    // [n_images, 3]: iw, ih, texel row offset
  const float* bg;        // [3] background (device)
  float t_min;
  int np_rows, S, med_base, n_media;
  int n_noise, n_images, tex_cols;
  int has_checker, has_noise, has_image;
  int K, n;
  uint32_t samp;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// d/dx of sqrt_f32(x) for cotangent g (autograd through the f64 root).
__device__ __forceinline__ float sqrt_bwd(float g, float x) {
  return (float)((double)g / (2.0 * sqrt((double)x)));
}

// Cotangent share of `a` in min(a, b) (torch.minimum: half on ties).
__device__ __forceinline__ float min_share(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// ---- Perlin turbulence: value (bit-identical to the forward's) and its
// gradient in the hit point ---------------------------------------------

__device__ __forceinline__ float noise_grad(const Params& p, int table,
                                            float qx, float qy, float qz,
                                            float g[3]) {
  const int* px = p.perm + (8 * table + 0) * 256;
  const int* py = p.perm + (8 * table + 2) * 256;
  const int* pz = p.perm + (8 * table + 4) * 256;
  const float* vx = p.vec + (24 * table + 0) * 256;
  const float* vy = p.vec + (24 * table + 8) * 256;
  const float* vz = p.vec + (24 * table + 16) * 256;
  float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
  float ux = qx - fx, uy = qy - fy, uz = qz - fz;
  int i = (int)fx, j = (int)fy, k = (int)fz;
  float sx = ux * ux * (3.0f - 2.0f * ux);
  float sy = uy * uy * (3.0f - 2.0f * uy);
  float sz = uz * uz * (3.0f - 2.0f * uz);
  // d(s)/du of s = u*u*(3 - 2u), as autograd forms it
  float dsx = (ux + ux) * (3.0f - 2.0f * ux) - 2.0f * (ux * ux);
  float dsy = (uy + uy) * (3.0f - 2.0f * uy) - 2.0f * (uy * uy);
  float dsz = (uz + uz) * (3.0f - 2.0f * uz) - 2.0f * (uz * uz);
  int pa[2] = {px[i & 255], px[(i + 1) & 255]};
  int pb[2] = {py[j & 255], py[(j + 1) & 255]};
  int pc[2] = {pz[k & 255], pz[(k + 1) & 255]};
  float accum = 0.0f;
  g[0] = g[1] = g[2] = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    float wu = di ? sx : (1.0f - sx);
    float dwu = di ? dsx : -dsx;
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      float wv = dj ? sy : (1.0f - sy);
      float dwv = dj ? dsy : -dsy;
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        float ww = dk ? sz : (1.0f - sz);
        float dww = dk ? dsz : -dsz;
        int h = pa[di] ^ pb[dj] ^ pc[dk];
        float gx = vx[h], gy = vy[h], gz = vz[h];
        float dot = gx * (ux - (float)di) + gy * (uy - (float)dj)
                    + gz * (uz - (float)dk);
        float w3 = wu * wv * ww;
        accum = accum + w3 * dot;
        g[0] = g[0] + (dwu * wv * ww * dot + w3 * gx);
        g[1] = g[1] + (wu * dwv * ww * dot + w3 * gy);
        g[2] = g[2] + (wu * wv * dww * dot + w3 * gz);
      }
    }
  }
  return accum;
}

// turbulence |sum_o 0.5^o noise(2^o q)| and its gradient in q
__device__ __forceinline__ float turb_grad(const Params& p, int table,
                                           float qx, float qy, float qz,
                                           float g[3]) {
  float accum = 0.0f, weight = 1.0f, scale = 1.0f;
  float gs[3] = {0.0f, 0.0f, 0.0f};
  for (int o = 0; o < 7; ++o) {
    float gn[3];
    accum = accum + weight * noise_grad(p, table, qx, qy, qz, gn);
    float ws = weight * scale;
    gs[0] = gs[0] + ws * gn[0];
    gs[1] = gs[1] + ws * gn[1];
    gs[2] = gs[2] + ws * gn[2];
    weight = weight * 0.5f;
    scale = scale * 2.0f;
    qx = qx * 2.0f;
    qy = qy * 2.0f;
    qz = qz * 2.0f;
  }
  float sgn = accum > 0.0f ? 1.0f : (accum < 0.0f ? -1.0f : 0.0f);
  g[0] = sgn * gs[0];
  g[1] = sgn * gs[1];
  g[2] = sgn * gs[2];
  return fabsf(accum);
}

// ---- the forward record of one bounce -----------------------------------

struct Rec {
  // winner
  int idx;
  bool hit, kind_q, kind_m;
  int m;                       // medium index when kind_m
  // sphere
  float frac;
  V3 c, oc;
  float rad, a, b, cc, disc, sq, inv_a;
  bool pos, apos, use1;
  // quad
  V3 nq;
  float num, den_s;
  bool dok;
  // medium (the winner's): sphere boundary
  V3 ocm;
  float bm, ccm, discm, sqm;
  bool posm;
  // medium: box boundary
  float c2, s2, o1, o2, o3, iv1, iv2, iv3;
  float ta[3], tb[3], mn[3], mx12, t0m, inner, hit_dm, ray_len;
  // record
  float t, t_safe, inv_rad;
  bool hit_rec, rnz, front;
  V3 p, ns, n_out, n;
  float flip;
  // texture
  int tex_src;                 // 0 solid c0, 1 checker c1, 2 marble, 3 none
  float tex[3];
  float arg, turb_g[3];
  int table;
  // emission and scatter
  bool miss, alive, lit, is_light, is_l, is_m, is_d, is_i;
  float dls, d_len, ddn, neg_dot, cos_t, ratio, inv_ior, rs, kk, par;
  bool cannot, do_refl;
  V3 ud, b3, r, f, w;
  float fuzz, att[3];
  bool alive2;
};

struct State {
  V3 o, d;
  float thr[3];
};

// ---- stages: forward ------------------------------------------------------

__device__ __forceinline__ void sphere_fwd(const Params& p, const float* row,
                                           const State& s, float tm, Rec& r) {
  r.frac = (tm - row[6]) * row[7];
  r.c.x = row[0] + r.frac * row[3];
  r.c.y = row[1] + r.frac * row[4];
  r.c.z = row[2] + r.frac * row[5];
  r.rad = row[8];
  r.oc.x = s.o.x - r.c.x;
  r.oc.y = s.o.y - r.c.y;
  r.oc.z = s.o.z - r.c.z;
  r.a = s.d.x * s.d.x + s.d.y * s.d.y + s.d.z * s.d.z;
  r.b = r.oc.x * s.d.x + r.oc.y * s.d.y + r.oc.z * s.d.z;
  r.cc = r.oc.x * r.oc.x + r.oc.y * r.oc.y + r.oc.z * r.oc.z
         - r.rad * r.rad;
  r.disc = r.b * r.b - r.a * r.cc;
  r.pos = r.disc > 0.0f;
  r.sq = sqrtf(r.pos ? r.disc : 1.0f);
  r.apos = r.a > 0.0f;
  r.inv_a = 1.0f / (r.apos ? r.a : 1.0f);
}

__device__ __forceinline__ float sphere_t(const Params& p, Rec& r) {
  float root1 = (-r.b - r.sq) * r.inv_a;
  float root2 = (-r.b + r.sq) * r.inv_a;
  r.use1 = root1 > p.t_min;
  return r.use1 ? root1 : root2;
}

__device__ __forceinline__ float quad_fwd(const float* row, const State& s,
                                          Rec& r) {
  r.nq = V3{row[0], row[1], row[2]};
  float d_plane = r.nq.x * row[9] + r.nq.y * row[10] + r.nq.z * row[11];
  float denom = s.d.x * r.nq.x + s.d.y * r.nq.y + s.d.z * r.nq.z;
  r.dok = fabsf(denom) >= mega2::EPS8;
  r.den_s = r.dok ? denom : 1.0f;
  r.num = d_plane - (s.o.x * r.nq.x + s.o.y * r.nq.y + s.o.z * r.nq.z);
  return r.num / r.den_s;
}

__device__ __forceinline__ float medium_fwd(const Params& p, const State& s,
                                            uint32_t pix_ctr, int k, Rec& r) {
  const float* md = p.med + r.m * MED_COLS;
  uint32_t w0 = pix_ctr, w1 = p.samp,
           w2 = mega2::MEDIUM_STREAM | (uint32_t)k, w3 = (uint32_t)r.m;
  mega2::pcg4d(w0, w1, w2, w3);
  const float u_m = mega2::unit(w0) + mega2::INV24;
  r.ray_len = sqrtf(r.apos ? r.a : 1.0f);
  if ((int)md[0] == mega2::MED_BOX) {
    r.c2 = md[11];
    r.s2 = md[12];
    float pox = s.o.x - md[14], poy = s.o.y - md[15], poz = s.o.z - md[16];
    r.o1 = r.c2 * pox - r.s2 * poz;
    r.o2 = poy;
    r.o3 = r.s2 * pox + r.c2 * poz;
    const float e1 = r.c2 * s.d.x - r.s2 * s.d.z;
    const float e2 = s.d.y;
    const float e3 = r.s2 * s.d.x + r.c2 * s.d.z;
    r.iv1 = 1.0f / e1;
    r.iv2 = 1.0f / e2;
    r.iv3 = 1.0f / e3;
    const float oo[3] = {r.o1, r.o2, r.o3};
    const float iv[3] = {r.iv1, r.iv2, r.iv3};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      r.ta[ax] = (md[5 + ax] - oo[ax]) * iv[ax];
      r.tb[ax] = (md[8 + ax] - oo[ax]) * iv[ax];
      r.mn[ax] = mega2::fmin_p(r.ta[ax], r.tb[ax]);
    }
    r.mx12 = mega2::fmax_p(r.mn[0], r.mn[1]);
    r.t0m = mega2::fmax_p(r.mx12, r.mn[2]);
  } else {
    r.ocm = V3{s.o.x - md[1], s.o.y - md[2], s.o.z - md[3]};
    r.bm = r.ocm.x * s.d.x + r.ocm.y * s.d.y + r.ocm.z * s.d.z;
    r.ccm = r.ocm.x * r.ocm.x + r.ocm.y * r.ocm.y + r.ocm.z * r.ocm.z
            - md[4] * md[4];
    r.discm = r.bm * r.bm - r.a * r.ccm;
    r.posm = r.discm > 0.0f;
    r.sqm = sqrtf(r.posm ? r.discm : 1.0f);
    r.t0m = (-r.bm - r.sqm) * r.inv_a;
  }
  r.inner = mega2::fmax_p(r.t0m, p.t_min);
  float t0c = mega2::fmax_p(r.inner, 0.0f);
  r.hit_dm = md[13] * logf(u_m);
  return t0c + r.hit_dm / r.ray_len;
}

__device__ __forceinline__ void record_fwd(const State& s, Rec& r) {
  r.p.x = s.o.x + r.t_safe * s.d.x;
  r.p.y = s.o.y + r.t_safe * s.d.y;
  r.p.z = s.o.z + r.t_safe * s.d.z;
  r.rnz = r.rad != 0.0f;
  r.inv_rad = 1.0f / (r.rnz ? r.rad : 1.0f);
  r.ns.x = (r.p.x - r.c.x) * r.inv_rad;
  r.ns.y = (r.p.y - r.c.y) * r.inv_rad;
  r.ns.z = (r.p.z - r.c.z) * r.inv_rad;
  r.n_out = r.kind_q ? r.nq : r.ns;
  if (r.kind_m) r.n_out = V3{1.0f, 0.0f, 0.0f};
  float d_dot_n = s.d.x * r.n_out.x + s.d.y * r.n_out.y + s.d.z * r.n_out.z;
  r.front = (d_dot_n < 0.0f) || r.kind_m;
  r.flip = r.front ? 1.0f : -1.0f;
  r.n = V3{r.n_out.x * r.flip, r.n_out.y * r.flip, r.n_out.z * r.flip};
}

// nearest texel of the winner's image (integer index: no gradient)
__device__ __forceinline__ void image_fwd(const Params& p, const float* row,
                                          Rec& r) {
  float cth = row[9], sth = row[10];
  float ox_n = cth * r.ns.x - sth * r.ns.z;
  float oz_n = sth * r.ns.x + cth * r.ns.z;
  float ny_c = mega2::clamp_p(-r.ns.y, -1.0f, 1.0f);
  float theta = mega2::acos_poly(ny_c);
  float phi = mega2::atan2_poly(-oz_n, ox_n) + mega2::PI_F;
  float u_s = phi * mega2::INV_2PI;
  float v_s = theta * mega2::INV_PI;
  if (p.np_rows > p.S && r.kind_q) {
    float pqx = r.p.x - row[9], pqy = r.p.y - row[10], pqz = r.p.z - row[11];
    u_s = pqx * row[3] + pqy * row[4] + pqz * row[5];
    v_s = pqx * row[6] + pqy * row[7] + pqz * row[8];
  }
  float uu = mega2::clamp_p(u_s, 0.0f, 1.0f);
  float vv = 1.0f - mega2::clamp_p(v_s, 0.0f, 1.0f);
  float img_id = row[26];
  r.tex[0] = r.tex[1] = r.tex[2] = 0.0f;
  for (int i = 0; i < p.n_images; ++i) {
    if (p.n_images > 1 && img_id != (float)i) continue;
    const int* dims = p.img_dims + 3 * i;
    int iw = dims[0], ih = dims[1];
    long long ix = min((long long)(uu * (float)iw), (long long)(iw - 1));
    long long iy = min((long long)(vv * (float)ih), (long long)(ih - 1));
    int packed = p.texels[(dims[2] + iy) * p.tex_cols + ix];
    r.tex[0] = (float)((packed >> 16) & 255) * mega2::INV255;
    r.tex[1] = (float)((packed >> 8) & 255) * mega2::INV255;
    r.tex[2] = (float)(packed & 255) * mega2::INV255;
  }
  if (img_id < 0.0f) {                       // missing image: debug cyan
    r.tex[0] = 0.0f;
    r.tex[1] = 1.0f;
    r.tex[2] = 1.0f;
  }
}

__device__ __forceinline__ void texture_fwd(const Params& p, const float* row,
                                            Rec& r) {
  r.tex_src = 0;
  r.tex[0] = row[17];
  r.tex[1] = row[18];
  r.tex[2] = row[19];
  if (p.has_checker) {
    float inv_s = row[23];
    long long cells = (long long)floorf(inv_s * r.p.x)
                      + (long long)floorf(inv_s * r.p.y)
                      + (long long)floorf(inv_s * r.p.z);
    if (row[16] == mega2::TEX_CHECKER && (cells & 1) != 0) {
      r.tex_src = 1;
      r.tex[0] = row[20];
      r.tex[1] = row[21];
      r.tex[2] = row[22];
    }
  }
  if (p.has_noise && row[16] == mega2::TEX_NOISE) {
    r.table = 0;
    for (int t = 1; t < p.n_noise; ++t)
      if (row[25] == (float)t) r.table = t;
    float turb = turb_grad(p, r.table, r.p.x, r.p.y, r.p.z, r.turb_g);
    r.arg = row[24] * r.p.z + 10.0f * turb;
    float marble = 0.5f * (1.0f + sinf(r.arg));
    r.tex_src = 2;
    r.tex[0] = r.tex[1] = r.tex[2] = marble;
  }
  if (p.has_image && row[16] == mega2::TEX_IMAGE) {
    r.tex_src = 3;
    image_fwd(p, row, r);
  }
}

__device__ __forceinline__ void emit_fwd(const Params& p, const State& s,
                                         const float* row, Rec& r,
                                         float dacc[3]) {
  r.is_light = row[13] == mega2::MAT_DIFFUSE_LIGHT;
  r.miss = !r.hit_rec;
  r.alive = r.hit_rec;
  r.lit = r.alive && r.is_light;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    dacc[c] = r.miss ? s.thr[c] * p.bg[c]
                     : (r.lit ? s.thr[c] * r.tex[c] : 0.0f);
}

__device__ __forceinline__ void scatter_fwd(const Params& p, const State& s,
                                            const float* row,
                                            uint32_t pix_ctr, int k, Rec& r,
                                            V3& nd) {
  uint32_t w0 = pix_ctr, w1 = p.samp,
           w2 = mega2::SCATTER_STREAM | (uint32_t)k, w3 = 0u;
  mega2::pcg4d(w0, w1, w2, w3);
  const float u1 = mega2::unit(w0), u2 = mega2::unit(w1),
              u3 = mega2::unit(w2), u4 = mega2::unit(w3);
  r.d_len = r.apos ? sqrtf(r.a) : 0.0f;
  r.dls = r.d_len > 0.0f ? r.d_len : 1.0f;
  r.ud = V3{s.d.x / r.dls, s.d.y / r.dls, s.d.z / r.dls};
  const float zb = 1.0f - 2.0f * u1;
  const float phi = mega2::TWO_PI * u2;
  const float rr = 1.0f - zb * zb;
  const float rho = rr > 0.0f ? sqrtf(rr) : 0.0f;
  const float r_b = u3 > 0.0f ? powf(u3, mega2::ONE_THIRD) : 0.0f;
  const float cphi = cosf(phi), sphi = sinf(phi);
  r.b3 = V3{r_b * rho * cphi, r_b * rho * sphi, r_b * zb};
  const V3 n = r.n;
  const float kind = row[13];
  r.fuzz = row[14];
  const float ior = row[15];

  V3 l{n.x + r.b3.x, n.y + r.b3.y, n.z + r.b3.z};
  if (fabsf(l.x) < mega2::EPS8 && fabsf(l.y) < mega2::EPS8
      && fabsf(l.z) < mega2::EPS8)
    l = n;

  r.ddn = r.ud.x * n.x + r.ud.y * n.y + r.ud.z * n.z;
  r.r = V3{r.ud.x - 2.0f * r.ddn * n.x, r.ud.y - 2.0f * r.ddn * n.y,
           r.ud.z - 2.0f * r.ddn * n.z};
  V3 mv{r.r.x + r.fuzz * r.b3.x, r.r.y + r.fuzz * r.b3.y,
        r.r.z + r.fuzz * r.b3.z};
  const bool metal_ok = (mv.x * n.x + mv.y * n.y + mv.z * n.z) > 0.0f;

  r.inv_ior = 1.0f / ior;
  r.ratio = r.front ? r.inv_ior : ior;
  r.neg_dot = -(r.ud.x * n.x + r.ud.y * n.y + r.ud.z * n.z);
  r.cos_t = mega2::fmin_p(r.neg_dot, 1.0f);
  const float ss = 1.0f - r.cos_t * r.cos_t;
  const float sin_t = ss > 0.0f ? sqrtf(ss) : 0.0f;
  r.cannot = r.ratio * sin_t > 1.0f;
  float r0 = (1.0f - r.ratio) / (1.0f + r.ratio);
  r0 = r0 * r0;
  const float om = 1.0f - r.cos_t;
  const float om2 = om * om;
  const float refl = r0 + (1.0f - r0) * (om * (om2 * om2));
  r.do_refl = r.cannot || refl > u4;
  r.rs = r.cannot ? 0.0f : r.ratio;
  r.w = V3{r.ud.x + r.cos_t * n.x, r.ud.y + r.cos_t * n.y,
           r.ud.z + r.cos_t * n.z};
  r.f = V3{r.rs * r.w.x, r.rs * r.w.y, r.rs * r.w.z};
  r.kk = fabsf(1.0f - (r.f.x * r.f.x + r.f.y * r.f.y + r.f.z * r.f.z));
  r.par = -(r.kk > 0.0f ? sqrtf(r.kk) : 0.0f);
  V3 dd = r.do_refl ? r.r
                    : V3{r.f.x + r.par * n.x, r.f.y + r.par * n.y,
                         r.f.z + r.par * n.z};

  r.is_l = kind == mega2::MAT_LAMBERTIAN;
  r.is_m = kind == mega2::MAT_METAL;
  r.is_d = kind == mega2::MAT_DIELECTRIC;
  r.is_i = p.n_media > 0 && kind == mega2::MAT_ISOTROPIC;
  nd = r.ud;
  if (r.is_l) nd = l;
  if (r.is_m) nd = mv;
  if (r.is_d) nd = dd;
  if (r.is_i) nd = V3{rho * cphi, rho * sphi, zb};
#pragma unroll
  for (int c = 0; c < 3; ++c) r.att[c] = r.is_d ? 1.0f : r.tex[c];
  const bool scattered = (!r.is_m || metal_ok) && !r.is_light;
  r.alive2 = r.alive && scattered;
}

// The whole forward bounce of an active lane: fills `r`, advances `s`
// (o, d, thr) and writes the radiance delta.  Returns alive2.
__device__ __forceinline__ bool bounce_fwd(const Params& p, int win,
                                           float tm, uint32_t pix_ctr, int k,
                                           State& s, Rec& r, float dacc[3]) {
  r.hit = win >= 0;
  r.kind_m = p.n_media > 0 && win >= p.med_base;
  r.kind_q = win >= p.S && !r.kind_m;
  r.m = r.kind_m ? win - p.med_base : 0;
  r.idx = min(max(win, 0), p.np_rows - 1);
  const float* row = p.rep + (size_t)r.idx * REP_COLS;

  sphere_fwd(p, row, s, tm, r);
  float t = sphere_t(p, r);
  float tq = quad_fwd(row, s, r);
  if (r.kind_q) t = tq;
  if (r.kind_m) t = medium_fwd(p, s, pix_ctr, k, r);
  r.t = r.hit ? t : mega2::BIG;
  r.hit_rec = r.t < mega2::HALF_BIG;
  r.t_safe = r.hit_rec ? r.t : 1.0f;
  record_fwd(s, r);
  texture_fwd(p, row, r);
  emit_fwd(p, s, row, r, dacc);
  V3 nd;
  scatter_fwd(p, s, row, pix_ctr, k, r, nd);
  if (r.alive2) {
    s.o = r.p;
    s.d = nd;
#pragma unroll
    for (int c = 0; c < 3; ++c) s.thr[c] = s.thr[c] * r.att[c];
  }
  return r.alive2;
}

// ---- stages: adjoints ------------------------------------------------------

// Cotangents of one bounce's inputs, accumulated.
struct Grad {
  V3 o, d;
  float thr[3];
  float tm, a;         // tm: the lane's time; a: |d|^2 (folded into d last)
  float row[REP_COLS];
  float bg[3];
};

__device__ __forceinline__ void add3(V3& a, V3 b, float s) {
  a.x = a.x + b.x * s;
  a.y = a.y + b.y * s;
  a.z = a.z + b.z * s;
}

// scatter: cotangent of the new direction -> n, ud, a, fuzz, ior
__device__ __forceinline__ void scatter_bwd(const Rec& r, V3 d_new,
                                            V3& d_n, V3& d_ud, float& d_fuzz,
                                            float& d_ior) {
  V3 d_r{0.0f, 0.0f, 0.0f};
  if (r.is_i) {
    // isotropic: a direction from the RNG alone
  } else if (r.is_d) {
    if (r.do_refl) {
      d_r = d_new;
    } else {
      // g = f + par * n
      V3 d_f = d_new;
      float d_par = dot3(d_new, r.n);
      add3(d_n, d_new, r.par);
      // par = -safe_sqrt(kk); kk = |1 - f.f|
      float d_kk = r.kk > 0.0f ? sqrt_bwd(-d_par, r.kk) : 0.0f;
      float one_m = 1.0f - (r.f.x * r.f.x + r.f.y * r.f.y + r.f.z * r.f.z);
      float sgn = one_m > 0.0f ? 1.0f : (one_m < 0.0f ? -1.0f : 0.0f);
      float d_ff = -(sgn * d_kk);
      add3(d_f, r.f, 2.0f * d_ff);
      // f = rs * w, w = ud + cos_t * n
      float d_rs = dot3(d_f, r.w);
      V3 d_w{r.rs * d_f.x, r.rs * d_f.y, r.rs * d_f.z};
      add3(d_ud, d_w, 1.0f);
      float d_cos = dot3(d_w, r.n);
      add3(d_n, d_w, r.cos_t);
      // rs = cannot ? 0 : ratio
      float d_ratio = r.cannot ? 0.0f : d_rs;
      // cos_t = min(-(ud . n), 1)
      float d_neg = d_cos * min_share(r.neg_dot, 1.0f);
      add3(d_ud, r.n, -d_neg);
      add3(d_n, r.ud, -d_neg);
      // ratio = front ? 1 / ior : ior
      d_ior = d_ior + (r.front ? -(d_ratio * (r.inv_ior * r.inv_ior))
                               : d_ratio);
    }
  } else if (r.is_m) {
    d_r = d_new;
    d_fuzz = d_fuzz + dot3(d_new, r.b3);
  } else if (r.is_l) {
    add3(d_n, d_new, 1.0f);            // l = n + ball (or n): d_l -> n
  } else {
    add3(d_ud, d_new, 1.0f);
  }
  // reflection r = ud - (2 * ddn) * n, ddn = ud . n
  float d_ddn = -2.0f * dot3(d_r, r.n);
  add3(d_ud, d_r, 1.0f);
  add3(d_n, d_r, -(2.0f * r.ddn));
  add3(d_ud, r.n, d_ddn);
  add3(d_n, r.ud, d_ddn);
}

// ud = d / dls, dls = (a > 0 ? sqrt(a) : 0) guarded to 1
__device__ __forceinline__ void unit_dir_bwd(const Rec& r, const State& s,
                                             V3 d_ud, Grad& g) {
  g.d.x = g.d.x + d_ud.x / r.dls;
  g.d.y = g.d.y + d_ud.y / r.dls;
  g.d.z = g.d.z + d_ud.z / r.dls;
  float d_dls = -(d_ud.x * ((s.d.x / r.dls) / r.dls)
                  + d_ud.y * ((s.d.y / r.dls) / r.dls)
                  + d_ud.z * ((s.d.z / r.dls) / r.dls));
  if (r.d_len > 0.0f && r.apos) g.a = g.a + sqrt_bwd(d_dls, r.a);
}

// texture value cotangent -> table columns or (marble) the hit point
__device__ __forceinline__ void texture_bwd(const float* row, const Rec& r,
                                            const float d_tex[3], V3& d_p,
                                            Grad& g) {
  // the columns by constant index, each side of the branch: a run-time
  // index would put all of `g` in local memory
  if (r.tex_src == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g.row[17 + c] = g.row[17 + c] + d_tex[c];
  } else if (r.tex_src == 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g.row[20 + c] = g.row[20 + c] + d_tex[c];
  } else if (r.tex_src == 2) {
    // marble = 0.5 * (1 + sin(arg)), arg = s * pz + 10 * turb
    float d_m = d_tex[0] + d_tex[1] + d_tex[2];
    float d_arg = (0.5f * d_m) * cosf(r.arg);
    g.row[24] = g.row[24] + r.p.z * d_arg;
    d_p.z = d_p.z + row[24] * d_arg;
    float d_turb = 10.0f * d_arg;
    d_p.x = d_p.x + d_turb * r.turb_g[0];
    d_p.y = d_p.y + d_turb * r.turb_g[1];
    d_p.z = d_p.z + d_turb * r.turb_g[2];
  }
  // tex_src 3: image texels, an integer index -- no gradient
}

__device__ __forceinline__ void sphere_bwd(const Params& p, const float* row,
                                           const Rec& r, const State& s,
                                           float tm, float d_t, V3 d_c,
                                           float d_rad, Grad& g) {
  float d_r1 = r.use1 ? d_t : 0.0f;
  float d_r2 = r.use1 ? 0.0f : d_t;
  float d_b = -(d_r1 * r.inv_a) - d_r2 * r.inv_a;
  float d_sq = -(d_r1 * r.inv_a) + d_r2 * r.inv_a;
  float d_inv_a = (-r.b - r.sq) * d_r1 + (-r.b + r.sq) * d_r2;
  if (r.apos) g.a = g.a - d_inv_a * (r.inv_a * r.inv_a);
  float d_disc = r.pos ? sqrt_bwd(d_sq, r.disc) : 0.0f;
  d_b = d_b + 2.0f * r.b * d_disc;
  g.a = g.a - r.cc * d_disc;
  float d_cc = -(r.a * d_disc);
  V3 d_oc{2.0f * r.oc.x * d_cc, 2.0f * r.oc.y * d_cc, 2.0f * r.oc.z * d_cc};
  d_rad = d_rad - 2.0f * r.rad * d_cc;
  add3(d_oc, s.d, d_b);
  add3(g.d, r.oc, d_b);
  add3(g.o, d_oc, 1.0f);
  add3(d_c, d_oc, -1.0f);
  // centre c = c0 + frac * dc, frac = (tm - t0) * inv_dt
  g.row[0] = g.row[0] + d_c.x;
  g.row[1] = g.row[1] + d_c.y;
  g.row[2] = g.row[2] + d_c.z;
  g.row[3] = g.row[3] + r.frac * d_c.x;
  g.row[4] = g.row[4] + r.frac * d_c.y;
  g.row[5] = g.row[5] + r.frac * d_c.z;
  float d_frac = d_c.x * row[3] + d_c.y * row[4] + d_c.z * row[5];
  g.tm = g.tm + row[7] * d_frac;
  g.row[6] = g.row[6] - row[7] * d_frac;
  g.row[7] = g.row[7] + (tm - row[6]) * d_frac;
  g.row[8] = g.row[8] + d_rad;
}

__device__ __forceinline__ void quad_bwd(const float* row, const Rec& r,
                                         const State& s, float d_t, V3 d_nq,
                                         Grad& g) {
  float d_num = d_t / r.den_s;
  float d_den_s = -(d_t * ((r.num / r.den_s) / r.den_s));
  float d_denom = r.dok ? d_den_s : 0.0f;
  add3(g.d, r.nq, d_denom);
  add3(d_nq, s.d, d_denom);
  // num = d_plane - o . nq, d_plane = nq . q
  add3(g.o, r.nq, -d_num);
  add3(d_nq, s.o, -d_num);
  const V3 q{row[9], row[10], row[11]};
  add3(d_nq, q, d_num);
  g.row[9] = g.row[9] + d_num * r.nq.x;
  g.row[10] = g.row[10] + d_num * r.nq.y;
  g.row[11] = g.row[11] + d_num * r.nq.z;
  g.row[0] = g.row[0] + d_nq.x;
  g.row[1] = g.row[1] + d_nq.y;
  g.row[2] = g.row[2] + d_nq.z;
}

__device__ __forceinline__ void medium_bwd(const Params& p, const Rec& r,
                                           const State& s, float d_t,
                                           Grad& g) {
  const float* md = p.med + r.m * MED_COLS;
  // t_m = t0c + hit_dm / ray_len; ray_len = sqrt(a > 0 ? a : 1)
  float d_rl = -(d_t * ((r.hit_dm / r.ray_len) / r.ray_len));
  if (r.apos) g.a = g.a + sqrt_bwd(d_rl, r.a);
  float d_inner = d_t * max_share(r.inner, 0.0f);
  float d_t0m = d_inner * max_share(r.t0m, p.t_min);
  if ((int)md[0] == mega2::MED_BOX) {
    float d_mx12 = d_t0m * max_share(r.mx12, r.mn[2]);
    float d_mn[3] = {d_mx12 * max_share(r.mn[0], r.mn[1]),
                     d_mx12 * max_share(r.mn[1], r.mn[0]),
                     d_t0m * max_share(r.mn[2], r.mx12)};
    const float oo[3] = {r.o1, r.o2, r.o3};
    const float iv[3] = {r.iv1, r.iv2, r.iv3};
    float d_o[3], d_e[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      float d_ta = d_mn[ax] * min_share(r.ta[ax], r.tb[ax]);
      float d_tb = d_mn[ax] * min_share(r.tb[ax], r.ta[ax]);
      d_o[ax] = -(d_ta * iv[ax]) - d_tb * iv[ax];
      float d_iv = (md[5 + ax] - oo[ax]) * d_ta + (md[8 + ax] - oo[ax]) * d_tb;
      d_e[ax] = -(d_iv * (iv[ax] * iv[ax]));
    }
    // o1 = c2 pox - s2 poz, o2 = poy, o3 = s2 pox + c2 poz (po = o - off)
    g.o.x = g.o.x + r.c2 * d_o[0] + r.s2 * d_o[2];
    g.o.y = g.o.y + d_o[1];
    g.o.z = g.o.z - r.s2 * d_o[0] + r.c2 * d_o[2];
    g.d.x = g.d.x + r.c2 * d_e[0] + r.s2 * d_e[2];
    g.d.y = g.d.y + d_e[1];
    g.d.z = g.d.z - r.s2 * d_e[0] + r.c2 * d_e[2];
  } else {
    float d_bm = -(d_t0m * r.inv_a);
    float d_sqm = -(d_t0m * r.inv_a);
    float d_inv_a = (-r.bm - r.sqm) * d_t0m;
    if (r.apos) g.a = g.a - d_inv_a * (r.inv_a * r.inv_a);
    float d_discm = r.posm ? sqrt_bwd(d_sqm, r.discm) : 0.0f;
    d_bm = d_bm + 2.0f * r.bm * d_discm;
    g.a = g.a - r.ccm * d_discm;
    float d_ccm = -(r.a * d_discm);
    V3 d_ocm{2.0f * r.ocm.x * d_ccm, 2.0f * r.ocm.y * d_ccm,
             2.0f * r.ocm.z * d_ccm};
    add3(d_ocm, s.d, d_bm);
    add3(g.d, r.ocm, d_bm);
    add3(g.o, d_ocm, 1.0f);
  }
}

// The adjoint of bounce_fwd for the same lane and record `r` (from the
// state `s` the bounce started from).  `dout` holds the cotangents of the
// bounce's outputs (o2, d2, thr2), `gacc` the radiance cotangent; `g`
// receives the cotangents of (o, d, thr), and accumulates tm, the table
// row and the background.
__device__ __forceinline__ void bounce_bwd(const Params& p, float tm,
                                           const State& s, const Rec& r,
                                           const State& dout,
                                           const float gacc[3], Grad& g) {
  const float* row = p.rep + (size_t)r.idx * REP_COLS;
  g.o = V3{0.0f, 0.0f, 0.0f};
  g.d = V3{0.0f, 0.0f, 0.0f};
  g.a = 0.0f;
  V3 d_p{0.0f, 0.0f, 0.0f}, d_new{0.0f, 0.0f, 0.0f};
  float d_tex[3] = {0.0f, 0.0f, 0.0f};
  // state update: o2, d2, thr2 = alive2 ? (p, new, thr * att) : (o, d, thr)
  if (r.alive2) {
    d_p = dout.o;
    d_new = dout.d;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g.thr[c] = dout.thr[c] * r.att[c];
      if (!r.is_d) d_tex[c] = dout.thr[c] * s.thr[c];
    }
  } else {
    g.o = dout.o;
    g.d = dout.d;
#pragma unroll
    for (int c = 0; c < 3; ++c) g.thr[c] = dout.thr[c];
  }
  // radiance: miss -> thr * bg; light -> thr * tex
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (r.miss) {
      g.thr[c] = g.thr[c] + gacc[c] * p.bg[c];
      g.bg[c] = g.bg[c] + gacc[c] * s.thr[c];
    } else if (r.lit) {
      g.thr[c] = g.thr[c] + gacc[c] * r.tex[c];
      d_tex[c] = d_tex[c] + gacc[c] * s.thr[c];
    }
  }
  // scatter -> front-faced normal n, unit direction ud, fuzz, ior
  V3 d_n{0.0f, 0.0f, 0.0f}, d_ud{0.0f, 0.0f, 0.0f};
  float d_fuzz = 0.0f, d_ior = 0.0f;
  if (r.alive2) scatter_bwd(r, d_new, d_n, d_ud, d_fuzz, d_ior);
  g.row[14] = g.row[14] + d_fuzz;
  g.row[15] = g.row[15] + d_ior;
  unit_dir_bwd(r, s, d_ud, g);
  // n = n_out * flip; n_out = quad normal | sphere normal | medium frame
  V3 d_nout{d_n.x * r.flip, d_n.y * r.flip, d_n.z * r.flip};
  V3 d_nq{0.0f, 0.0f, 0.0f}, d_ns{0.0f, 0.0f, 0.0f};
  if (r.kind_m) {
  } else if (r.kind_q) {
    d_nq = d_nout;
  } else {
    d_ns = d_nout;
  }
  texture_bwd(row, r, d_tex, d_p, g);
  // ns = (p - c) * inv_rad
  add3(d_p, d_ns, r.inv_rad);
  V3 d_c{-(d_ns.x * r.inv_rad), -(d_ns.y * r.inv_rad),
         -(d_ns.z * r.inv_rad)};
  float d_inv_rad = d_ns.x * (r.p.x - r.c.x) + d_ns.y * (r.p.y - r.c.y)
                    + d_ns.z * (r.p.z - r.c.z);
  float d_rad = r.rnz ? -(d_inv_rad * (r.inv_rad * r.inv_rad)) : 0.0f;
  // p = o + t_safe * d
  add3(g.o, d_p, 1.0f);
  float d_t = r.hit_rec ? dot3(d_p, s.d) : 0.0f;
  add3(g.d, d_p, r.t_safe);
  // t: the winner's kind (a miss has no cotangent left here)
  if (r.kind_m) {
    medium_bwd(p, r, s, d_t, g);
  } else if (r.kind_q) {
    quad_bwd(row, r, s, d_t, d_nq, g);
  } else if (r.hit) {
    sphere_bwd(p, row, r, s, tm, d_t, d_c, d_rad, g);
  }
  // a = d . d
  add3(g.d, s.d, 2.0f * g.a);
}

}  // namespace replay
