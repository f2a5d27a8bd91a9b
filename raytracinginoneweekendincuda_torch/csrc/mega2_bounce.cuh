// One bounce of the mega2 path tracer, per thread.
//
// Port of `bounce_core` in raytracinginoneweekendincuda_tpu/ops/mega2.py
// (the body of the persistent Pallas kernel `_make_kernel`): closest hit in
// key space over spheres, loose quads and axis-aligned box slabs, with the
// chunk cull of large worlds (`chunk_visible` there); constant media;
// winner attributes; checker / Perlin-marble / image textures; emission;
// the five materials' scatter.  The render kernel (K1, mega2_render.cu)
// runs it once an iteration of its flat per-lane loop, with the pair rows
// in shared memory where they fit; the winner-tape trace kernel (K2,
// mega2_trace.cu) runs it with textures compiled out and the rows in
// global memory.
//
// The chunk cull (kCull): the rows come in 64-row chunks, each with a box
// (ops/mega2.py's packer).  Before a chunk's rows, each lane runs the slab
// test of its own ray against the chunk's box within its current (t_min,
// best) interval and skips the rows if the ray cannot meet the box.  That
// keeps every winner that f32 arithmetic places inside its chunk's box; a
// hit the f32 sphere test reports on a sphere its ray misses can lie
// outside it and is skipped (ROADMAP.md, queue 3).  The test is per lane:
// K1 calls bounce() only from lanes that have a path and K2's threads
// return early, so a warp vote over the full mask here would be undefined;
// and a warp runs a chunk's rows if any of its lanes needs them either
// way.  The boxes (32 bytes a chunk) are read from global memory whatever
// the rows: every lane of a warp reads the same box, one L1 broadcast a
// chunk against the 64 rows it may save.
//
// The sphere tree (kTree; K1's unculled instantiations of worlds with
// several sphere chunks, chosen in mega2_render.cu): the packer's
// `sphere_tree` over the sphere rows but the oversized prefix (the
// ground), a complete binary tree in heap order (node i's children 2i and
// 2i + 1), a row a leaf.  Each lane tests the prefix rows, then walks the
// tree alone (`sphere_walk`), depth first: at an internal node it tests
// both children's boxes and goes down to the nearer one the ray may meet
// within (t_min, best], best in key space, keeping the other for later;
// at a leaf it tests the leaf's rows.  No stack: a node's index is its
// path from the root, so one bit a level (`trail`) says which siblings are
// still to visit, and going back is a shift.  So a lane tests only the
// rows whose boxes its ray may hit no farther than the running best.  Rows
// come out of order, so an equal key goes to the lower row explicitly:
// the winner is brute force's wherever the f32 hit lies in its row's box
// (a rounding hit outside it can be skipped, as in the cull).  K2
// (mega2_trace.cu) and the culled instantiations keep the loops over every
// row: bounce's kTree defaults to false.
//
// Arithmetic follows the plain PyTorch version (ops/mega2.py) op for op, in
// the same association order, and is compiled with --fmad=false: PyTorch's
// elementwise ops never contract a*b+c, so neither may this.  f32 constants
// are hex literals of numpy's float32 rounding of the reference's values.

#pragma once

#include <stdint.h>

namespace mega2 {

// Table layouts (row-major; see ops/mega2.py for the column notes).
constexpr int SPH_COLS = 16;
constexpr int QUAD_COLS = 16;
constexpr int ATTR_COLS = 40;
constexpr int MED_COLS = 22;
constexpr int CULL_C = 64;        // rows of a chunk
constexpr int CULL_COLS = 8;      // chunk boxes: 0:3 lo, 3:6 hi
constexpr int TREE_COLS = 8;      // sphere tree nodes (Params.tree)

constexpr uint32_t CAMERA_STREAM = 0x0CA30000u;
constexpr uint32_t SCATTER_STREAM = 0x5CA70000u;
constexpr uint32_t MEDIUM_STREAM = 0x3ED00000u;

constexpr float BIG = 0x1.93e594p+99f;        // 1e30
constexpr float TINY = 0x1.4484cp-100f;       // 1e-30
constexpr float HALF_BIG = 0x1.93e594p+98f;   // 5e29
constexpr float EPS8 = 0x1.5798eep-27f;       // 1e-8
constexpr float EPS4 = 0x1.a36e2ep-14f;       // 1e-4
constexpr float INV24 = 0x1p-24f;
constexpr float TWO_PI = 0x1.921fb6p+2f;
constexpr float HALF_PI = 0x1.921fb6p+0f;
constexpr float PI_F = 0x1.921fb6p+1f;
constexpr float INV_2PI = 0x1.45f306p-3f;     // 0.5 / pi
constexpr float INV_PI = 0x1.45f306p-2f;      // 1 / pi
constexpr float INV255 = 0x1.010102p-8f;      // 1 / 255
constexpr float ONE_THIRD = 0x1.555556p-2f;

constexpr float MAT_LAMBERTIAN = 0.0f;
constexpr float MAT_METAL = 1.0f;
constexpr float MAT_DIELECTRIC = 2.0f;
constexpr float MAT_DIFFUSE_LIGHT = 3.0f;
constexpr float MAT_ISOTROPIC = 4.0f;
constexpr float TEX_CHECKER = 1.0f;
constexpr float TEX_IMAGE = 2.0f;
constexpr float TEX_NOISE = 3.0f;
constexpr int MED_BOX = 1;

// Everything one frame's kernel reads.  Mirrored field for field by the
// ctypes Structure in ops/mega2.py.
struct Params {
  const float* sph;       // [s_pad, 16], 16-byte aligned
  const float* quad;      // [q_pad + b_pad, 16], 16-byte aligned
  const float* attr;      // [np_rows, 40]
  const float* med;       // [max(n_media,1), 22], col 14 = radius^2
  const int* perm;        // [8 * n_noise, 256]
  const float* vec;       // [24 * n_noise, 256]
  const int* texels;      // [rows, tex_cols] packed (r<<16)|(g<<8)|b
  const int* img_dims;    // [n_images, 3]: iw, ih, texel row offset
  float cam[21];          // origin, lower_left, horizontal, vertical, u, v,
                          // lens_radius, time0, time1
  float bg[3];
  float t_min;
  int s_pad, nl_pad, q_pad, b_pad, np_rows;
  int n_media, n_noise, n_images, tex_cols;
  int width, height, spp, max_bounces;
  uint32_t seed;
  const float* cull_s;    // [max(s_pad / 64, 1), 8] sphere chunk boxes
  const float* cull_q;    // [max((nl_pad + b_pad) / 64, 1), 8] loose-quad
                          // chunk boxes, then box-slab chunk boxes
  int cull_pairs;         // culled instantiations: gate sphere and loose-
  int cull_boxes;         // quad chunks / box-slab chunks
  int samp0;              // K1: global id of local sample 0 (raygen and
                          // every draw key on s + samp0)
  const float* tree;      // [2 * max(tree_n, 1), 8] sphere tree nodes, heap
                          // order from 1: 0:3 lo, 3:6 hi; a leaf's 6 first
                          // row, 7 rows
  int tree_p0;            // sphere rows tested before the walk
  int tree_n;             // the tree's leaves (nodes >= tree_n); 0: none
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm;
};

// The rows the pair loops read once a pair: spheres [s_pad, 16], loose
// quads [nl_pad, 16] and box slabs [b_pad, 16], each row 64 bytes (four
// float4), and the sphere tree's nodes (32 bytes each).  They point into
// Params' tables (global memory) or into a block's shared-memory copy of
// them.
struct PairRows {
  const float* sph;
  const float* lquad;
  const float* box;
  const float* tree;
};

__device__ __forceinline__ PairRows global_rows(const Params& p) {
  return {p.sph, p.quad, p.quad + p.q_pad * QUAD_COLS, p.tree};
}

// Columns 4*part .. 4*part+3 of row k: one float4 load from shared
// memory; from global memory, scalar loads, of which the compiler keeps
// only the columns used.
template <bool kSmemRows>
__device__ __forceinline__ float4 load_row(const float* rows, int k,
                                           int part) {
  const float4* r = reinterpret_cast<const float4*>(rows) + 4 * k + part;
  if (kSmemRows) return *r;
  const float* c = reinterpret_cast<const float*>(r);
  return make_float4(c[0], c[1], c[2], c[3]);
}

// ---- small helpers -------------------------------------------------------

// NaN-propagating min / max, as torch.minimum / torch.maximum.
__device__ __forceinline__ float fmin_p(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float fmax_p(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float clamp_p(float x, float lo, float hi) {
  return fmin_p(fmax_p(x, lo), hi);
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
  return (float)(w >> 8) * INV24;
}

// ---- raygen (ops/raygen.py) ----------------------------------------------

__device__ __forceinline__ Ray raygen(const Params& p, uint32_t pix_ctr,
                                      uint32_t samp, float i_f, float j_f) {
  const float* c = p.cam;
  uint32_t w0 = pix_ctr, w1 = samp, w2 = CAMERA_STREAM, w3 = 0u;
  pcg4d(w0, w1, w2, w3);
  float ju = unit(w0), jv = unit(w1), l1 = unit(w2), l2 = unit(w3);
  uint32_t t0 = pix_ctr, t1 = samp, t2 = CAMERA_STREAM + 1u, t3 = 0u;
  pcg4d(t0, t1, t2, t3);
  float tu = unit(t0);
  float s = (i_f + ju) / (float)p.width;
  float t = (j_f + jv) / (float)p.height;
  float rd_r = sqrtf(l1);
  float phi = TWO_PI * l2;
  float rd0 = c[18] * (rd_r * cosf(phi));
  float rd1 = c[18] * (rd_r * sinf(phi));
  float offx = c[12] * rd0 + c[15] * rd1;
  float offy = c[13] * rd0 + c[16] * rd1;
  float offz = c[14] * rd0 + c[17] * rd1;
  Ray r;
  r.ox = c[0] + offx;
  r.oy = c[1] + offy;
  r.oz = c[2] + offz;
  r.dx = c[3] + s * c[6] + t * c[9] - c[0] - offx;
  r.dy = c[4] + s * c[7] + t * c[10] - c[1] - offy;
  r.dz = c[5] + s * c[8] + t * c[11] - c[2] - offz;
  r.tm = c[19] + tu * (c[20] - c[19]);
  return r;
}

// ---- textures --------------------------------------------------------------

__device__ __forceinline__ float perlin_noise(const Params& p, int table,
                                              float qx, float qy, float qz) {
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
  int pa[2] = {px[i & 255], px[(i + 1) & 255]};
  int pb[2] = {py[j & 255], py[(j + 1) & 255]};
  int pc[2] = {pz[k & 255], pz[(k + 1) & 255]};
  float accum = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    float wu = di ? sx : (1.0f - sx);
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      float wv = dj ? sy : (1.0f - sy);
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        float ww = dk ? sz : (1.0f - sz);
        int h = pa[di] ^ pb[dj] ^ pc[dk];
        float dot = vx[h] * (ux - (float)di) + vy[h] * (uy - (float)dj)
                    + vz[h] * (uz - (float)dk);
        accum = accum + wu * wv * ww * dot;
      }
    }
  }
  return accum;
}

__device__ __forceinline__ float perlin_turb(const Params& p, int table,
                                             float qx, float qy, float qz) {
  float accum = 0.0f;
  float weight = 1.0f;
  for (int o = 0; o < 7; ++o) {
    accum = accum + weight * perlin_noise(p, table, qx, qy, qz);
    weight = weight * 0.5f;
    qx = qx * 2.0f;
    qy = qy * 2.0f;
    qz = qz * 2.0f;
  }
  return fabsf(accum);
}

// Minimax atan2 / acos, the reference kernel's polynomials (not libm).
__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  bool swap = ay > ax;
  float num = swap ? ax : ay;
  float den = swap ? ay : ax;
  float r = num / (den > 0.0f ? den : 1.0f);
  float z2 = r * r;
  float q = -0x1.80148ep-7f;
  q = q * z2 + 0x1.af5604p-5f;
  q = q * z2 + -0x1.dce8b6p-4f;
  q = q * z2 + 0x1.8c6084p-3f;
  q = q * z2 + -0x1.549b4p-2f;
  q = q * z2 + 0x1.fffd04p-1f;
  float a = r * q;
  a = swap ? HALF_PI - a : a;
  a = (x < 0.0f) ? PI_F - a : a;
  a = (y < 0.0f) ? -a : a;
  return ((ax + ay) == 0.0f) ? 0.0f : a;
}

__device__ __forceinline__ float acos_poly(float x) {
  float s = sqrtf(fmax_p(1.0f - x * x, 0.0f));
  return atan2_poly(s, x);
}

// ---- the chunk cull ------------------------------------------------------

// Sanitized reciprocal of a direction component, as the JAX kernel's cull
// takes it: never nearer zero than 1e-30, so no inf and no NaN.
__device__ __forceinline__ float recip_sanitized(float v) {
  return 1.0f / (v >= 0.0f ? fmax_p(v, TINY) : fmin_p(v, -TINY));
}

// The JAX kernel's `chunk_visible` for one ray (AABB.h:68-98): may the ray
// r with reciprocal direction inv meet the chunk's box within (t_min,
// best)?  `scale` is the ray's a for sphere chunks, whose `best` is in key
// space, else 1 (exact).
__device__ __forceinline__ bool chunk_visible(const float* box, const Ray& r,
                                              const float inv[3],
                                              float t_min, float best,
                                              float scale) {
  const float tax = (__ldg(box + 0) - r.ox) * inv[0];
  const float tbx = (__ldg(box + 3) - r.ox) * inv[0];
  const float tay = (__ldg(box + 1) - r.oy) * inv[1];
  const float tby = (__ldg(box + 4) - r.oy) * inv[1];
  const float taz = (__ldg(box + 2) - r.oz) * inv[2];
  const float tbz = (__ldg(box + 5) - r.oz) * inv[2];
  const float near = fmax_p(fmax_p(fmin_p(tax, tbx), fmin_p(tay, tby)),
                            fmin_p(taz, tbz));
  const float far = fmin_p(fmin_p(fmax_p(tax, tbx), fmax_p(tay, tby)),
                           fmax_p(taz, tbz));
  return far >= fmax_p(near, t_min) && near * scale < best;
}

// ---- the closest-hit rows ----------------------------------------------

// Each tests one row against the ray and, where it is nearer than `best`
// (strict <, so the lowest row keeps a tie), makes it the winner.

// Sphere row k, in key space (key = t * a; a > 0 is per ray, so key order
// is t order).  kTied: rows come in any order, so an equal key wins too
// when its row is lower (the tree's walk).
template <bool kSmemRows, bool kTied = false>
__device__ __forceinline__ void sphere_row(const float* sph, int k,
                                           const Ray& r, float a, float akey,
                                           float& best, int& win) {
  const float4 s0 = load_row<kSmemRows>(sph, k, 0);
  const float4 s1 = load_row<kSmemRows>(sph, k, 1);
  const float4 s2 = load_row<kSmemRows>(sph, k, 2);
  if (!(s2.y > 0.5f)) return;               // explicit active-row mask
  float frac = (r.tm - s1.z) * s1.w;
  float cx = s0.x + frac * s0.w;
  float cy = s0.y + frac * s1.x;
  float cz = s0.z + frac * s1.y;
  float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  float b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  float cc = ocx * ocx + ocy * ocy + ocz * ocz - s2.z;
  float disc = b * b - a * cc;
  if (!(disc > 0.0f)) return;
  float sq = sqrtf(disc);
  float k1 = -b - sq;
  float key = (k1 > akey) ? k1 : (-b + sq);
  if (key > akey && (key < best || (kTied && key == best && k < win))) {
    win = k;
    best = key;
  }
}

// Loose-quad row k; spheres win ties.
template <bool kSmemRows>
__device__ __forceinline__ void quad_row(const float* lquad, int k,
                                         const Ray& r, float t_min,
                                         int s_pad, float& best, int& win) {
  const float4 q3 = load_row<kSmemRows>(lquad, k, 3);
  if (!(q3.x > 0.5f)) return;
  const float4 q0 = load_row<kSmemRows>(lquad, k, 0);
  float denom = r.dx * q0.x + r.dy * q0.y + r.dz * q0.z;
  if (!(fabsf(denom) >= EPS8)) return;
  float t = (q0.w - (r.ox * q0.x + r.oy * q0.y + r.oz * q0.z)) / denom;
  if (!(t >= t_min) || !(t < best)) return;
  const float4 q1 = load_row<kSmemRows>(lquad, k, 1);
  const float4 q2 = load_row<kSmemRows>(lquad, k, 2);
  float px = r.ox + t * r.dx, py = r.oy + t * r.dy, pz = r.oz + t * r.dz;
  float alpha = px * q1.x + py * q1.y + pz * q1.z - q1.w;
  float beta = px * q2.x + py * q2.y + pz * q2.z - q2.w;
  if (alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f) {
    win = s_pad + k;
    best = t;
  }
}

// Axis-aligned box slab row g; the winner is the hit face's quad row.
template <bool kSmemRows>
__device__ __forceinline__ void box_row(const float* box, int g,
                                        const float o3[3], const float d3[3],
                                        float t_min, int s_pad, float& best,
                                        int& win) {
  const float4 g0 = load_row<kSmemRows>(box, g, 0);
  const float4 g1 = load_row<kSmemRows>(box, g, 1);
  if (!(g1.w > 0.5f)) return;
  const float bmin[3] = {g0.x, g0.y, g0.z};
  const float bmax[3] = {g0.w, g1.x, g1.y};
  float nr[3], fr[3];
  bool side[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float o_a = o3[ax], d_a = d3[ax];
    bool d_ok = fabsf(d_a) >= EPS8;
    float ds = d_ok ? d_a : 1.0f;
    float t1 = (bmin[ax] - o_a) / ds;
    float t2 = (bmax[ax] - o_a) / ds;
    bool inside = (o_a >= bmin[ax]) && (o_a <= bmax[ax]);
    nr[ax] = d_ok ? fmin_p(t1, t2) : (inside ? -BIG : BIG);
    fr[ax] = d_ok ? fmax_p(t1, t2) : (inside ? BIG : -BIG);
    side[ax] = d_a > 0.0f;
  }
  float te = fmax_p(fmax_p(nr[0], nr[1]), nr[2]);
  float tx = fmin_p(fmin_p(fr[0], fr[1]), fr[2]);
  bool use_enter = te >= t_min;
  float tb = use_enter ? te : tx;
  if (!(te <= tx) || !(tb >= t_min) || !(tb < best)) return;
  // face offsets (min face, max face) per axis; first matching axis wins
  const int off_min[3] = {3, 5, 2};
  const int off_max[3] = {1, 4, 0};
  int off = 0;
#pragma unroll
  for (int ax = 2; ax >= 0; --ax) {
    if (use_enter ? (nr[ax] == te) : (fr[ax] == tx)) {
      off = (side[ax] == use_enter) ? off_min[ax] : off_max[ax];
    }
  }
  win = s_pad + (int)g1.z + off;
  best = tb;
}

// ---- the sphere tree's walk ----------------------------------------------

// Half `part` of tree node i: (lo.x, lo.y, lo.z, hi.x), (hi.y, hi.z, c6, c7).
template <bool kSmemRows>
__device__ __forceinline__ float4 tree_node(const float* tree, int i,
                                            int part) {
  const float4* q = reinterpret_cast<const float4*>(tree) + 2 * i + part;
  return kSmemRows ? *q : __ldg(q);
}

// Where the ray (reciprocal direction inv, sanitized, so no NaN) enters
// node i's box, in key space (near * a), or +inf if it cannot meet the box
// within (t_min, inf); the boxes are finite, so the plain min / max are the
// NaN-propagating ones.
template <bool kSmemRows>
__device__ __forceinline__ float node_entry(const float* tree, int i,
                                            const Ray& r, const float inv[3],
                                            float t_min, float a) {
  const float4 n0 = tree_node<kSmemRows>(tree, i, 0);
  const float4 n1 = tree_node<kSmemRows>(tree, i, 1);
  const float tax = (n0.x - r.ox) * inv[0];
  const float tbx = (n0.w - r.ox) * inv[0];
  const float tay = (n0.y - r.oy) * inv[1];
  const float tby = (n1.x - r.oy) * inv[1];
  const float taz = (n0.z - r.oz) * inv[2];
  const float tbz = (n1.y - r.oz) * inv[2];
  const float near = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)),
                           fminf(taz, tbz));
  const float far = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)),
                          fmaxf(taz, tbz));
  return far >= fmaxf(near, t_min) ? near * a : __int_as_float(0x7f800000);
}

// The closest sphere by the tree: the rows before p.tree_p0 in row order,
// then the walk (the notes at the top).  Same (best, win) as the loop over
// every row wherever the f32 hit lies in its row's box.
template <bool kSmemRows>
__device__ __forceinline__ void sphere_walk(const Params& p,
                                            const PairRows& rows,
                                            const Ray& r, float a,
                                            float akey, float& best,
                                            int& win) {
  for (int k = 0; k < p.tree_p0; ++k)
    sphere_row<kSmemRows>(rows.sph, k, r, a, akey, best, win);
  const float inv[3] = {recip_sanitized(r.dx), recip_sanitized(r.dy),
                        recip_sanitized(r.dz)};
  const int n = p.tree_n;
  if (!(node_entry<kSmemRows>(rows.tree, 1, r, inv, p.t_min, a) <= best))
    return;
  int node = 1;
  unsigned trail = 0u;      // bit j: the sibling of the node j levels up
  while (true) {            // (bit 0: of this node) is still to visit
    if (node < n) {         // internal: its children's boxes, nearer first
      const int c = 2 * node;
      const float ea = node_entry<kSmemRows>(rows.tree, c, r, inv, p.t_min,
                                             a);
      const float eb = node_entry<kSmemRows>(rows.tree, c + 1, r, inv,
                                             p.t_min, a);
      const bool ha = ea <= best, hb = eb <= best;
      if (ha && hb) {
        node = eb < ea ? c + 1 : c;
        trail = (trail << 1) | 1u;
        continue;
      }
      if (ha || hb) {
        node = ha ? c : c + 1;
        trail <<= 1;
        continue;
      }
    } else {                // leaf: rows c6 .. c6 + c7
      const float4 n1 = tree_node<kSmemRows>(rows.tree, node, 1);
      const int end = (int)n1.z + (int)n1.w;
      for (int k = (int)n1.z; k < end; ++k)
        sphere_row<kSmemRows, true>(rows.sph, k, r, a, akey, best, win);
    }
    if (trail == 0u) return;               // back up to the nearest sibling
    const int up = __ffs(trail) - 1;       // still to visit
    node = (node >> up) ^ 1;
    trail = (trail >> up) ^ 1u;
  }
}

// ---- one bounce ------------------------------------------------------------

// Advances the path by one bounce: finds the closest hit, adds background
// (miss) or emission to `acc`, scatters.  Returns whether the path goes on;
// `win` receives the winner row (-1 miss, np_rows + m for medium m).
// The pair loops read `rows`, from shared memory when kSmemRows.
// kTextures = false skips checker / marble / image evaluation: winners,
// normals and scatter do not depend on texture values (only thr and acc
// do), so the trace kernel compiles the texture machinery out.  Without
// kCull each table's loop tests every row; with it, the loop walks the
// rows chunk by chunk and skips a chunk (p.cull_pairs: sphere and
// loose-quad chunks, p.cull_boxes: box-slab chunks) whose box the ray's
// slab test rejects.  Both loops run the same row functions in the same
// row order, so the rows a culled bounce tests give the winner an
// unculled bounce finds among them.  With kTree (and not kCull) the
// closest sphere comes from `sphere_walk` over `rows.tree`.
template <bool kTextures = true, bool kSmemRows = false, bool kCull = false,
          bool kTree = false>
__device__ __forceinline__ bool bounce(const Params& p, const PairRows& rows,
                                       uint32_t pix_ctr, uint32_t samp,
                                       uint32_t bnc, Ray& r, float thr[3],
                                       float acc[3], int& win) {
  const float ox = r.ox, oy = r.oy, oz = r.oz;
  const float dx = r.dx, dy = r.dy, dz = r.dz, tm = r.tm;
  const float t_min = p.t_min;
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const float akey = t_min * a;
  float best = BIG;
  win = -1;
  float inv[3];                             // the cull's reciprocals

  // spheres; a sphere chunk's slab test compares in key space (near * a)
  if (kCull) {
    inv[0] = recip_sanitized(dx);
    inv[1] = recip_sanitized(dy);
    inv[2] = recip_sanitized(dz);
    for (int c = 0; c < p.s_pad / CULL_C; ++c)
      if (!p.cull_pairs || chunk_visible(p.cull_s + c * CULL_COLS, r, inv,
                                         t_min, best, a))
        for (int k = c * CULL_C; k < (c + 1) * CULL_C; ++k)
          sphere_row<kSmemRows>(rows.sph, k, r, a, akey, best, win);
  } else if (kTree) {
    sphere_walk<kSmemRows>(p, rows, r, a, akey, best, win);
  } else {
    for (int k = 0; k < p.s_pad; ++k)
      sphere_row<kSmemRows>(rows.sph, k, r, a, akey, best, win);
  }
  best = (best < HALF_BIG) ? best * inv_a : BIG;

  // loose quads
  if (kCull) {
    for (int c = 0; c < p.nl_pad / CULL_C; ++c)
      if (!p.cull_pairs || chunk_visible(p.cull_q + c * CULL_COLS, r, inv,
                                         t_min, best, 1.0f))
        for (int k = c * CULL_C; k < (c + 1) * CULL_C; ++k)
          quad_row<kSmemRows>(rows.lquad, k, r, t_min, p.s_pad, best, win);
  } else {
    for (int k = 0; k < p.nl_pad; ++k)
      quad_row<kSmemRows>(rows.lquad, k, r, t_min, p.s_pad, best, win);
  }

  // box slabs; their chunk boxes follow the loose quads' in cull_q
  const float o3[3] = {ox, oy, oz};
  const float d3[3] = {dx, dy, dz};
  if (kCull) {
    const float* box_cull = p.cull_q + (p.nl_pad / CULL_C) * CULL_COLS;
    for (int c = 0; c < p.b_pad / CULL_C; ++c)
      if (!p.cull_boxes || chunk_visible(box_cull + c * CULL_COLS, r, inv,
                                         t_min, best, 1.0f))
        for (int g = c * CULL_C; g < (c + 1) * CULL_C; ++g)
          box_row<kSmemRows>(rows.box, g, o3, d3, t_min, p.s_pad, best, win);
  } else {
    for (int g = 0; g < p.b_pad; ++g)
      box_row<kSmemRows>(rows.box, g, o3, d3, t_min, p.s_pad, best, win);
  }

  // constant media (later media after earlier ones, strict <)
  bool is_med = false;
  float alb[3] = {0.0f, 0.0f, 0.0f};
  const float ray_len = sqrtf(a);
  for (int m = 0; m < p.n_media; ++m) {
    const float* md = p.med + m * MED_COLS;
    uint32_t w0 = pix_ctr, w1 = samp, w2 = MEDIUM_STREAM | bnc,
             w3 = (uint32_t)m;
    pcg4d(w0, w1, w2, w3);
    float u_m = unit(w0) + INV24;           // (0, 1]
    float t0, t1;
    bool valid;
    if ((int)md[0] == MED_BOX) {
      float c2 = md[11], s2 = md[12];
      float pox = ox - md[16], poy = oy - md[17], poz = oz - md[18];
      float o1 = c2 * pox - s2 * poz;
      float o2 = poy;
      float o3b = s2 * pox + c2 * poz;
      float e1 = c2 * dx - s2 * dz;
      float e2 = dy;
      float e3 = s2 * dx + c2 * dz;
      float iv1 = 1.0f / e1, iv2 = 1.0f / e2, iv3 = 1.0f / e3;
      float ta1 = (md[5] - o1) * iv1, tb1 = (md[8] - o1) * iv1;
      float ta2 = (md[6] - o2) * iv2, tb2 = (md[9] - o2) * iv2;
      float ta3 = (md[7] - o3b) * iv3, tb3 = (md[10] - o3b) * iv3;
      t0 = fmax_p(fmax_p(fmin_p(ta1, tb1), fmin_p(ta2, tb2)),
                  fmin_p(ta3, tb3));
      t1 = fmin_p(fmin_p(fmax_p(ta1, tb1), fmax_p(ta2, tb2)),
                  fmax_p(ta3, tb3));
      valid = t1 > t0;
    } else {
      float ocx = ox - md[1], ocy = oy - md[2], ocz = oz - md[3];
      float b = ocx * dx + ocy * dy + ocz * dz;
      float cc = ocx * ocx + ocy * ocy + ocz * ocz - md[14];
      float disc = b * b - a * cc;
      float sq = sqrtf(fmax_p(disc, 0.0f));
      t0 = (-b - sq) * inv_a;
      t1 = (-b + sq) * inv_a;
      valid = disc > 0.0f;
    }
    valid = valid && (t1 > t0 + EPS4);
    float t0c = fmax_p(fmax_p(t0, t_min), 0.0f);
    valid = valid && (t0c < t1);
    float dist_in = (t1 - t0c) * ray_len;
    float hit_d = md[13] * logf(u_m);
    valid = valid && (hit_d <= dist_in);
    float t_m = t0c + hit_d / ray_len;
    if (valid && t_m < best) {
      best = t_m;
      is_med = true;
      win = p.np_rows + m;
      alb[0] = md[19];
      alb[1] = md[20];
      alb[2] = md[21];
    }
  }

  if (!(best < HALF_BIG)) {                 // miss -> background, path ends
    acc[0] = acc[0] + thr[0] * p.bg[0];
    acc[1] = acc[1] + thr[1] * p.bg[1];
    acc[2] = acc[2] + thr[2] * p.bg[2];
    return false;
  }

  // hit record (SetFaceNormal semantics)
  const float px = ox + best * dx, py = oy + best * dy, pz = oz + best * dz;
  float nx, ny, nz, tex[3], kind, fuzz = 0.0f, ior = 0.0f;
  bool front;
  if (is_med) {
    nx = 1.0f;
    ny = 0.0f;
    nz = 0.0f;
    front = true;
    kind = MAT_ISOTROPIC;
    tex[0] = alb[0];
    tex[1] = alb[1];
    tex[2] = alb[2];
  } else {
    const float* aw = p.attr + win * ATTR_COLS;
    float frac_w = (tm - aw[6]) * aw[7];
    float wcx = aw[0] + frac_w * aw[3];
    float wcy = aw[1] + frac_w * aw[4];
    float wcz = aw[2] + frac_w * aw[5];
    float wrad = aw[8];
    bool is_quad = aw[9] > 0.5f;
    float inv_rad = 1.0f / (wrad != 0.0f ? wrad : 1.0f);
    float nsx = (px - wcx) * inv_rad;
    float nsy = (py - wcy) * inv_rad;
    float nsz = (pz - wcz) * inv_rad;
    float n_x = is_quad ? wcx : nsx;
    float n_y = is_quad ? wcy : nsy;
    float n_z = is_quad ? wcz : nsz;
    float d_dot_n = dx * n_x + dy * n_y + dz * n_z;
    front = d_dot_n < 0.0f;
    float flip = front ? 1.0f : -1.0f;
    nx = n_x * flip;
    ny = n_y * flip;
    nz = n_z * flip;
    kind = aw[10];
    fuzz = aw[11];
    ior = aw[12];

    // texture value (Texture.h:48-164)
    float tex_kind = aw[13];
    tex[0] = aw[14];
    tex[1] = aw[15];
    tex[2] = aw[16];
    if (!kTextures) {
      // solid colour stands in: only thr / acc read it
    } else if (tex_kind == TEX_CHECKER) {
      float inv_s = aw[20];
      int cx = (int)floorf(inv_s * px);
      int cy = (int)floorf(inv_s * py);
      int cz = (int)floorf(inv_s * pz);
      if (((cx + cy + cz) & 1) != 0) {
        tex[0] = aw[17];
        tex[1] = aw[18];
        tex[2] = aw[19];
      }
    } else if (tex_kind == TEX_NOISE) {
      float nzid = aw[25];
      int table = 0;
      for (int t = 1; t < p.n_noise; ++t)
        if (nzid == (float)t) table = t;
      float turb = perlin_turb(p, table, px, py, pz);
      float marble = 0.5f * (1.0f + sinf(aw[23] * pz + 10.0f * turb));
      tex[0] = marble;
      tex[1] = marble;
      tex[2] = marble;
    } else if (tex_kind == TEX_IMAGE) {
      float img_id = aw[24];
      if (img_id < 0.0f) {                  // missing image: debug cyan
        tex[0] = 0.0f;
        tex[1] = 1.0f;
        tex[2] = 1.0f;
      } else {
        float u_s, v_s;
        if (is_quad) {
          u_s = px * aw[32] + py * aw[33] + pz * aw[34] - aw[35];
          v_s = px * aw[36] + py * aw[37] + pz * aw[38] - aw[39];
        } else {
          float cth = aw[21], sth = aw[22];
          float ox_n = cth * nsx - sth * nsz;
          float oz_n = sth * nsx + cth * nsz;
          float ny_c = clamp_p(-nsy, -1.0f, 1.0f);
          float theta = acos_poly(ny_c);
          float phi = atan2_poly(-oz_n, ox_n) + PI_F;
          u_s = phi * INV_2PI;
          v_s = theta * INV_PI;
        }
        float uu = clamp_p(u_s, 0.0f, 1.0f);
        float vv = 1.0f - clamp_p(v_s, 0.0f, 1.0f);
        tex[0] = 0.0f;
        tex[1] = 0.0f;
        tex[2] = 0.0f;
        for (int i = 0; i < p.n_images; ++i) {
          if (p.n_images > 1 && img_id != (float)i) continue;
          const int* dims = p.img_dims + 3 * i;
          int iw = dims[0], ih = dims[1];
          int ix = min((int)(uu * (float)iw), iw - 1);
          int iy = min((int)(vv * (float)ih), ih - 1);
          int packed = p.texels[(dims[2] + iy) * p.tex_cols + ix];
          tex[0] = (float)((packed >> 16) & 255) * INV255;
          tex[1] = (float)((packed >> 8) & 255) * INV255;
          tex[2] = (float)(packed & 255) * INV255;
        }
      }
    }
  }

  // emission (live lanes only)
  const bool is_light = kind == MAT_DIFFUSE_LIGHT;
  if (is_light) {
    acc[0] = acc[0] + thr[0] * tex[0];
    acc[1] = acc[1] + thr[1] * tex[1];
    acc[2] = acc[2] + thr[2] * tex[2];
    return false;                           // lights do not scatter
  }

  // scatter (SCATTER_STREAM | bounce), Material.h / Metal.h / Dielectric.h
  uint32_t w0 = pix_ctr, w1 = samp, w2 = SCATTER_STREAM | bnc, w3 = 0u;
  pcg4d(w0, w1, w2, w3);
  const float u1 = unit(w0), u2 = unit(w1), u3 = unit(w2), u4 = unit(w3);
  const float zb = 1.0f - 2.0f * u1;
  const float rxy = sqrtf(fabsf(1.0f - zb * zb));
  const float phi_b = TWO_PI * u2;
  const float sb = sinf(phi_b);
  const float cb = cosf(phi_b);
  const float inv_dlen = 1.0f / sqrtf(a);
  const float udx = dx * inv_dlen, udy = dy * inv_dlen, udz = dz * inv_dlen;
  float ndx, ndy, ndz;
  if (kind == MAT_ISOTROPIC) {
    ndx = rxy * cb;
    ndy = rxy * sb;
    ndz = zb;
  } else if (kind == MAT_DIELECTRIC) {
    float ratio = front ? 1.0f / ior : ior;
    float cos_t = fmin_p(-(udx * nx + udy * ny + udz * nz), 1.0f);
    float sin_t = sqrtf(fmax_p(1.0f - cos_t * cos_t, 0.0f));
    bool cannot = ratio * sin_t > 1.0f;
    float r0 = (1.0f - ratio) / (1.0f + ratio);
    r0 = r0 * r0;
    float one_m = 1.0f - cos_t;
    float om2 = one_m * one_m;
    float refl5 = r0 + (1.0f - r0) * om2 * om2 * one_m;
    if (cannot || refl5 > u4) {
      float ddn = udx * nx + udy * ny + udz * nz;
      ndx = udx - 2.0f * ddn * nx;
      ndy = udy - 2.0f * ddn * ny;
      ndz = udz - 2.0f * ddn * nz;
    } else {
      float fx = ratio * (udx + cos_t * nx);
      float fy = ratio * (udy + cos_t * ny);
      float fz = ratio * (udz + cos_t * nz);
      float plen = fabsf(1.0f - (fx * fx + fy * fy + fz * fz));
      float par = -sqrtf(plen);
      ndx = fx + par * nx;
      ndy = fy + par * ny;
      ndz = fz + par * nz;
    }
    tex[0] = 1.0f;                          // dielectrics attenuate by 1
    tex[1] = 1.0f;
    tex[2] = 1.0f;
  } else {
    const float rad_b = powf(u3, ONE_THIRD);
    const float bx = rad_b * rxy * cb;
    const float by = rad_b * rxy * sb;
    const float bz = rad_b * zb;
    if (kind == MAT_METAL) {
      float ddn = udx * nx + udy * ny + udz * nz;
      float rx = udx - 2.0f * ddn * nx;
      float ry = udy - 2.0f * ddn * ny;
      float rz = udz - 2.0f * ddn * nz;
      ndx = rx + fuzz * bx;
      ndy = ry + fuzz * by;
      ndz = rz + fuzz * bz;
      if (!((ndx * nx + ndy * ny + ndz * nz) > 0.0f)) return false;
    } else if (kind == MAT_LAMBERTIAN) {
      ndx = nx + bx;
      ndy = ny + by;
      ndz = nz + bz;
      if (fabsf(ndx) < EPS8 && fabsf(ndy) < EPS8 && fabsf(ndz) < EPS8) {
        ndx = nx;
        ndy = ny;
        ndz = nz;
      }
    } else {
      ndx = udx;
      ndy = udy;
      ndz = udz;
    }
  }

  thr[0] = thr[0] * tex[0];
  thr[1] = thr[1] * tex[1];
  thr[2] = thr[2] * tex[2];
  r.ox = px;
  r.oy = py;
  r.oz = pz;
  r.dx = ndx;
  r.dy = ndy;
  r.dz = ndz;
  return true;
}

}  // namespace mega2
