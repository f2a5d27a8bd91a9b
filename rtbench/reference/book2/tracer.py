"""The reference path tracer for Book 2 worlds (kernel.cu:65-98's
``RayColor`` loop with emission, the hittables' ``Hit`` and the
materials' ``Scatter``), batched over rays in plain PyTorch.

Every ray tests every primitive (no BVH, no cull), in this order: the
spheres (in key space, t * |d|^2, as the Book 1 reference), the loose
quads, the boxes, then the media; a later kind wins only strictly nearer,
and of one kind the first in the world's order wins a tie.  Then the hit
record, the texture, the emission of a light, the scatter and the
throughput.  A path ends on a miss (adding the background times its
throughput), on a light, on an absorbed metal scatter, or after
``max_bounces`` bounces; a pixel's value is the sum of its samples'
radiance in sample order.  The draws: the Book 1 reference's camera and
scatter streams (`../rng.py`), and for medium m at bounce b the first
word of pcg4d(seed ^ pixel, sample, MEDIUM_STREAM | b, m).

Where it departs from kernel.cu (each as the port's plain K1 version
computes it, so that the two agree path for path):

- the scatter draws are counter-based, a point in the unit ball from
  three uniforms where Material.h rejects, the Fresnel draw a fourth;
- a box is tested as one slab (its six faces' planes at once), its face
  the axis whose plane gives the entering t, or from inside the leaving
  one, where MakeBox's list tests six Quad::Hit: the same t at a face,
  and a hit on an edge may round to the neighbouring face;
- a medium's boundary is crossed analytically, both roots of one
  quadratic clamped to [t_min, inf), where ConstantMedium.h:52-94 calls
  the boundary's Hit twice with a 1e-4 step; a medium counts only after
  the geometry and wins where its sampled distance is strictly nearer;
- a medium's hit has the normal (1, 0, 0) and faces the ray;
- an instance's spheres are folded into world space (`world.py`);
- the image texture's sphere coordinates use the port's minimax
  polynomials for acos and atan2, where Texture.h calls the library's;
- a light emits on both faces and never scatters (Material.h:120-128).

``dtype`` is the precision of all float arithmetic: float32 for the
reference, bfloat16 for the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..tracer import BIG, EPS8, HALF_BIG, camera_rays
from .world import (
    DIELECTRIC, DIFFUSE_LIGHT, FACE, IMAGE, ISOTROPIC, LAMBERTIAN, METAL,
    NOISE, SOLID, Image, Noise, World, flatten, perlin_tables,
)

MEDIUM_STREAM = 0x3ED00000
EPS4 = float(np.float32(1.0e-4))
TWO_PI = float(np.float32(2.0 * np.pi))
ONE_THIRD = float(np.float32(1.0 / 3.0))
HALF_PI = float(np.float32(0.5 * np.pi))
PI = float(np.float32(np.pi))
INV_2PI = float(np.float32(0.5 / np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
INV255 = float(np.float32(1.0 / 255.0))
ATAN_COEF = tuple(float(np.float32(c)) for c in (
    -0.0117212, 0.05265332, -0.11643287, 0.19354346, -0.33262347,
    0.99997726))
CHUNK = 1 << 16         # rays a closest-hit pass takes at once


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (f32 through f64, as ``sqrtf``)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


class Tables(NamedTuple):
    """A world's columns on one device, in one dtype.  Surface rows: the
    spheres [0, S), the loose quads [S, S + Q), then six a box (MakeBox's
    faces); medium m is row ``R + m`` of a winner."""
    s_c0: torch.Tensor      # [S, 3]
    s_dc: torch.Tensor      # [S, 3]
    s_t0: torch.Tensor      # [S]
    s_inv_dt: torch.Tensor
    s_rad2: torch.Tensor    # squared in f32
    q_n: torch.Tensor       # [Q, 3] unit normal
    q_d: torch.Tensor       # [Q] n . Q
    q_a: torch.Tensor       # [Q, 3] v x w, with w = n / |n|^2
    q_a0: torch.Tensor      # [Q] Q . (v x w)
    q_b: torch.Tensor       # [Q, 3] w x u
    q_b0: torch.Tensor      # [Q] Q . (w x u)
    b_lo: torch.Tensor      # [B, 3]
    b_hi: torch.Tensor      # [B, 3]
    media: list             # (centre 3, radius^2, -1/density, colour 3)
    # surface rows [R]
    pos: torch.Tensor       # [R, 3] a sphere's centre at t0, a face's normal
    dc: torch.Tensor        # [R, 3]
    t0: torch.Tensor
    inv_dt: torch.Tensor
    rad: torch.Tensor
    is_quad: torch.Tensor   # bool
    kind: torch.Tensor      # material kind
    fuzz: torch.Tensor
    ior: torch.Tensor
    tex: torch.Tensor       # int64 texture kind
    color: torch.Tensor     # [R, 3]
    scale: torch.Tensor     # noise frequency
    image: torch.Tensor     # int64 image id
    noise: torch.Tensor     # int64 noise table id
    uv_cos: torch.Tensor    # the sphere's instance rotation
    uv_sin: torch.Tensor
    images: list            # uint8 [H, W, 3] a distinct image
    perlin: list            # (perm x, y, z int64 [256], gradients [256, 3])

    @property
    def rows(self) -> int:
        return self.pos.shape[0]


def _quad_cols(q, u, v) -> tuple:
    """(n_unit, n . Q, v x w, Q . v x w, w x u, Q . w x u) in f64 of f32
    corners [Q, 3] (Quad.h:22-50)."""
    n = np.cross(u, v)
    n_len = np.linalg.norm(n, axis=-1, keepdims=True)
    n_unit = n / np.where(n_len > 0, n_len, 1.0)
    nn = (n * n).sum(-1, keepdims=True)
    w = n / np.where(nn > 0, nn, 1.0)
    vxw, wxu = np.cross(v, w), np.cross(w, u)
    return (n_unit, (n_unit * q).sum(-1), vxw, (q * vxw).sum(-1), wxu,
            (q * wxu).sum(-1))


def tables(world: World, device, dtype=torch.float32) -> Tables:
    """The world's columns: every value rounded to f32 from its f64 value
    (quad and face planes from the f32 corners; squared radii squared in
    f32), then cast to ``dtype``."""
    fl = flatten(world)
    f32 = lambda x: np.asarray(x, np.float64).astype(np.float32)
    sph, Q, B = fl.spheres, len(fl.quads), len(fl.boxes)
    S = len(sph)
    faces = fl.quads + [q for b in fl.boxes for q in b.quads()]
    F = len(faces)
    planes = _quad_cols(*[f32([getattr(x, k) for x in faces]).reshape(F, 3)
                          .astype(np.float64) for k in "quv"])
    moving = [s.center2 is not None for s in sph]
    rows3 = lambda a, b: np.concatenate([f32(a).reshape(S, 3),
                                         f32(b).reshape(F, 3)])
    rows1 = lambda a: f32(list(a) + [0.0] * F)
    pos = rows3([s.center for s in sph], planes[0])
    dc = rows3([np.subtract(s.center2, s.center) if m else (0.0, 0.0, 0.0)
                for s, m in zip(sph, moving)], np.zeros((F, 3)))
    rad = f32([s.radius for s in sph])

    mats = [s.material for s in sph] + [x.material for x in faces]
    texs = [m.texture for m in mats]
    images = list({id(t): t for t in texs if isinstance(t, Image)}.values())
    seeds = sorted({t.table_seed for t in texs if isinstance(t, Noise)})

    # box slabs: the bottom face's corner Q and its far corner Q + extent
    lo = f32([b.corners()[0] for b in fl.boxes]).reshape(B, 3)
    ext = f32([np.subtract(*b.corners()[::-1]) for b in fl.boxes])
    hi = f32(lo.astype(np.float64) + ext.reshape(B, 3))

    media = []
    for md in fl.media:
        r = float(f32(md.boundary.radius))
        media.append((*f32(md.boundary.center).tolist(), float(f32(r * r)),
                      float(f32(-1.0 / float(md.density))),
                      *f32(md.color).tolist()))

    t = lambda x: torch.as_tensor(f32(x), device=device).to(dtype)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    perlin = []
    for seed in seeds:
        vec, px, py, pz = perlin_tables(seed)
        perlin.append((i64(px), i64(py), i64(pz), t(vec)))
    return Tables(
        s_c0=t(pos[:S]), s_dc=t(dc[:S]), s_t0=t(np.zeros(S)),
        s_inv_dt=t(moving), s_rad2=t(rad * rad),
        q_n=t(planes[0][:Q]), q_d=t(planes[1][:Q]), q_a=t(planes[2][:Q]),
        q_a0=t(planes[3][:Q]), q_b=t(planes[4][:Q]), q_b0=t(planes[5][:Q]),
        b_lo=t(lo), b_hi=t(hi), media=media,
        pos=t(pos), dc=t(dc), t0=t(np.zeros(S + F)),
        inv_dt=t(rows1(moving)), rad=t(rows1(rad)),
        is_quad=torch.arange(S + F, device=device) >= S,
        kind=t([m.kind for m in mats]), fuzz=t([m.fuzz for m in mats]),
        ior=t([m.ior for m in mats]),
        tex=i64([IMAGE if isinstance(x, Image) else NOISE
                 if isinstance(x, Noise) else SOLID for x in texs]),
        color=t([getattr(x, "color", (0.0, 0.0, 0.0)) for x in texs]),
        scale=t([x.scale if isinstance(x, Noise) else 1.0 for x in texs]),
        image=i64([next(i for i, im in enumerate(images) if im is x)
                   if isinstance(x, Image) else -1 for x in texs]),
        noise=i64([seeds.index(x.table_seed) if isinstance(x, Noise) else -1
                   for x in texs]),
        uv_cos=t(rows1(math.cos(s.theta) for s in sph)),
        uv_sin=t(rows1(math.sin(s.theta) for s in sph)),
        images=[torch.as_tensor(im.texels, device=device) for im in images],
        perlin=perlin)


class Frame:
    """One frame's constants: the world's tables on ``device`` in
    ``dtype``, its camera frame, size, bounce cap and shutter."""

    def __init__(self, world: World, width: int, height: int,
                 max_bounces: int, device, dtype=torch.float32,
                 t_min: float = 1.0e-3):
        self.tab = tables(world, device, dtype)
        self.cam = world.camera.frame(float(width) / float(height))
        self.width, self.height = width, height
        self.max_bounces = max_bounces
        self.t_min = float(np.float32(t_min))
        self.device, self.dtype = torch.device(device), dtype
        self.bg = torch.as_tensor(self.cam["background"],
                                  device=device).to(dtype)


def _chunks(n: int):
    for c in range(0, n, CHUNK):
        yield slice(c, min(c + CHUNK, n))


def closest_spheres(tab: Tables, o, d, tm, a, akey):
    """Nearest sphere of each ray in key space: (key or BIG, row or -1)."""
    n = o.shape[0]
    best = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    win = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    if tab.s_c0.shape[0] == 0:
        return best, win
    col = lambda x: x[None, :]
    for s in _chunks(n):
        frac = (tm[s, None] - col(tab.s_t0)) * col(tab.s_inv_dt)
        oc = [o[s, k:k + 1] - (col(tab.s_c0[:, k])
                               + frac * col(tab.s_dc[:, k]))
              for k in range(3)]
        dd = [d[s, k:k + 1] for k in range(3)]
        b = oc[0] * dd[0] + oc[1] * dd[1] + oc[2] * dd[2]
        cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - col(tab.s_rad2)
        disc = b * b - a[s, None] * cc
        sq = _sqrt(disc)
        k1 = -b - sq
        k2 = -b + sq
        ak = akey[s, None]
        key = torch.where(k1 > ak, k1, k2)
        key = torch.where((disc > 0.0) & (key > ak), key, BIG)
        mn, idx = key.min(dim=1)           # the first index of the minimum
        best[s] = mn
        win[s] = torch.where(mn < BIG, idx, -1)
    return best, win


def quad_t(o, d, n, dd, qa, qa0, qb, qb0, t_min: float):
    """t or BIG of rays on quads (Quad.h:52-83), elementwise over
    broadcast shapes: ``o``, ``d``, the normal ``n`` and the planes
    ``qa`` (v x w) and ``qb`` (w x u) are three components each."""
    denom = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
    den_ok = torch.abs(denom) >= EPS8
    t_c = (dd - (o[0] * n[0] + o[1] * n[1] + o[2] * n[2])) / \
        torch.where(den_ok, denom, 1.0)
    p = [o[k] + t_c * d[k] for k in range(3)]
    alpha = p[0] * qa[0] + p[1] * qa[1] + p[2] * qa[2] - qa0
    beta = p[0] * qb[0] + p[1] * qb[1] + p[2] * qb[2] - qb0
    ok = (den_ok & (t_c >= t_min) & (alpha >= 0.0) & (alpha <= 1.0)
          & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(ok, t_c, BIG)


def _cols(x: torch.Tensor) -> list:
    """The three components of rays [N, 3], each [N, 1]."""
    return [x[:, k:k + 1] for k in range(3)]


def _rows(x: torch.Tensor) -> list:
    """The three components of primitives [P, 3], each [1, P]."""
    return [x[None, :, k] for k in range(3)]


def closest_quads(tab: Tables, o, d, t_min: float, best, win):
    """Loose quads, strict < against ``best`` (t)."""
    if tab.q_n.shape[0] == 0:
        return best, win
    mn, idx = quad_t(_cols(o), _cols(d), _rows(tab.q_n), tab.q_d[None, :],
                     _rows(tab.q_a), tab.q_a0[None, :], _rows(tab.q_b),
                     tab.q_b0[None, :], t_min).min(dim=1)
    better = mn < best
    return (torch.where(better, mn, best),
            torch.where(better, tab.s_c0.shape[0] + idx, win))


def box_hits(lo, hi, o, d, t_min: float):
    """Slab hits of rays on boxes, elementwise over broadcast shapes (each
    argument three components): (t or BIG, face 0-5), the face by
    `world.FACE` from the first axis whose plane gives the entering t
    (from inside, the leaving t)."""
    nears, fars, sides = [], [], []
    for ax in range(3):
        o_a, d_a = o[ax], d[ax]
        d_ok = torch.abs(d_a) >= EPS8
        dsafe = torch.where(d_ok, d_a, 1.0)
        t1 = (lo[ax] - o_a) / dsafe
        t2 = (hi[ax] - o_a) / dsafe
        inside = (o_a >= lo[ax]) & (o_a <= hi[ax])
        nears.append(torch.where(d_ok, torch.minimum(t1, t2),
                                 torch.where(inside, -BIG, BIG)))
        fars.append(torch.where(d_ok, torch.maximum(t1, t2),
                                torch.where(inside, BIG, -BIG)))
        sides.append(d_a > 0.0)
    t_enter = torch.maximum(torch.maximum(nears[0], nears[1]), nears[2])
    t_exit = torch.minimum(torch.minimum(fars[0], fars[1]), fars[2])
    use_enter = t_enter >= t_min
    t_box = torch.where(use_enter, t_enter, t_exit)
    valid = (t_enter <= t_exit) & (t_box >= t_min)
    off_e = torch.zeros_like(t_box, dtype=torch.int64)
    off_x = torch.zeros_like(off_e)
    seen_e = torch.zeros_like(valid)
    seen_x = torch.zeros_like(valid)
    for ax in range(3):
        mn_f, mx_f = FACE[ax]
        oe = torch.where(sides[ax], mn_f, mx_f)
        oxx = torch.where(sides[ax], mx_f, mn_f)
        hit_e = nears[ax] == t_enter
        hit_x = fars[ax] == t_exit
        off_e = torch.where(~seen_e & hit_e, oe, off_e)
        off_x = torch.where(~seen_x & hit_x, oxx, off_x)
        seen_e = seen_e | hit_e
        seen_x = seen_x | hit_x
    return (torch.where(valid, t_box, BIG),
            torch.where(use_enter, off_e, off_x))


def closest_boxes(tab: Tables, o, d, t_min: float, best, win):
    """Boxes, strict < against ``best``; the winner is the face's row
    (``best`` and ``win`` updated in place)."""
    B = tab.b_lo.shape[0]
    if B == 0:
        return best, win
    base = tab.s_c0.shape[0] + tab.q_n.shape[0]
    for s in _chunks(o.shape[0]):
        t_box, face = box_hits(_rows(tab.b_lo), _rows(tab.b_hi),
                               _cols(o[s]), _cols(d[s]), t_min)
        mn, idx = t_box.min(dim=1)
        row = base + 6 * idx + face.gather(1, idx[:, None])[:, 0]
        better = mn < best[s]
        best[s] = torch.where(better, mn, best[s])
        win[s] = torch.where(better, row, win[s])
    return best, win


def medium_draw(pix_ctr, samp, bounce, m: int, dtype):
    """The uniform in (0, 1] of medium ``m`` at ``bounce`` (an int, or
    int32 [N])."""
    stream = torch.full_like(pix_ctr, rng.to_word(MEDIUM_STREAM | bounce)) \
        if isinstance(bounce, int) else bounce.to(torch.int32) | MEDIUM_STREAM
    w = rng.pcg4d(pix_ctr, samp, stream, torch.full_like(pix_ctr, m))[0]
    return rng.unit(w, dtype) + rng.INV_2POW24


def medium_hit(row: tuple, o, d, a, inv_a, t_min: float, u_m):
    """(sampled t, valid) of rays in the medium ``row`` of `Tables.media`:
    the boundary's two roots, the entry clamped to [t_min, inf) and 0,
    the scatter distance ``-log(u) / density`` along the ray."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    ocx, ocy, ocz = ox - row[0], oy - row[1], oz - row[2]
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - row[3]
    disc = b * b - a * cc
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    valid = (disc > 0.0) & (t1 > t0 + EPS4)
    t0c = torch.maximum(torch.maximum(t0, torch.full_like(t0, t_min)),
                        torch.zeros_like(t0))
    valid = valid & (t0c < t1)
    ray_len = _sqrt(a)
    dist_in = (t1 - t0c) * ray_len
    hit_d = row[4] * torch.log(u_m)
    valid = valid & (hit_d <= dist_in)
    return t0c + hit_d / ray_len, valid


def media(tab: Tables, fr: Frame, o, d, a, inv_a, pix_ctr, samp,
          bounce: int, best, win):
    """Media after the geometry, in order, each winning strictly nearer:
    (best, win, is_medium, albedo [N, 3])."""
    n = o.shape[0]
    is_med = torch.zeros(n, dtype=torch.bool, device=o.device)
    alb = torch.zeros((n, 3), dtype=fr.dtype, device=o.device)
    for m, row in enumerate(tab.media):
        u_m = medium_draw(pix_ctr, samp, bounce, m, fr.dtype)
        t_m, valid = medium_hit(row, o, d, a, inv_a, fr.t_min, u_m)
        mwin = valid & (t_m < best)
        best = torch.where(mwin, t_m, best)
        is_med = is_med | mwin
        win = torch.where(mwin, tab.rows + m, win)
        alb = torch.where(mwin[:, None], torch.tensor(
            row[5:8], dtype=fr.dtype, device=o.device), alb)
    return best, win, is_med, alb


def _perlin_noise(perlin, qx, qy, qz):
    """Lattice gradient noise (Perlin.h:38-60)."""
    px, py, pz, vec = perlin
    vx, vy, vz = vec[:, 0], vec[:, 1], vec[:, 2]
    fx, fy, fz = torch.floor(qx), torch.floor(qy), torch.floor(qz)
    ux, uy, uz = qx - fx, qy - fy, qz - fz
    i, j, k = fx.to(torch.int64), fy.to(torch.int64), fz.to(torch.int64)
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    pa = [px[(i + dd) & 255] for dd in (0, 1)]
    pb = [py[(j + dd) & 255] for dd in (0, 1)]
    pc = [pz[(k + dd) & 255] for dd in (0, 1)]
    accum = torch.zeros_like(qx)
    for di in (0, 1):
        wu = sx if di else (1.0 - sx)
        for dj in (0, 1):
            wv = sy if dj else (1.0 - sy)
            for dk in (0, 1):
                ww = sz if dk else (1.0 - sz)
                h = pa[di] ^ pb[dj] ^ pc[dk]
                dot = (vx[h] * (ux - di) + vy[h] * (uy - dj)
                       + vz[h] * (uz - dk))
                accum = accum + wu * wv * ww * dot
    return accum


def perlin_turb(perlin, qx, qy, qz, depth: int = 7):
    """|sum_i 0.5^i noise(2^i p)| (Perlin.h:64-78)."""
    accum = torch.zeros_like(qx)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * _perlin_noise(perlin, qx, qy, qz)
        weight *= 0.5
        qx, qy, qz = qx * 2.0, qy * 2.0, qz * 2.0
    return torch.abs(accum)


def _atan2_poly(y, x):
    ax, ay = torch.abs(x), torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    r = num / torch.where(den > 0.0, den, 1.0)
    z2 = r * r
    p = torch.full_like(r, ATAN_COEF[0])
    for c in ATAN_COEF[1:]:
        p = p * z2 + c
    a = r * p
    a = torch.where(swap, HALF_PI - a, a)
    a = torch.where(x < 0.0, PI - a, a)
    a = torch.where(y < 0.0, -a, a)
    return torch.where((ax + ay) == 0.0, 0.0, a)


def image_value(tab: Tables, rows, ns):
    """Nearest texel (Texture.h:117-127) of sphere hits with the outward
    normal ``ns`` [n, 3]: (u, v) from the normal turned back by the
    sphere's rotation, u clamped, v flipped."""
    nsx, nsy, nsz = ns.unbind(1)
    cth, sth = tab.uv_cos[rows], tab.uv_sin[rows]
    ox_n = cth * nsx - sth * nsz
    oz_n = sth * nsx + cth * nsz
    ny_c = torch.clamp(-nsy, -1.0, 1.0)
    theta = _atan2_poly(_sqrt(torch.clamp_min(1.0 - ny_c * ny_c, 0.0)),
                        ny_c)
    phi = _atan2_poly(-oz_n, ox_n) + PI
    uu = torch.clamp(phi * INV_2PI, 0.0, 1.0)
    vv = 1.0 - torch.clamp(theta * INV_PI, 0.0, 1.0)
    out = torch.zeros_like(ns)
    img = tab.image[rows]
    for i, tx in enumerate(tab.images):
        ih, iw = tx.shape[0], tx.shape[1]
        ix = torch.clamp_max((uu * float(iw)).to(torch.int64), iw - 1)
        iy = torch.clamp_max((vv * float(ih)).to(torch.int64), ih - 1)
        c = (tx[iy, ix].to(torch.float32) * INV255).to(ns.dtype)
        out = torch.where((img == i)[:, None], c, out)
    return out


def scatter(kind, fuzz, ior, front, is_light, n, d, a, u1, u2, u3, u4):
    """New direction and the scattered flag of the five materials
    (Material.h, Metal.h, Dielectric.h): a point in the unit ball from
    (u1, u2, u3) and the direction it is built from (the isotropic
    phase), the Fresnel draw u4."""
    zb = 1.0 - 2.0 * u1
    rxy = _sqrt(torch.abs(1.0 - zb * zb))
    phi = TWO_PI * u2
    sb, cb = torch.sin(phi), torch.cos(phi)
    rad_b = torch.pow(u3, ONE_THIRD)
    bx, by, bz = rad_b * rxy * cb, rad_b * rxy * sb, rad_b * zb
    nx, ny, nz = n.unbind(1)
    inv_dlen = 1.0 / _sqrt(a)
    udx, udy, udz = (d[:, k] * inv_dlen for k in range(3))

    lx, ly, lz = nx + bx, ny + by, nz + bz
    near0 = (torch.abs(lx) < EPS8) & (torch.abs(ly) < EPS8) \
        & (torch.abs(lz) < EPS8)
    lx = torch.where(near0, nx, lx)
    ly = torch.where(near0, ny, ly)
    lz = torch.where(near0, nz, lz)

    ddn = udx * nx + udy * ny + udz * nz
    rx = udx - 2.0 * ddn * nx
    ry = udy - 2.0 * ddn * ny
    rz = udz - 2.0 * ddn * nz
    mx, my, mz = rx + fuzz * bx, ry + fuzz * by, rz + fuzz * bz
    metal_ok = (mx * nx + my * ny + mz * nz) > 0.0

    ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(-(udx * nx + udy * ny + udz * nz), 1.0)
    sin_t = _sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_m = 1.0 - cos_t
    om2 = one_m * one_m
    do_refl = cannot | (r0 + (1.0 - r0) * om2 * om2 * one_m > u4)
    fx = ratio * (udx + cos_t * nx)
    fy = ratio * (udy + cos_t * ny)
    fz = ratio * (udz + cos_t * nz)
    par = -_sqrt(torch.abs(1.0 - (fx * fx + fy * fy + fz * fz)))

    is_l = kind == float(LAMBERTIAN)
    is_m = kind == float(METAL)
    is_d = kind == float(DIELECTRIC)
    is_i = kind == float(ISOTROPIC)
    new = torch.stack([udx, udy, udz], dim=1)
    new = torch.where(is_l[:, None], torch.stack([lx, ly, lz], 1), new)
    new = torch.where(is_m[:, None], torch.stack([mx, my, mz], 1), new)
    new = torch.where(is_d[:, None], torch.where(
        do_refl[:, None], torch.stack([rx, ry, rz], 1),
        torch.stack([fx + par * nx, fy + par * ny, fz + par * nz], 1)), new)
    new = torch.where(is_i[:, None], torch.stack([rxy * cb, rxy * sb, zb],
                                                 1), new)
    return new, (is_m & metal_ok) | (~is_m & ~is_light)


def closest(fr: Frame, o, d, tm, pix_ctr, samp, bounce: int):
    """Each ray's nearest hit over every primitive: (a, 1 / a, t or BIG,
    winner row or -1, hit a medium, the medium's albedo)."""
    tab = fr.tab
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    inv_a = 1.0 / a
    best, win = closest_spheres(tab, o, d, tm, a, fr.t_min * a)
    best = torch.where(best < HALF_BIG, best * inv_a, BIG)
    best, win = closest_quads(tab, o, d, fr.t_min, best, win)
    best, win = closest_boxes(tab, o, d, fr.t_min, best, win)
    best, win, is_med, alb = media(tab, fr, o, d, a, inv_a, pix_ctr, samp,
                                   bounce, best, win)
    return a, inv_a, best, win, is_med, alb


def _bounce(fr: Frame, o, d, tm, thr, acc, pix_ctr, samp, bounce: int):
    """One bounce of live rays: (origin, direction, throughput, radiance,
    alive)."""
    tab = fr.tab
    a, _, best, win, is_med, alb = closest(fr, o, d, tm, pix_ctr, samp,
                                           bounce)
    hit = best < HALF_BIG
    acc = acc + torch.where((~hit)[:, None], thr * fr.bg, 0.0)

    geo = (win >= 0) & (win < tab.rows)
    w = win.clamp(0, tab.rows - 1)

    def at(x):
        v = x[w]
        return torch.where(geo.view(-1, *([1] * (v.dim() - 1))), v,
                           torch.zeros((), dtype=v.dtype, device=v.device))
    frac = (tm - at(tab.t0)) * at(tab.inv_dt)
    wc = at(tab.pos) + frac[:, None] * at(tab.dc)
    wrad = at(tab.rad)
    is_quad = at(tab.is_quad) & ~is_med
    p = o + best[:, None] * d
    ns = (p - wc) * (1.0 / torch.where(wrad != 0.0, wrad, 1.0))[:, None]
    n_out = torch.where(is_quad[:, None], wc, ns)
    n_out = torch.where(is_med[:, None], torch.tensor(
        [1.0, 0.0, 0.0], dtype=fr.dtype, device=o.device), n_out)
    front = ((d[:, 0] * n_out[:, 0] + d[:, 1] * n_out[:, 1]
              + d[:, 2] * n_out[:, 2]) < 0.0) | is_med
    nrm = n_out * torch.where(front, 1.0, -1.0).to(fr.dtype)[:, None]

    tex = at(tab.color)
    tkind = at(tab.tex)
    is_nz = hit & (tkind == NOISE)
    if bool(is_nz.any()):
        sel = is_nz.nonzero()[:, 0]
        ps, table = p[sel], tab.noise[w[sel]]
        turb = torch.zeros_like(ps[:, 0])
        for i, perlin in enumerate(tab.perlin):
            turb = torch.where(table == i, perlin_turb(
                perlin, ps[:, 0], ps[:, 1], ps[:, 2]), turb)
        marble = 0.5 * (1.0 + torch.sin(tab.scale[w[sel]] * ps[:, 2]
                                        + 10.0 * turb))
        tex = tex.index_put((sel,), marble[:, None].expand(-1, 3))
    is_im = hit & (tkind == IMAGE)
    if bool(is_im.any()):
        sel = is_im.nonzero()[:, 0]
        tex = tex.index_put((sel,), image_value(tab, w[sel], ns[sel]))
    tex = torch.where(is_med[:, None], alb, tex)

    kind = torch.where(is_med, float(ISOTROPIC), at(tab.kind))
    is_light = kind == float(DIFFUSE_LIGHT)
    acc = acc + torch.where((hit & is_light)[:, None], thr * tex, 0.0)

    u1, u2, u3, u4 = (rng.unit(x, fr.dtype) for x in rng.pcg4d(
        pix_ctr, samp, torch.full_like(pix_ctr, rng.to_word(
            rng.SCATTER_STREAM | bounce)), torch.zeros_like(pix_ctr)))
    new_d, scattered = scatter(kind, at(tab.fuzz), at(tab.ior), front,
                               is_light, nrm, d, a, u1, u2, u3, u4)
    att = torch.where((kind == float(DIELECTRIC))[:, None], 1.0, tex)
    alive = hit & scattered
    thr = torch.where(alive[:, None], thr * att, thr)
    return p, new_d, thr, acc, alive


def trace_lanes(fr: Frame, pix: torch.Tensor, samp: torch.Tensor, seed,
                chunk: int = 1 << 18, visit=None):
    """Paths of the lanes (pixel ``pix`` [L], sample ``samp`` [L]) with
    the sample-stream seed ``seed`` (an int, or int32 words [L]), ``chunk``
    lanes at a time, dead paths dropped after each bounce: (radiance
    [L, 3], bounces run [L] int64).  ``visit(lanes, o, d, tm, pix_ctr,
    samp, bounce)``, if given, sees each bounce's rays before it runs."""
    L, dev = pix.shape[0], pix.device
    out = torch.zeros((L, 3), dtype=fr.dtype, device=dev)
    nb = torch.zeros(L, dtype=torch.int64, device=dev)
    for c0 in range(0, L, chunk):
        c1 = min(c0 + chunk, L)
        key = seed if isinstance(seed, int) else seed[c0:c1]
        o, d, tm, pix_ctr = camera_rays(fr, pix[c0:c1], samp[c0:c1], key)
        s = samp[c0:c1].to(torch.int32)
        thr = torch.ones_like(o)
        acc = torch.zeros_like(o)
        live = torch.arange(c0, c1, device=dev)
        for b in range(max(fr.max_bounces, 1)):
            if visit is not None:
                visit(live, o, d, tm, pix_ctr, s, b)
            o, d, thr, acc, alive = _bounce(fr, o, d, tm, thr, acc,
                                            pix_ctr, s, b)
            nb[live] += 1
            if b + 1 >= fr.max_bounces:
                alive = torch.zeros_like(alive)
            out[live[~alive]] = acc[~alive]
            keep = alive.nonzero()[:, 0]
            if keep.numel() == 0:
                break
            live = live[keep]
            o, d, tm, thr, acc = o[keep], d[keep], tm[keep], thr[keep], \
                acc[keep]
            pix_ctr, s = pix_ctr[keep], s[keep]
    return out, nb


def radiance(fr: Frame, pix: torch.Tensor, seeds, spp: int,
             chunk: int = 1 << 18, visit=None):
    """(radiance summed over samples 0 .. spp-1 in order [F, P, 3] in the
    frame's dtype, bounces run [F, P]) of pixel ids ``pix`` [P] in each
    of F frames, frame f with the sample-stream seed ``seeds[f]``; for
    ``visit`` see `trace_lanes`."""
    F, P, dev = len(seeds), pix.shape[0], pix.device
    words = torch.tensor([rng.to_word(int(x)) for x in seeds],
                         dtype=torch.int32, device=dev)
    lane_seed = words.repeat_interleave(spp * P)
    lane_samp = torch.arange(spp, device=dev).repeat_interleave(P).repeat(F)
    out, nb = trace_lanes(fr, pix.repeat(F * spp), lane_samp, lane_seed,
                          chunk, visit)
    out = out.view(F, spp, P, 3)
    sums = torch.zeros((F, P, 3), dtype=fr.dtype, device=dev)
    for k in range(spp):
        sums = sums + out[:, k]
    return sums, nb.view(F, spp, P).sum(1)
