"""The ``mega`` engine: table packer, the K-bounce pool kernel K5, its plain
version, and the pool-refill frame loop.

K5 (``csrc/mega_bounces.cu``) replaces the Pallas kernel
``raytracinginoneweekendincuda_tpu/ops/mega.py::_make_kernel``.  It
advances every ray of a pool ``K`` bounces: closest hit over all spheres
and quads (the pair tests of K6, ``csrc/xla_pair.cuh``), the winner's
attribute row, constant media with their ``MEDIUM_STREAM`` draw, miss ->
background, the solid / checker texture, emission, the five materials'
scatter on ``SCATTER_STREAM``, and the throughput / liveness update.  One
thread per ray; the ray state stays in registers for the K bounces.  What
bounds it on an H100: FP32 ALU work in the pair loop (every bounce tests
every active sphere and quad), not memory -- a ray's state is 68 bytes in
and out per call, and the tables stay in L2.  On the TPU the winner's
attributes came from a one-hot MXU contraction; here it is an indexed load
(a miss reads zeros, the row the one-hot produced), and the media, which
the Pallas kernel bakes in as constants, are a runtime table.

`mega_bounces_plain` is the kernel body in PyTorch, in the same op order.
`mega_bounces` dispatches by device: plain on the CPU, K5 on CUDA, no
fallback.  `render_mega_frame` is the frame loop: scatter finished paths
into the framebuffer, refill finished lanes with the next (pixel, sample)
work items, run K5; one host sync per iteration for the loop condition.
Perlin and image textures are not in K5: `render` sends those scenes to
``wavefront_pallas``, as the JAX package does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.samplers import ONE_THIRD, TWO_PI, sqrt_f32
from ..scene.compiler import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_METAL, MED_BOX, TEX_CHECKER, SceneArrays, SceneMeta,
)
from ..utils.config import RenderConfig
from .pallas_hit import EPS8, closest_rows
from .raygen import camera_tuple, generate_rays

LANES = 128
HALF_BIG = float(np.float32(1.0e30 * 0.5))
EPS4 = float(np.float32(1.0e-4))
MEGA_K = 2         # bounces per kernel call (the JAX package's choice)
MEGA_POOL = 8192   # ray-pool size (the JAX package's choice)

# ---- primitive table rows (materials denormalized)
#      sphere: c0(3) dc(3) t0 inv_dt rad cos sin active 0 | mat(11)
#      quad:   n_unit(3) d_plane vxw(3) q_vxw wxu(3) q_wxu active | mat(11)
#      mat(11): kind fuzz ior tex_kind c0(3) c1(3) inv_scale
SPH_MAT0 = 13
QUAD_MAT0 = 13
MAT_COLS = 11
SPH_ROWS = SPH_MAT0 + MAT_COLS        # 24
QUAD_ROWS = QUAD_MAT0 + MAT_COLS      # 24
SPH_ACTIVE = 11
QUAD_ACTIVE = 12
ATTR_COLS = 10 + MAT_COLS             # 0:3 c0|n_unit, 3:6 dc, 6 t0,
                                      # 7 inv_dt, 8 rad, 9 is_quad, 10: mat
MED_COLS = 22      # 0 kind, 1:4 center, 4 radius, 5:8 bmin, 8:11 bmax,
                   # 11 cos, 12 sin, 13 -1/density, 14 0, 15 radius^2
                   # (squared in f64, as the Pallas kernel squares its
                   # python-float radius), 16:19 offset, 19:22 albedo
RF_ROWS = 13       # o(3) d(3) time thr(3) acc(3)
RI_ROWS = 4        # pix_ctr samp bounce active


class MegaTables(NamedTuple):
    sph: torch.Tensor    # [24, S_pad] f32
    quad: torch.Tensor   # [24, Q_pad] f32
    attr: torch.Tensor   # [S_pad + Q_pad, 21] f32
    med: torch.Tensor    # [max(M, 1), 22] f32
    med_rows: tuple      # the media rows as python floats (plain version)
    n_media: int


def _mat_cols(scene: SceneArrays, mat_ids: np.ndarray) -> np.ndarray:
    """[n, MAT_COLS] material + texture parameters for the given mat ids."""
    s = scene
    tid = np.clip(np.asarray(s.mat_tex)[mat_ids], 0, s.tex_kind.shape[0] - 1)
    f = lambda a: np.asarray(a, np.float64)
    return np.stack([
        f(s.mat_kind)[mat_ids], f(s.mat_fuzz)[mat_ids], f(s.mat_ior)[mat_ids],
        f(s.tex_kind)[tid],
        *[f(s.tex_c0)[tid][:, i] for i in range(3)],
        *[f(s.tex_c1)[tid][:, i] for i in range(3)],
        f(s.tex_inv_scale)[tid]], axis=1)


def pack_mega_tables(scene: SceneArrays, meta: SceneMeta,
                     device="cuda") -> MegaTables:
    """Host-side packing (the JAX package's ``pack_mega_tables``, plus
    the medium radius^2 column) -> `MegaTables` on ``device``."""
    from .render import resolve_device

    dev = resolve_device(device)
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]
    f = lambda a: np.asarray(a, np.float64)
    sph = np.zeros((SPH_ROWS, S), np.float64)
    sph[0:3] = f(scene.sph_c0).T
    sph[3:6] = f(scene.sph_dc).T
    sph[6] = f(scene.sph_t0)
    sph[7] = f(scene.sph_inv_dt)
    sph[8] = f(scene.sph_rad)
    sph[9] = f(scene.sph_cos)
    sph[10] = f(scene.sph_sin)
    sph[11] = f(scene.sph_active)
    sph[SPH_MAT0:] = _mat_cols(scene, np.asarray(scene.sph_mat)).T

    # the quad's derived frame in f64 (Quad.h:31-37)
    u, v, qq = f(scene.quad_u), f(scene.quad_v), f(scene.quad_q)
    n = np.cross(u, v)
    n_len = np.linalg.norm(n, axis=-1, keepdims=True)
    n_unit = n / np.where(n_len > 0, n_len, 1.0)
    nn = (n * n).sum(-1, keepdims=True)
    w_vec = n / np.where(nn > 0, nn, 1.0)
    vxw = np.cross(v, w_vec)
    wxu = np.cross(w_vec, u)
    quad = np.zeros((QUAD_ROWS, Q), np.float64)
    quad[0:3] = n_unit.T
    quad[3] = (n_unit * qq).sum(-1)
    quad[4:7] = vxw.T
    quad[7] = (qq * vxw).sum(-1)
    quad[8:11] = wxu.T
    quad[11] = (qq * wxu).sum(-1)
    quad[12] = f(scene.quad_active)
    quad[QUAD_MAT0:] = _mat_cols(scene, np.asarray(scene.quad_mat)).T

    pad = lambda a: np.pad(
        a, [(0, 0), (0, -(-a.shape[1] // LANES) * LANES - a.shape[1])])
    sph = pad(sph)
    quad = pad(quad)

    S_pad, Q_pad = sph.shape[1], quad.shape[1]
    attr = np.zeros((S_pad + Q_pad, ATTR_COLS), np.float64)
    attr[:S_pad, 0:9] = sph[0:9].T
    attr[:S_pad, 10:] = sph[SPH_MAT0:].T
    attr[S_pad:, 0:3] = quad[0:3].T
    attr[S_pad:, 9] = 1.0
    attr[S_pad:, 10:] = quad[QUAD_MAT0:].T

    M = max(meta.n_media, 1)
    med = np.zeros((M, MED_COLS), np.float64)
    med[:, 0] = scene.med_kind
    med[:, 1:4] = scene.med_center
    med[:, 4] = scene.med_radius
    med[:, 5:8] = scene.med_bmin
    med[:, 8:11] = scene.med_bmax
    med[:, 11] = scene.med_cos
    med[:, 12] = scene.med_sin
    med[:, 13] = scene.med_nid
    med[:, 16:19] = scene.med_off
    mtid = np.clip(np.asarray(scene.mat_tex)[np.asarray(scene.med_mat)], 0,
                   scene.tex_kind.shape[0] - 1)
    med[:, 19:22] = f(scene.tex_c0)[mtid]     # isotropic albedo (solid)
    med = med.astype(np.float32)
    rows = tuple(tuple(float(x) for x in r) for r in med)
    r4 = med[:, 4].astype(np.float64)
    med[:, 15] = (r4 * r4).astype(np.float32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    return MegaTables(sph=t(sph), quad=t(quad), attr=t(attr), med=t(med),
                      med_rows=rows, n_media=meta.n_media)


def mega_supported(meta: SceneMeta) -> bool:
    return not (meta.has_noise or meta.has_image)


# --------------------------------------------------------------------------
# the plain version of K5


def _medium(r, ox, oy, oz, dx, dy, dz, a, t_min, u_m):
    """(valid, t) of one medium row ``r`` (python floats) for every ray."""
    if int(r[0]) == MED_BOX:
        c2, s2 = r[11], r[12]
        pox, poy, poz = ox - r[16], oy - r[17], oz - r[18]
        o1 = c2 * pox - s2 * poz
        o2 = poy
        o3 = s2 * pox + c2 * poz
        e1 = c2 * dx - s2 * dz
        e2 = dy
        e3 = s2 * dx + c2 * dz
        iv1, iv2, iv3 = 1.0 / e1, 1.0 / e2, 1.0 / e3
        ta1, tb1 = (r[5] - o1) * iv1, (r[8] - o1) * iv1
        ta2, tb2 = (r[6] - o2) * iv2, (r[9] - o2) * iv2
        ta3, tb3 = (r[7] - o3) * iv3, (r[10] - o3) * iv3
        t0 = torch.maximum(torch.maximum(torch.minimum(ta1, tb1),
                                         torch.minimum(ta2, tb2)),
                           torch.minimum(ta3, tb3))
        t1 = torch.minimum(torch.minimum(torch.maximum(ta1, tb1),
                                         torch.maximum(ta2, tb2)),
                           torch.maximum(ta3, tb3))
        valid = t1 > t0
    else:
        ocx, ocy, ocz = ox - r[1], oy - r[2], oz - r[3]
        b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r[4] * r[4]
        disc = b * b - a * cc
        sq = sqrt_f32(torch.clamp_min(disc, 0.0))
        t0 = (-b - sq) / a
        t1 = (-b + sq) / a
        valid = disc > 0.0
    valid = valid & (t1 > t0 + EPS4)
    t0c = torch.clamp_min(torch.clamp_min(t0, t_min), 0.0)
    valid = valid & (t0c < t1)
    ray_len = sqrt_f32(a)
    dist_in = (t1 - t0c) * ray_len
    hit_d = r[13] * torch.log(u_m)
    valid = valid & (hit_d <= dist_in)
    return valid, t0c + hit_d / ray_len


def _bounce(tabs: MegaTables, st: dict, pix_ctr, samp, *, t_min: float,
            max_bounces: int, bg):
    """One bounce of every lane of the state ``st`` (updated in place)."""
    ox, oy, oz, dx, dy, dz = (st[k] for k in ("ox", "oy", "oz", "dx", "dy",
                                              "dz"))
    tmv, bounce, active = st["tm"], st["bounce"], st["active"]
    a = dx * dx + dy * dy + dz * dz
    t_best, win = closest_rows(torch.stack([ox, oy, oz], 1),
                               torch.stack([dx, dy, dz], 1), tmv, tabs.sph,
                               tabs.quad, t_min, SPH_ACTIVE, QUAD_ACTIVE)
    # the winner's attribute row; a miss reads zeros (the one-hot's row)
    win = win.to(torch.int64)
    aw = torch.where((win >= 0)[:, None], tabs.attr[win.clamp_min(0)], 0.0)
    acol = lambda i: aw[:, i]
    frac_w = (tmv - acol(6)) * acol(7)
    wcx = acol(0) + frac_w * acol(3)          # center(t) | n_unit
    wcy = acol(1) + frac_w * acol(4)
    wcz = acol(2) + frac_w * acol(5)
    wrad = acol(8)
    is_quad = acol(9) > 0.5
    mat = [acol(10 + m) for m in range(MAT_COLS)]

    # ---- stochastic media (ConstantMedium.h)
    stream = rng.to_word(rng.MEDIUM_STREAM) | bounce
    is_med = torch.zeros_like(active)
    med_alb = [torch.zeros_like(ox) for _ in range(3)]
    for m in range(tabs.n_media):
        r = tabs.med_rows[m]
        w0 = rng.pcg4d(pix_ctr, samp, stream, torch.full_like(pix_ctr, m))[0]
        u_m = rng.unit(w0) + rng.INV_2POW24               # (0, 1]
        valid, t_m = _medium(r, ox, oy, oz, dx, dy, dz, a, t_min, u_m)
        w = valid & (t_m < t_best)
        t_best = torch.where(w, t_m, t_best)
        is_med = is_med | w
        is_quad = is_quad & ~w
        for i in range(3):
            med_alb[i] = torch.where(w, r[19 + i], med_alb[i])
        mat[0] = torch.where(w, float(MAT_ISOTROPIC), mat[0])

    hit = t_best < HALF_BIG

    # ---- miss -> background (kernel.cu:74-79)
    miss = active & ~hit
    acc = [st["acc"][i] + torch.where(miss, st["thr"][i] * bg[i], 0.0)
           for i in range(3)]
    alive = active & hit

    # ---- record
    px = ox + t_best * dx
    py = oy + t_best * dy
    pz = oz + t_best * dz
    inv_rad = 1.0 / torch.where(wrad != 0.0, wrad, 1.0)
    n_out = [torch.where(is_quad, wc, (pc - wc) * inv_rad)
             for wc, pc in ((wcx, px), (wcy, py), (wcz, pz))]
    n_out = [torch.where(is_med, v, n) for v, n in zip((1.0, 0.0, 0.0),
                                                        n_out)]
    d_dot_n = dx * n_out[0] + dy * n_out[1] + dz * n_out[2]
    front = (d_dot_n < 0.0) | is_med
    flip = torch.where(front | is_med, 1.0, -1.0)
    nx_, ny_, nz_ = (n * flip for n in n_out)

    # ---- texture value (solid | checker), media: albedo
    cell = [torch.floor(mat[10] * pc).to(torch.int32) for pc in (px, py, pz)]
    even = ((cell[0] + cell[1] + cell[2]) & 1) == 0
    is_ck = mat[3] == float(TEX_CHECKER)
    tex = [torch.where(is_ck, torch.where(even, mat[4 + i], mat[7 + i]),
                       mat[4 + i]) for i in range(3)]
    if tabs.n_media > 0:
        tex = [torch.where(is_med, med_alb[i], tex[i]) for i in range(3)]

    kind, fuzz, ior = mat[0], mat[1], mat[2]
    is_light = kind == float(MAT_DIFFUSE_LIGHT)
    acc = [acc[i] + torch.where(alive & is_light, st["thr"][i] * tex[i], 0.0)
           for i in range(3)]

    # ---- scatter (SCATTER_STREAM | bounce)
    w = rng.pcg4d(pix_ctr, samp, rng.to_word(rng.SCATTER_STREAM) | bounce,
                  torch.zeros_like(pix_ctr))
    u1, u2, u3, u4 = (rng.unit(x) for x in w)
    # ``** 0.5`` in the Pallas kernel: a correctly rounded sqrt here and in
    # K5 (XLA's CPU pow(x, 0.5) agrees with it to an ulp; torch.pow(x, 0.5)
    # is itself a sqrt).  ``u3 ** (1/3)`` stays pow, in both.
    zb = 1.0 - 2.0 * u1
    rxy = sqrt_f32(torch.abs(1.0 - zb * zb))
    phi_b = TWO_PI * u2
    sb = torch.sin(phi_b)
    cb = torch.cos(phi_b)
    rad_b = torch.pow(u3, ONE_THIRD)
    bx = rad_b * rxy * cb
    by = rad_b * rxy * sb
    bz = rad_b * zb

    # lax.rsqrt(a) as 1 / sqrt(a), both correctly rounded, here and in K5:
    # the card's rsqrtf is an approximation
    inv_dlen = 1.0 / sqrt_f32(a)
    udx, udy, udz = dx * inv_dlen, dy * inv_dlen, dz * inv_dlen

    lx, ly, lz = nx_ + bx, ny_ + by, nz_ + bz
    near0 = (torch.abs(lx) < EPS8) & (torch.abs(ly) < EPS8) \
        & (torch.abs(lz) < EPS8)
    lx = torch.where(near0, nx_, lx)
    ly = torch.where(near0, ny_, ly)
    lz = torch.where(near0, nz_, lz)

    ddn = udx * nx_ + udy * ny_ + udz * nz_
    rx = udx - 2.0 * ddn * nx_
    ry = udy - 2.0 * ddn * ny_
    rz = udz - 2.0 * ddn * nz_
    mx = rx + fuzz * bx
    my = ry + fuzz * by
    mz = rz + fuzz * bz
    metal_ok = (mx * nx_ + my * ny_ + mz * nz_) > 0.0

    ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(-(udx * nx_ + udy * ny_ + udz * nz_), 1.0)
    sin_t = sqrt_f32(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_m = 1.0 - cos_t
    om2 = one_m * one_m
    refl5 = r0 + (1.0 - r0) * om2 * om2 * one_m
    do_refl = cannot | (refl5 > u4)
    fx = ratio * (udx + cos_t * nx_)
    fy = ratio * (udy + cos_t * ny_)
    fz = ratio * (udz + cos_t * nz_)
    plen = torch.abs(1.0 - (fx * fx + fy * fy + fz * fz))   # Vec3.h:138
    par = -sqrt_f32(plen)
    gx = fx + par * nx_
    gy = fy + par * ny_
    gz = fz + par * nz_

    is_l = kind == float(MAT_LAMBERTIAN)
    is_m = kind == float(MAT_METAL)
    is_d = kind == float(MAT_DIELECTRIC)
    is_i = kind == float(MAT_ISOTROPIC)
    new = []
    for ud, l_, m_, r_, g_, i_ in ((udx, lx, mx, rx, gx, rxy * cb),
                                   (udy, ly, my, ry, gy, rxy * sb),
                                   (udz, lz, mz, rz, gz, zb)):
        v = torch.where(is_l, l_, ud)
        v = torch.where(is_m, m_, v)
        v = torch.where(is_d, torch.where(do_refl, r_, g_), v)
        new.append(torch.where(is_i, i_, v))
    att = [torch.where(is_d, 1.0, tex[i]) for i in range(3)]

    scattered = (is_m & metal_ok) | (~is_m & ~is_light)
    alive = alive & scattered
    st["thr"] = [torch.where(alive, st["thr"][i] * att[i], st["thr"][i])
                 for i in range(3)]
    st["acc"] = acc
    st["ox"] = torch.where(alive, px, ox)
    st["oy"] = torch.where(alive, py, oy)
    st["oz"] = torch.where(alive, pz, oz)
    st["dx"] = torch.where(alive, new[0], dx)
    st["dy"] = torch.where(alive, new[1], dy)
    st["dz"] = torch.where(alive, new[2], dz)
    bounce2 = torch.where(active, bounce + 1, bounce)
    st["bounce"] = bounce2
    st["active"] = alive & (bounce2 < max_bounces)


def mega_bounces_plain(rf, ri, tabs: MegaTables, *, k_bounces: int,
                       t_min: float, max_bounces: int, background):
    """K5 in plain PyTorch: advance ray state ``rf`` [B, 13] f32 (o, d,
    time, thr, acc) and ``ri`` [B, 4] i32 (pix_ctr, samp, bounce, active)
    ``k_bounces`` bounces -> new (rf, ri)."""
    t_min = float(np.float32(t_min))
    bg = [float(np.float32(x)) for x in background]
    st = {k: rf[:, i] for i, k in enumerate(("ox", "oy", "oz", "dx", "dy",
                                             "dz", "tm"))}
    st["thr"] = [rf[:, 7 + i] for i in range(3)]
    st["acc"] = [rf[:, 10 + i] for i in range(3)]
    st["bounce"] = ri[:, 2]
    st["active"] = ri[:, 3] > 0
    pix_ctr, samp = ri[:, 0], ri[:, 1]
    for _ in range(k_bounces):
        _bounce(tabs, st, pix_ctr, samp, t_min=t_min,
                max_bounces=max_bounces, bg=bg)
    rf2 = torch.stack([st["ox"], st["oy"], st["oz"], st["dx"], st["dy"],
                       st["dz"], st["tm"], *st["thr"], *st["acc"]], dim=1)
    ri2 = torch.stack([pix_ctr, samp, st["bounce"],
                       st["active"].to(torch.int32)], dim=1)
    return rf2, ri2


# --------------------------------------------------------------------------
# K5: the CUDA kernel, its wrapper and the dispatcher


class _Params(ctypes.Structure):
    """Mirror of ``MegaParams`` in ``csrc/mega_bounces.cu``."""
    _fields_ = [
        ("sph", ctypes.c_void_p), ("quad", ctypes.c_void_p),
        ("attr", ctypes.c_void_p), ("med", ctypes.c_void_p),
        ("bg", ctypes.c_float * 3), ("t_min", ctypes.c_float),
        ("s_pad", ctypes.c_int), ("q_pad", ctypes.c_int),
        ("n_media", ctypes.c_int), ("k_bounces", ctypes.c_int),
        ("max_bounces", ctypes.c_int),
    ]


def load_kernel():
    """Build (at first use) and load K5; returns (CDLL, build record)."""
    from ..utils.cuda_build import load_library

    lib, record = load_library("mega_bounces")
    p = ctypes.c_void_p
    lib.mega_bounces_launch.argtypes = [ctypes.POINTER(_Params), p, p,
                                        ctypes.c_int, p, p, p]
    lib.mega_bounces_launch.restype = ctypes.c_int
    lib.mega_params_size.argtypes = []
    lib.mega_params_size.restype = ctypes.c_int
    if lib.mega_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("MegaParams and its ctypes mirror differ")
    return lib, record


def mega_bounces_cuda(rf, ri, tabs: MegaTables, *, k_bounces: int,
                      t_min: float, max_bounces: int, background):
    """K5 on the card: `mega_bounces_plain`'s (rf, ri) for CUDA tensors.
    Launches on the current stream and does not synchronise."""
    dev = rf.device
    if dev.type != "cuda":
        raise ValueError(f"mega_bounces_cuda needs CUDA tensors, got {dev}")
    n = rf.shape[0]
    if rf.dtype != torch.float32 or rf.shape != (n, RF_ROWS) \
            or not rf.is_contiguous():
        raise ValueError("rf must be a contiguous f32 [B, 13] tensor")
    if ri.dtype != torch.int32 or ri.shape != (n, RI_ROWS) \
            or ri.device != dev or not ri.is_contiguous():
        raise ValueError("ri must be a contiguous int32 [B, 4] tensor on "
                         "rf's device")
    for name in ("sph", "quad", "attr", "med"):
        t = getattr(tabs, name)
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"table {name} must be contiguous f32 on {dev}")
    lib, _ = load_kernel()
    rf2 = torch.empty_like(rf)
    ri2 = torch.empty_like(ri)
    prm = _Params(
        sph=tabs.sph.data_ptr(), quad=tabs.quad.data_ptr(),
        attr=tabs.attr.data_ptr(), med=tabs.med.data_ptr(),
        bg=(ctypes.c_float * 3)(*background),
        t_min=float(np.float32(t_min)), s_pad=tabs.sph.shape[1],
        q_pad=tabs.quad.shape[1], n_media=tabs.n_media,
        k_bounces=k_bounces, max_bounces=max_bounces)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mega_bounces_launch(ctypes.byref(prm), rf.data_ptr(),
                                      ri.data_ptr(), n, rf2.data_ptr(),
                                      ri2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mega_bounces kernel launch failed: CUDA error "
                           f"{err}")
    mega_bounces_cuda.launches += 1
    return rf2, ri2


mega_bounces_cuda.launches = 0


def mega_bounces(rf, ri, tabs: MegaTables, **kw):
    """(rf, ri) after K bounces: the plain version for CPU tensors, K5 for
    CUDA tensors.  No fallback between them."""
    if rf.device.type == "cpu":
        return mega_bounces_plain(rf, ri, tabs, **kw)
    if rf.device.type == "cuda":
        return mega_bounces_cuda(rf, ri, tabs, **kw)
    raise ValueError(f"no mega_bounces for device {rf.device}")


# --------------------------------------------------------------------------
# the frame loop


def refill_lanes(done, next_ray, pix_id, *, npix: int, n_work: int):
    """Assign the next work items to finished lanes, in lane order: work
    item k is pixel ``k % npix`` at sample ``k // npix`` (early waves
    sweep the whole frame first).  Returns (take [P] bool, new pixel [P],
    new sample [P], next_ray, pix_id) with everything on the device."""
    di = done.to(torch.int64)
    rank = torch.cumsum(di, 0) - di
    new_k = next_ray + rank
    take = done & (new_k < n_work)
    new_pix = new_k % npix
    new_samp = new_k // npix
    pix_id = torch.where(take, new_pix, pix_id)
    next_ray = torch.clamp_max(next_ray + di.sum(), n_work)
    return take, new_pix, new_samp, next_ray, pix_id


def render_mega_frame(tabs: MegaTables, cam, *, width: int, height: int,
                      spp: int, seed: int, max_bounces: int, t_min: float,
                      pool: int, k_bounces: int,
                      background) -> torch.Tensor:
    """Radiance SUM over the ``spp`` samples -> [W*H, 3] f32
    on the tables' device (pixel id j*W + i, j counting up from the
    bottom).  ``cam`` is `raygen.camera_tuple`."""
    dev = tabs.sph.device
    npix = width * height
    n_work = npix * spp
    P = -(-min(pool, n_work) // 512) * 512
    kw = dict(k_bounces=k_bounces, t_min=t_min, max_bounces=max_bounces,
              background=background)
    fb = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    rf = torch.zeros((P, RF_ROWS), dtype=torch.float32, device=dev)
    ri = torch.zeros((P, RI_ROWS), dtype=torch.int32, device=dev)
    next_ray = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.ones(P, dtype=torch.bool, device=dev)
    ever = torch.zeros(P, dtype=torch.bool, device=dev)
    pix_id = torch.zeros(P, dtype=torch.int64, device=dev)
    ones3 = torch.ones((P, 3), dtype=torch.float32, device=dev)
    zeros3 = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    zeros1 = torch.zeros(P, dtype=torch.int32, device=dev)

    def emit_into(fb, emit):
        fb.index_add_(0, pix_id, torch.where(emit[:, None], rf[:, 10:13],
                                             0.0))

    while bool((next_ray < n_work) | (ever & done).any()
               | (ri[:, 3] > 0).any()):
        emit = ever & done
        emit_into(fb, emit)
        ever = ever & ~emit
        take, new_pix, new_samp, next_ray, pix_id = refill_lanes(
            done, next_ray, pix_id, npix=npix, n_work=n_work)
        o, d, time, pc = generate_rays(cam, new_pix, new_samp, width, height,
                                       seed)
        new_rf = torch.cat([o, d, time[:, None], ones3, zeros3], dim=1)
        new_ri = torch.stack([pc, new_samp.to(torch.int32), zeros1,
                              torch.ones_like(zeros1)], dim=1)
        rf = torch.where(take[:, None], new_rf, rf)
        ri = torch.where(take[:, None], new_ri, ri)
        ever = ever | take
        rf, ri = mega_bounces(rf, ri, tabs, **kw)
        done = ri[:, 3] <= 0
    # final emit for paths that finished in the last kernel call
    emit_into(fb, ever & done)
    return fb


def render_mega(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig, *,
                device) -> torch.Tensor:
    """Radiance sums [H*W, 3] of the whole frame through K5, all samples
    in one frame loop, on ``device``."""
    if not mega_supported(meta):
        raise ValueError("mega engine: Perlin/image textures are not in K5; "
                         "use wavefront_pallas (ops/render.render does)")
    if np.asarray(scene.sph_rad).dtype != np.float32:
        raise ValueError("the mega engine is f32 only, as its kernel is")
    tabs = pack_mega_tables(scene, meta, device)
    return render_mega_frame(
        tabs, camera_tuple(scene.camera), width=cfg.width,
        height=cfg.height, spp=cfg.samples_per_pixel, seed=cfg.seed,
        max_bounces=cfg.max_bounces, t_min=cfg.t_min,
        pool=min(cfg.rays_per_batch, MEGA_POOL), k_bounces=MEGA_K,
        background=tuple(float(x) for x in np.asarray(
            scene.camera.background)))
