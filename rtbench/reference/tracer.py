"""The reference path tracer for sphere worlds (kernel.cu:122-154's
``color`` loop, Material.h's scatter, Camera.h's GetRay), batched over
rays in plain PyTorch.

A path's draws are pcg4d hashes of (seed ^ pixel, sample, stream, 0): the
camera stream for the lens, jitter and shutter time, the scatter stream
or'ed with the bounce for the four scatter uniforms.  Every ray tests
every sphere (no culling, no row order of the program's).  A path ends on
a miss (adding the background times its throughput), on an absorbed metal
scatter, or after ``max_bounces`` bounces; a pixel's value is the sum of
its samples' radiance in sample order.  ``dtype`` is the precision of all
float arithmetic: float32 for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .world import DIELECTRIC, LAMBERTIAN, METAL, Tables, World, tables

BIG = float(np.float32(1.0e30))
HALF_BIG = float(np.float32(1.0e30 * 0.5))
EPS8 = float(np.float32(1.0e-8))
TWO_PI = float(np.float32(2.0 * np.pi))
ONE_THIRD = float(np.float32(1.0 / 3.0))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (f32 through f64, as ``sqrtf``)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _root(x: torch.Tensor) -> torch.Tensor:
    """`_sqrt` of ``x >= 0``, with a finite gradient where ``x`` is 0."""
    pos = x > 0.0
    return torch.where(pos, _sqrt(torch.where(pos, x, 1.0)), 0.0)


class Frame:
    """One frame's constants: the world's tables on ``device`` in
    ``dtype``, its camera frame, size, bounce cap and shutter."""

    def __init__(self, world: World, width: int, height: int,
                 max_bounces: int, device, dtype=torch.float32,
                 t_min: float = 1.0e-3):
        self.tab: Tables = tables(world, device, dtype)
        self.cam = world.camera.frame(float(width) / float(height))
        self.width, self.height = width, height
        self.max_bounces = max_bounces
        self.t_min = float(np.float32(t_min))
        self.device, self.dtype = torch.device(device), dtype
        self.bg = torch.as_tensor(self.cam["background"],
                                  device=device).to(dtype)


def _camera_values(cam: dict) -> tuple:
    """The camera's 21 values: python floats of an f32 camera frame, or
    0-d tensors of a camera of tensors (differentiable)."""
    vals = []
    for k in ("origin", "lower_left", "horizontal", "vertical", "u", "v"):
        x = cam[k]
        vals.extend(x.unbind(0) if torch.is_tensor(x)
                    else [float(v) for v in x])
    lens_r, t0, t1 = cam["lens_radius"], cam["time0"], cam["time1"]
    if torch.is_tensor(t0):
        return (*vals, lens_r, t0, t1 - t0)
    return (*vals, float(lens_r), float(t0),
            float(np.float32(t1) - np.float32(t0)))


def camera_rays(fr, pix: torch.Tensor, sample, seed):
    """(origin [N,3], direction [N,3], time [N], pix_ctr [N]) of pixel ids
    ``pix`` (j*W + i, j up from the bottom row) at ``sample`` (an int or
    [N]), sample-stream seed ``seed`` (an int or int32 words [N])."""
    dt = fr.dtype
    (ox, oy, oz, llx, lly, llz, hx, hy, hz, vx, vy, vz, ux, uy, uz,
     cvx, cvy, cvz, lens_r, tm0, shutter) = _camera_values(fr.cam)
    key = rng.to_word(seed) if isinstance(seed, int) else seed
    pix_ctr = pix.to(torch.int32) ^ key
    ju, jv, l1, l2 = rng.uniform4(pix_ctr, sample, rng.CAMERA_STREAM, 0, dt)
    tu = rng.uniform4(pix_ctr, sample, rng.CAMERA_STREAM + 1, 0, dt)[0]
    p64 = pix.to(torch.int64)
    i_f = (p64 % fr.width).to(dt)
    j_f = (p64 // fr.width).to(dt)
    w_t = torch.tensor(float(fr.width), dtype=dt, device=pix.device)
    h_t = torch.tensor(float(fr.height), dtype=dt, device=pix.device)
    s = (i_f + ju) / w_t
    t = (j_f + jv) / h_t
    r = _sqrt(l1)
    phi = (2.0 * np.pi) * l2
    rd0 = lens_r * (r * torch.cos(phi))
    rd1 = lens_r * (r * torch.sin(phi))
    offx = ux * rd0 + cvx * rd1
    offy = uy * rd0 + cvy * rd1
    offz = uz * rd0 + cvz * rd1
    o = torch.stack([ox + offx, oy + offy, oz + offz], dim=-1)
    d = torch.stack([llx + s * hx + t * vx - ox - offx,
                     lly + s * hy + t * vy - oy - offy,
                     llz + s * hz + t * vz - oz - offz], dim=-1)
    return o, d, tm0 + tu * shutter, pix_ctr


def sphere_keys(o, d, tm, a, akey, c0, dc, t0, inv_dt, rad2):
    """Key-space hits (t * |d|^2, or BIG for a miss) of rays on spheres,
    elementwise over broadcast shapes: ``o``, ``d``, ``c0`` and ``dc`` are
    three components each; ``akey`` is the key of t_min."""
    frac = (tm - t0) * inv_dt
    oc = [o[k] - (c0[k] + frac * dc[k]) for k in range(3)]
    b = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
    cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - rad2
    disc = b * b - a * cc
    sq = _sqrt(disc)
    k1 = -b - sq
    k2 = -b + sq
    key = torch.where(k1 > akey, k1, k2)
    return torch.where((disc > 0.0) & (key > akey), key, BIG)


def _closest(tab: Tables, o, d, tm, a, akey):
    """Nearest sphere of each ray in key space (t * |d|^2): (key or BIG,
    sphere index or -1); the first sphere wins an exact tie."""
    col = lambda x: x[None, :]
    key = sphere_keys([o[:, k:k + 1] for k in range(3)],
                      [d[:, k:k + 1] for k in range(3)], tm[:, None],
                      a[:, None], akey[:, None],
                      [col(tab.c0[:, k]) for k in range(3)],
                      [col(tab.dc[:, k]) for k in range(3)],
                      col(tab.t0), col(tab.inv_dt), col(tab.rad2))
    mn, idx = key.min(dim=1)       # the first index of the minimum
    return mn, torch.where(mn < BIG, idx, -1)


def _scatter(kind, fuzz, ior, front, n, d, a, u1, u2, u3, u4):
    """New direction and the scattered flag of lambertian, metal and
    dielectric hits (Material.h); a point in the unit ball from
    (u1, u2, u3), the Fresnel draw u4."""
    zb = 1.0 - 2.0 * u1
    rxy = _root(torch.abs(1.0 - zb * zb))
    phi = TWO_PI * u2
    rad_b = torch.pow(u3, ONE_THIRD)
    bx = rad_b * rxy * torch.cos(phi)
    by = rad_b * rxy * torch.sin(phi)
    bz = rad_b * zb
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
    mx = rx + fuzz * bx
    my = ry + fuzz * by
    mz = rz + fuzz * bz
    metal_ok = (mx * nx + my * ny + mz * nz) > 0.0

    ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(-(udx * nx + udy * ny + udz * nz), 1.0)
    sin_t = _root(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_m = 1.0 - cos_t
    om2 = one_m * one_m
    do_refl = cannot | (r0 + (1.0 - r0) * om2 * om2 * one_m > u4)
    fx = ratio * (udx + cos_t * nx)
    fy = ratio * (udy + cos_t * ny)
    fz = ratio * (udz + cos_t * nz)
    par = -_root(torch.abs(1.0 - (fx * fx + fy * fy + fz * fz)))

    is_l = kind == float(LAMBERTIAN)
    is_m = kind == float(METAL)
    is_d = kind == float(DIELECTRIC)
    new = torch.stack([udx, udy, udz], dim=1)
    new = torch.where(is_l[:, None], torch.stack([lx, ly, lz], 1), new)
    new = torch.where(is_m[:, None], torch.stack([mx, my, mz], 1), new)
    new = torch.where(is_d[:, None], torch.where(
        do_refl[:, None], torch.stack([rx, ry, rz], 1),
        torch.stack([fx + par * nx, fy + par * ny, fz + par * nz], 1)), new)
    return new, (is_m & metal_ok) | ~is_m


def _bounce(fr: Frame, o, d, tm, thr, acc, pix_ctr, samp, bounce: int):
    """One bounce of live rays: (origin, direction, throughput, radiance,
    alive)."""
    a = _dot(d, d)
    best, win = _closest(fr.tab, o, d, tm, a, fr.t_min * a)
    return shade(fr, o, d, tm, thr, acc, pix_ctr, samp, bounce, a,
                 torch.where(best < HALF_BIG, best * (1.0 / a), BIG), win)


def _dot(u, v):
    return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]


def shade(fr, o, d, tm, thr, acc, pix_ctr, samp, bounce: int, a, t, win):
    """The rest of a bounce, given each ray's hit distance ``t`` and
    sphere ``win`` (-1: miss): the background of a miss, the hit point,
    normal, texture, scatter and throughput."""
    tab = fr.tab
    dx, dy, dz = d.unbind(1)
    hit = win >= 0
    acc = acc + torch.where((~hit)[:, None], thr * fr.bg, 0.0)

    w = win.clamp_min(0)

    def at(x):
        v = x[w]
        return torch.where(hit.view(-1, *([1] * (v.dim() - 1))), v,
                           torch.zeros((), dtype=v.dtype, device=v.device))
    frac = (tm - at(tab.t0)) * at(tab.inv_dt)
    wc = at(tab.c0) + frac[:, None] * at(tab.dc)
    wrad = at(tab.rad)
    p = o + t[:, None] * d
    ns = (p - wc) * (1.0 / torch.where(wrad != 0.0, wrad, 1.0))[:, None]
    front = (dx * ns[:, 0] + dy * ns[:, 1] + dz * ns[:, 2]) < 0.0
    nrm = ns * torch.where(front, 1.0, -1.0)[:, None]

    inv_scale = torch.where(hit, tab.inv_scale[w], 0.0)
    cells = torch.floor(inv_scale[:, None] * torch.where(
        hit[:, None], p, 0.0).detach()).to(torch.int64)
    even = ((cells[:, 0] + cells[:, 1] + cells[:, 2]) & 1) == 0
    odd_ck = hit & tab.checker[w] & ~even
    tex = torch.where(odd_ck[:, None], at(tab.c_odd), at(tab.c_even))

    kind = at(tab.kind)
    u1, u2, u3, u4 = (rng.unit(x, fr.dtype) for x in rng.pcg4d(
        pix_ctr, samp, torch.full_like(pix_ctr, rng.to_word(
            rng.SCATTER_STREAM | bounce)), torch.zeros_like(pix_ctr)))
    new_d, scattered = _scatter(kind, at(tab.fuzz), at(tab.ior), front, nrm,
                                d, a, u1, u2, u3, u4)
    att = torch.where((kind == float(DIELECTRIC))[:, None], 1.0, tex)
    alive = hit & scattered
    thr = torch.where(alive[:, None], thr * att, thr)
    return p, new_d, thr, acc, alive


def trace_lanes(fr: Frame, pix: torch.Tensor, samp: torch.Tensor, seed,
                chunk: int = 1 << 18, visit=None):
    """Paths of the lanes (pixel ``pix`` [L], sample ``samp`` [L]) with
    the sample-stream seed ``seed`` (an int, or int32 words [L]), ``chunk``
    lanes at a time, dead paths dropped after each bounce: (radiance
    [L, 3], bounces run [L] int64).  ``visit(lanes, o, d, tm)``, if given,
    sees each bounce's rays before it runs, with their lanes' indices."""
    L, dev = pix.shape[0], pix.device
    K = max(fr.max_bounces, 1)
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
        for b in range(K):
            if visit is not None:
                visit(live, o, d, tm)
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
    lane_pix = pix.repeat(F * spp)
    out, nb = trace_lanes(fr, lane_pix, lane_samp, lane_seed, chunk,
                          visit)
    out = out.view(F, spp, P, 3)
    sums = torch.zeros((F, P, 3), dtype=fr.dtype, device=dev)
    for k in range(spp):
        sums = sums + out[:, k]
    return sums, nb.view(F, spp, P).sum(1)


def to_u8(sums: torch.Tensor, spp: int) -> torch.Tensor:
    """The reference's epilogue (kernel.cu:150-152, 709-718): average,
    gamma-2 square root (in f64), ``256 * clip(c, 0, 0.999)`` truncated
    to uint8."""
    fb = sums.float()
    fb = fb / torch.tensor(float(spp), dtype=fb.dtype, device=fb.device)
    fb = torch.sqrt(torch.clamp_min(fb, 0.0).double()).to(fb.dtype)
    return (256.0 * torch.clamp(fb, 0.0, 0.999)).to(torch.uint8)
