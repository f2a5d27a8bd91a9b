"""Closest hit over the scene's flat arrays: every ray tests every
primitive by type with branchless arithmetic, and a masked argmin picks
the winner.

Port of ``raytracinginoneweekendincuda_tpu/ops/hit.py`` (the reference's
hit chain, Sphere.h:22-63, MovingSphere.h:44-89, Quad.h:52-83,
ConstantMedium.h:52-94) for f32 and f64.  The [B,3] x [3,N] contractions
of the JAX version are written as explicit sums of the three component
products, in index order, so no matrix unit (and no TF32) is involved.
Winner lookups are plain row gathers from the packed tables of
`derive`; the one-hot contraction of the JAX version exists only for its
TPU backward pass and has no counterpart here.

Closest-hit equivalence with the reference's shrinking-tMax list walk
(HittableList.h:39-57): per primitive the nearest root beyond t_min, and
the argmin imposes the upper bound.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.camera import CameraParams
from ..scene.compiler import MED_BOX, SceneArrays

BIG = 1.0e30
MEDIUM_REHIT_EPS = 1.0e-4   # ConstantMedium.h:63
QUAD_PARALLEL_EPS = 1.0e-8  # Quad.h:59

# sphere record row: c0(3) dc(3) t0 inv_dt rad cos sin mat
SPH_ROW = 12
# quad record row: n_unit(3) vxw(3) wxu(3) q(3) mat
QUAD_ROW = 13
# material/texture row (texture denormalized into the material):
#   kind fuzz ior tex_kind c0(3) c1(3) inv_scale scale noise_id image_id
MAT_ROW = 14


class HitRecord(NamedTuple):
    """Batched analogue of the reference HitRecord (Hittable.h:11-31);
    ``mrow`` carries the winner's material/texture row."""
    t: torch.Tensor        # [B]
    p: torch.Tensor        # [B, 3]
    normal: torch.Tensor   # [B, 3] (front-faced, SetFaceNormal semantics)
    u: torch.Tensor        # [B]
    v: torch.Tensor        # [B]
    front: torch.Tensor    # [B] bool
    mat: torch.Tensor      # [B] int64
    hit: torch.Tensor      # [B] bool
    mrow: torch.Tensor     # [B, MAT_ROW]


class Derived(NamedTuple):
    """Per-scene quantities reused across bounces, and the packed winner
    tables."""
    ds: dict               # per-sphere candidate scalars
    dq: dict               # per-quad plane constants
    sph_tab: torch.Tensor  # [S, SPH_ROW]
    quad_tab: torch.Tensor  # [Q, QUAD_ROW]
    mat_tab: torch.Tensor  # [K, MAT_ROW]


def scene_tensors(scene: SceneArrays, device) -> SceneArrays:
    """``scene`` with every array leaf as a tensor on ``device``: floats
    keep the scene's dtype (f32 or f64), integers become int64, masks
    bool; the camera becomes a ``CameraParams`` of tensors."""
    dev = torch.device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=dev)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int64), device=dev)
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    fields = {f: conv(getattr(scene, f)) for f in scene._fields
              if f != "camera"}
    cam = CameraParams(*[conv(x) for x in scene.camera])
    return SceneArrays(**fields, camera=cam)


def derive_spheres(s: SceneArrays):
    """Per-sphere scalars reused across bounces."""
    return dict(
        c0_sq=vm.dot(s.sph_c0, s.sph_c0),
        c0_dc=vm.dot(s.sph_c0, s.sph_dc),
        dc_sq=vm.dot(s.sph_dc, s.sph_dc),
        rad_sq=s.sph_rad * s.sph_rad,
    )


def derive_quads(s: SceneArrays):
    """Plane constants (Quad.h:31-37) and the triple-product vectors that
    turn the interior test into two ray-independent contractions:
    alpha = pvec . (v x w), beta = pvec . (w x u)."""
    n = vm.cross(s.quad_u, s.quad_v)
    n_len = vm.length(n)[..., None]
    n_unit = n / torch.where(n_len > 0, n_len, 1.0)
    d_plane = vm.dot(n_unit, s.quad_q)
    nn = vm.dot(n, n)[..., None]
    w_vec = n / torch.where(nn > 0, nn, 1.0)
    vxw = vm.cross(s.quad_v, w_vec)
    wxu = vm.cross(w_vec, s.quad_u)
    return dict(n_unit=n_unit, d_plane=d_plane, vxw=vxw, wxu=wxu,
                q_vxw=vm.dot(s.quad_q, vxw), q_wxu=vm.dot(s.quad_q, wxu))


def derive(s: SceneArrays) -> Derived:
    """All derived state of a tensor scene (`scene_tensors`)."""
    f = s.sph_rad.dtype
    ds = derive_spheres(s)
    dq = derive_quads(s)
    col = lambda a: a.to(f)[:, None]
    sph_tab = torch.cat([s.sph_c0, s.sph_dc, col(s.sph_t0),
                         col(s.sph_inv_dt), col(s.sph_rad), col(s.sph_cos),
                         col(s.sph_sin), col(s.sph_mat)], dim=1)
    quad_tab = torch.cat([dq["n_unit"], dq["vxw"], dq["wxu"], s.quad_q,
                          col(s.quad_mat)], dim=1)
    # each material's texture denormalized into its row (kernel.cu:203-206)
    tid = torch.clamp(s.mat_tex, 0, s.tex_kind.shape[0] - 1)
    mat_tab = torch.cat([
        col(s.mat_kind), col(s.mat_fuzz), col(s.mat_ior),
        col(s.tex_kind)[tid], s.tex_c0[tid], s.tex_c1[tid],
        col(s.tex_inv_scale)[tid], col(s.tex_scale)[tid],
        col(s.tex_noise)[tid], col(s.tex_image)[tid]], dim=1)
    return Derived(ds=ds, dq=dq, sph_tab=sph_tab, quad_tab=quad_tab,
                   mat_tab=mat_tab)


def _mm(a, b):
    """[B, 3] x [N, 3]^T -> [B, N] as the sum of three outer products, in
    component order."""
    return (a[:, 0:1] * b[None, :, 0] + a[:, 1:2] * b[None, :, 1]
            + a[:, 2:3] * b[None, :, 2])


def sphere_candidates(s: SceneArrays, ds, o, d, time, t_min):
    """Nearest valid quadratic root per (ray, sphere): [B, S] t (BIG = none).
    Sphere.h:29-33 / MovingSphere.h:52-58 with the moving centre
    ``c0 + frac * dc`` folded into the coefficients."""
    frac = (time[:, None] - s.sph_t0[None, :]) * s.sph_inv_dt[None, :]
    d_c0 = _mm(d, s.sph_c0)
    o_c0 = _mm(o, s.sph_c0)
    d_dc = _mm(d, s.sph_dc)
    o_dc = _mm(o, s.sph_dc)
    a = vm.dot(d, d)[:, None]
    o_sq = vm.dot(o, o)[:, None]
    o_d = vm.dot(o, d)[:, None]

    d_center = d_c0 + frac * d_dc
    o_center = o_c0 + frac * o_dc
    center_sq = ds["c0_sq"][None, :] + frac * (
        2.0 * ds["c0_dc"][None, :] + frac * ds["dc_sq"][None, :])

    b = o_d - d_center                      # Dot(oc, dir)
    c = o_sq - 2.0 * o_center + center_sq - ds["rad_sq"][None, :]
    disc = b * b - a * c
    pos = disc > 0.0
    sq = vm.sqrt_exact(torch.where(pos, disc, 1.0))
    inv_a = 1.0 / a
    root1 = (-b - sq) * inv_a
    root2 = (-b + sq) * inv_a
    feasible = pos & s.sph_active[None, :]
    t_cand = torch.where(root1 > t_min, root1, root2)
    ok = feasible & (t_cand > t_min)                  # strict, Sphere.h:38
    return torch.where(ok, t_cand, BIG)


def quad_candidates(s: SceneArrays, dq, o, d, t_min):
    """Plane hit + interior test per (ray, quad): [B, Q] t (Quad.h:52-99)."""
    denom = _mm(d, dq["n_unit"])
    denom_ok = torch.abs(denom) >= QUAD_PARALLEL_EPS
    denom_safe = torch.where(denom_ok, denom, 1.0)
    t = (dq["d_plane"][None, :] - _mm(o, dq["n_unit"])) / denom_safe
    alpha = _mm(o, dq["vxw"]) + t * _mm(d, dq["vxw"]) - dq["q_vxw"][None, :]
    beta = _mm(o, dq["wxu"]) + t * _mm(d, dq["wxu"]) - dq["q_wxu"][None, :]
    ok = (s.quad_active[None, :] & denom_ok
          & (t >= t_min)                               # inclusive, Quad.h:64
          & (alpha >= 0.0) & (alpha <= 1.0)            # Interval::Contains
          & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(ok, t, BIG)


def medium_candidates(s: SceneArrays, o, d, t_min, u_med):
    """Stochastic scatter point per (ray, medium): [B, M] t
    (ConstantMedium.h:52-94).  Boundary entry/exit analytically: sphere
    roots, or the slab interval of an (instanced) box, with the +1e-4
    re-hit epsilon.  ``u_med`` [B, M] are the uniforms in (0, 1]."""
    oc = o[:, None, :] - s.med_center[None, :, :]            # [B, M, 3]
    a = vm.dot(d, d)[:, None]
    b = vm.dot(oc, d[:, None, :])
    c = vm.dot(oc, oc) - (s.med_radius * s.med_radius)[None, :]
    disc = b * b - a * c
    valid_s = disc > 0.0
    sq = vm.sqrt_exact(torch.where(valid_s, disc, 1.0))
    t0_s = (-b - sq) / a
    t1_s = (-b + sq) / a

    # box boundary: world -> object rigid transform, then slab test
    c2 = s.med_cos[None, :]
    s2 = s.med_sin[None, :]
    po = o[:, None, :] - s.med_off[None, :, :]
    ox, oy, oz = po[..., 0], po[..., 1], po[..., 2]
    dx, dy, dz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
    o_obj = torch.stack(torch.broadcast_tensors(
        c2 * ox - s2 * oz, oy, s2 * ox + c2 * oz), -1)
    d_obj = torch.stack(torch.broadcast_tensors(
        c2 * dx - s2 * dz, dy, s2 * dx + c2 * dz), -1)
    inv_d = 1.0 / d_obj
    ta = (s.med_bmin[None] - o_obj) * inv_d
    tb = (s.med_bmax[None] - o_obj) * inv_d
    t0_b = torch.minimum(ta, tb).amax(-1)
    t1_b = torch.maximum(ta, tb).amin(-1)
    valid_b = t1_b > t0_b

    is_box = (s.med_kind == MED_BOX)[None, :]
    t0 = torch.where(is_box, t0_b, t0_s)
    t1 = torch.where(is_box, t1_b, t1_s)
    valid = torch.where(is_box, valid_b, valid_s) & s.med_active[None, :]
    valid = valid & (t1 > t0 + MEDIUM_REHIT_EPS)

    t0c = torch.clamp_min(torch.clamp_min(t0, t_min), 0.0)  # h:67,73-74
    valid = valid & (t0c < t1)
    ray_len = vm.sqrt_exact(a)
    dist_inside = (t1 - t0c) * ray_len
    hit_dist = s.med_nid[None, :] * torch.log(u_med)   # -(1/rho) log U, h:79
    valid = valid & (hit_dist <= dist_inside)
    t_cand = t0c + hit_dist / ray_len
    return torch.where(valid, t_cand, BIG)


# lanes one partial sum of `row_sum` adds: a row with n lanes is summed in
# ceil(log_ROW_CHUNK(n)) levels of chunk sums, every chunk in parallel
# (two for a frame of up to 262,144 lanes; each level is ~25 launches)
ROW_CHUNK = 512


def _chunk_sums(seg, vals, rows: int, width: int, per_row: bool):
    """One level of `row_sum`: ``vals`` [n, C] sorted by row ``seg`` [n]
    (``rows`` marks padding) -> (row, sum) of each chunk of at most
    ``width`` consecutive lanes of one row.  ``per_row``: every row has at
    most ``width`` lanes, so the result is [rows, C] in row order; else
    the chunks come sorted by row, padded to a length fixed by the
    shapes."""
    n = vals.shape[0]
    dev = seg.device
    r = torch.arange(rows, device=dev)
    starts = torch.searchsorted(seg, r)
    ends = torch.searchsorted(seg, r, right=True)
    if per_row:
        row_of, first = r, starts
    else:
        nch = (ends - starts + (width - 1)) // width
        last = torch.cumsum(nch, 0)               # integer: exact
        j = torch.arange(min(n, -(-n // width) + rows), device=dev)
        row_of = torch.searchsorted(last, j, right=True)   # rows = padding
        rc = torch.clamp(row_of, max=rows - 1)
        first = starts[rc] + (j - (last[rc] - nch[rc])) * width
        ends = torch.where(row_of < rows, ends[rc], 0)
    src = first[:, None] + torch.arange(width, device=dev)
    src = torch.where(src < ends[:, None], src, n)      # n: the zero row
    pad = torch.cat([vals, vals.new_zeros((1, vals.shape[1]))])
    part = pad.index_select(0, src.reshape(-1))
    return row_of, part.view(src.shape[0], width, -1).sum(1)


def row_sum(idx: torch.Tensor, grad: torch.Tensor, rows: int):
    """``zeros(rows, C).index_add_(0, idx, grad)`` with the order of every
    sum fixed by ``idx`` alone: a stable sort groups each row's lanes in
    lane order, then chunks of `ROW_CHUNK` lanes are summed in parallel,
    level after level, until one sum a row is left.  Only sorts, gathers
    and sums over a dimension run -- no atomics, no float scan -- so
    the result repeats bit for bit on the card (``index_add_``'s CUDA
    atomics add in a different order on each run).  No host sync."""
    seg, order = torch.sort(idx, stable=True)
    vals = grad.index_select(0, order)
    bound = idx.shape[0]                  # the most lanes a row can have
    while bound > ROW_CHUNK:
        seg, vals = _chunk_sums(seg, vals, rows, ROW_CHUNK, per_row=False)
        bound = -(-bound // ROW_CHUNK)
    return _chunk_sums(seg, vals, rows, max(bound, 1), per_row=True)[1]


class _RowRead(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose backward is `row_sum`."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return row_sum(idx, grad.contiguous(), ctx.rows), None


def read_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [B] (int64) of ``table`` [R, C] -> [B, C]: the winner
    reads of the hit record and the replay.  The forward is
    ``index_select`` (the same values); the gradient of ``table`` sums
    each row's lanes in an order fixed by the data (`row_sum`), so a
    train step repeats on the card.  Advanced indexing's backward would
    sort too, but walks a row's duplicates one thread at a time: with
    most lanes on the ground sphere's row it took most of a step."""
    return _RowRead.apply(table, idx)


def first_argmin(t, t_best):
    """Index of the first occurrence of ``t_best`` along the last axis."""
    n = t.shape[-1]
    iota = torch.arange(n, device=t.device)
    return torch.where(t == t_best[..., None], iota, n).amin(-1)


def closest_hit(scene, meta, der: Derived, o, d, time, t_min, u_med):
    """Full-world closest hit -> HitRecord (the (*world)->Hit call of the
    integrator, kernel.cu:74)."""
    rec, _ = closest_hit_winner(scene, meta, der, o, d, time, t_min, u_med)
    return rec


def brute_force_hit_fn(scene, meta):
    """``hit_fn(o, d, time, t_min, u_med) -> HitRecord``: `closest_hit`
    over every primitive of a tensor scene (`scene_tensors`), its derived
    tables built once."""
    der = derive(scene)

    def hit_fn(o, d, time, t_min, u_med):
        return closest_hit(scene, meta, der, o, d, time, t_min, u_med)

    return hit_fn


def closest_hit_winner(scene, meta, der: Derived, o, d, time, t_min,
                       u_med):
    """`closest_hit` plus the winner's GLOBAL id [B] (int64): spheres
    [0, S), quads [S, S+Q), media [S+Q, S+Q+M), -1 = miss."""
    t_s = sphere_candidates(scene, der.ds, o, d, time, t_min)
    t_q = quad_candidates(scene, der.dq, o, d, t_min)
    ts_best = t_s.amin(-1)
    is_best = first_argmin(t_s, ts_best)
    tq_best = t_q.amin(-1)
    iq_best = first_argmin(t_q, tq_best)

    parts_t = [ts_best, tq_best]
    im_best = torch.zeros_like(is_best)
    if meta.n_media > 0:
        t_m = medium_candidates(scene, o, d, t_min, u_med)
        parts_t.append(t_m.amin(-1))
        im_best = t_m.argmin(-1)

    t_all = torch.stack(parts_t, 0)
    kind = t_all.argmin(0)
    t = t_all.amin(0)
    rec = assemble_record(scene, meta, der, o, d, time, t, kind,
                          is_best, iq_best, im_best)
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]
    w = torch.where(kind == 0, is_best, S + iq_best)
    if meta.n_media > 0:
        w = torch.where(kind == 2, S + Q + im_best, w)
    return rec, torch.where(rec.hit, w, -1)


def record_from_geo_winner(scene, meta, der: Derived, o, d, time, t_min,
                           u_med, t_geo, best_p) -> HitRecord:
    """Merge a geometry winner (global prim id ``best_p``, -1 = none;
    spheres first, then quads) with the stochastic media candidates and
    build the HitRecord."""
    B = o.shape[0]
    S = scene.sph_c0.shape[0]
    t_geo = torch.where(best_p >= 0, t_geo, BIG)
    kind_geo = torch.where(best_p >= S, 1, 0)
    parts_t = [torch.where(kind_geo == 0, t_geo, BIG),
               torch.where(kind_geo == 1, t_geo, BIG)]
    im_best = torch.zeros(B, dtype=torch.int64, device=o.device)
    if meta.n_media > 0:
        t_m = medium_candidates(scene, o, d, t_min, u_med)
        parts_t.append(t_m.amin(-1))
        im_best = t_m.argmin(-1)
    t_all = torch.stack(parts_t, 0)
    kind = t_all.argmin(0)
    t = t_all.amin(0)
    i_s = torch.clamp(best_p, 0, S - 1)
    i_q = torch.clamp(best_p - S, 0, scene.quad_q.shape[0] - 1)
    return assemble_record(scene, meta, der, o, d, time, t, kind,
                           i_s, i_q, im_best)


def assemble_record(scene, meta, der: Derived, o, d, time, t, kind, is_best,
                    iq_best, im_best) -> HitRecord:
    """Winner (t, kind, per-type index) -> full HitRecord; ``kind`` 0 =
    sphere, 1 = quad, 2 = constant medium; ``t`` >= BIG/2 means no hit
    (Sphere.h:40-58, Quad.h:76-98, ConstantMedium.h:85-93)."""
    hit = t < BIG * 0.5
    # miss lanes: t = 1 keeps p finite (the integrator masks them)
    t_safe = torch.where(hit, t, 1.0)
    p = o + t_safe[:, None] * d

    # ---- sphere record (Sphere.h:40-58 + GetSphereUV:74-81)
    srow = read_rows(der.sph_tab, is_best)
    c0, dc = srow[:, 0:3], srow[:, 3:6]
    frac = (time - srow[:, 6]) * srow[:, 7]
    center = c0 + frac[:, None] * dc
    rad = srow[:, 8:9]
    n_out_s = (p - center) / torch.where(rad != 0, rad, 1.0)
    # UV from the object-space normal (instanced spheres keep their frame)
    cth, sth = srow[:, 9], srow[:, 10]
    nx, ny, nz = n_out_s[..., 0], n_out_s[..., 1], n_out_s[..., 2]
    ox_n = cth * nx - sth * nz
    oz_n = sth * nx + cth * nz
    ny_c = torch.clamp(-ny, -1.0, 1.0)
    interior = torch.abs(ny_c) < 1.0
    theta_uv = torch.where(
        interior, torch.arccos(torch.where(interior, ny_c, 0.0)),
        torch.where(ny_c > 0, 0.0, torch.full_like(ny_c, math.pi)))
    atan_ok = (torch.abs(ox_n) + torch.abs(oz_n)) > 0.0
    phi_uv = torch.where(
        atan_ok, torch.arctan2(torch.where(atan_ok, -oz_n, 0.0),
                               torch.where(atan_ok, ox_n, 1.0)),
        0.0) + math.pi
    u_s = phi_uv / (2.0 * math.pi)
    v_s = theta_uv / math.pi
    mat_s = srow[:, 11]

    # ---- quad record (Quad.h:76-98)
    qrow = read_rows(der.quad_tab, iq_best)
    n_q = qrow[:, 0:3]
    pq = p - qrow[:, 9:12]
    alpha = vm.dot(pq, qrow[:, 3:6])
    beta = vm.dot(pq, qrow[:, 6:9])
    mat_q = qrow[:, 12]

    # ---- assemble by kind
    is_sph = kind == 0
    n_out = torch.where(is_sph[:, None], n_out_s, n_q)
    uu = torch.where(is_sph, u_s, alpha)
    vv = torch.where(is_sph, v_s, beta)
    mat = torch.where(is_sph, mat_s, mat_q)
    if meta.n_media > 0:
        is_med = kind == 2
        med_normal = torch.zeros_like(n_out)
        med_normal[:, 0] = 1.0                       # arbitrary, h:89
        n_out = torch.where(is_med[:, None], med_normal, n_out)
        uu = torch.where(is_med, 0.0, uu)
        vv = torch.where(is_med, 0.0, vv)
        mat = torch.where(is_med, scene.med_mat[im_best].to(mat.dtype), mat)

    front = vm.dot(d, n_out) < 0.0           # SetFaceNormal, Hittable.h:24-30
    normal = torch.where(front[:, None], n_out, -n_out)
    if meta.n_media > 0:
        front = torch.where(is_med, True, front)       # arbitrary true, h:90
        normal = torch.where(is_med[:, None], n_out, normal)

    mat_i = mat.to(torch.int64)
    mrow = read_rows(der.mat_tab, mat_i)
    return HitRecord(t=t, p=p, normal=normal, u=uu, v=vv, front=front,
                     mat=mat_i, hit=hit, mrow=mrow)
