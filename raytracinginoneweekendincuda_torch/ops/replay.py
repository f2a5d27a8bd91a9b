"""Taped replay: the differentiable leg of the gradient path.

A winner tape (one primitive id per bounce) fixes the discrete path; the
replay recomputes the radiance with those winners: per bounce one read of
the winner's row of a merged table, a re-intersection of that one
primitive, media t, textures, emission and scatter.  Pathwise gradients
hold the discrete path fixed, so they flow through the replay alone: to
the scene leaves, the primary rays and the background.  The module has two
replays of such a tape.

**The XLA taped replay** (port of ``raytracinginoneweekendincuda_tpu/ops/
replay.py``: `taped_record`, `_u_med`, `generate_tape`, `replay`,
`trace_taped`), in the scene's dtype (f32 or f64): `generate_tape` runs the
integrator's search once and records each bounce's winner as a GLOBAL id
(spheres [0, S), quads [S, S+Q), media S+Q+m; -1 miss); `replay`
re-intersects the winner from `taped_rows` (one row gather a bounce) and
runs the integrator's shade / accumulate tail
(`integrator.advance_from_record`); `trace_taped` is the two together,
the tape without gradients, a drop-in for
``integrator.trace(differentiable=True)``.  `taped_rows` builds from
``hit.derive``'s tensors in their dtype what `derive_replay` builds in f32
for the kernels' table.  Its math is
``hit.assemble_record``'s, expression for expression (libm acos / atan2).

**The mega2 replay** (port of ``derive_replay`` and of the bounce that the
Pallas replay kernels compute, ``ops/pallas_replay.py::_make_bounce``),
f32: the tape comes from the trace K2 (``mega2.mega2_tapes``), the table
from `replay_table`.

``replay_plain`` is the plain PyTorch version of kernel K3 (``csrc/
replay_fwd.cu``), batched over lanes, in ``_make_bounce``'s op order: the
minimax acos / atan2 polynomials, the ``_safe_root`` guards, division (not
a reciprocal multiply).  Torch autograd through it is the plain version of
kernel K4 (``csrc/replay_bwd.cu``).  ``ops/replay_cuda.replay`` dispatches
between them.

Merged table columns (REP_COLS = 27, both replays; sphere rows | quad
rows):

    0:3   c0            | n_unit
    3:6   dc            | vxw
    6     t0            | wxu.x        7  inv_dt | wxu.y
    8     rad           | wxu.z        9  cth    | q.x
    10    sth           | q.y          11 0      | q.z
    12    material id
    13    kind   14 fuzz   15 ior   16 tex_kind   17:20 tex c0
    20:23 tex c1   23 inv_scale   24 noise scale   25 noise id   26 image id

In `replay_table`, medium winners read an appended row whose geometry
columns are zero and whose material columns are the medium's isotropic
material (its albedo is trainable).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core import vecmath as vm
from ..core.samplers import sqrt_f32
from ..scene.compiler import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_METAL, MED_BOX, TEX_CHECKER, TEX_IMAGE, TEX_NOISE, SceneArrays,
    SceneMeta,
)
from . import hit as hit_ops
from .hit import HitRecord
from .integrator import _u_med, advance_from_record
from .mega2 import _atan2_poly, _perlin_turb

REP_COLS = 27
MED_COLS = 17      # 0 kind, 1:4 center, 4 radius, 5:8 bmin, 8:11 bmax,
                   # 11 cos, 12 sin, 13 -1/density, 14:17 offset
BIG = float(np.float32(1.0e30))
HALF_BIG = float(np.float32(1.0e30 * 0.5))
EPS8 = float(np.float32(1.0e-8))
PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))
INV_2PI = float(np.float32(0.5 / np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
INV255 = float(np.float32(1.0 / 255.0))
ONE_THIRD = float(np.float32(1.0 / 3.0))
INV24 = rng.INV_2POW24


class ReplayTables(NamedTuple):
    """Everything the replay reads besides rays and tape.

    ``rep`` [NP, 27] is differentiable (built by `replay_table`); the rest
    are constants: media boundaries ``med`` [max(M,1), 17] (none of their
    leaves is trainable), and the Perlin / texel tables of the mega2
    packer (``perm``, ``vec``, ``texels``, ``img_dims``)."""
    rep: torch.Tensor
    med: torch.Tensor
    perm: torch.Tensor
    vec: torch.Tensor
    texels: torch.Tensor
    img_dims: torch.Tensor
    S: int             # first quad row
    med_base: int      # first medium row (NP - M)
    n_media: int
    n_noise: int
    has_checker: bool
    has_noise: bool
    has_image: bool

    @property
    def NP(self) -> int:
        return self.rep.shape[0]

    @property
    def n_images(self) -> int:
        return self.img_dims.shape[0]


def _f32(x, device):
    """A scene leaf as an f32 tensor on ``device`` (tensors keep their
    autograd history)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _idx(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _cross(u, v):
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)


def _mat_tab(scene: SceneArrays, device):
    """[K, 14] material rows with each material's texture denormalized in
    (the JAX package's ``hit.derive`` mat_tab)."""
    s = scene
    f = lambda x: _f32(x, device)
    tid = _idx(s.mat_tex, device).clamp(0, int(s.tex_kind.shape[0]) - 1)
    col = lambda x: f(x)[:, None]
    return torch.cat([
        col(s.mat_kind), col(s.mat_fuzz), col(s.mat_ior),
        col(s.tex_kind)[tid], f(s.tex_c0)[tid], f(s.tex_c1)[tid],
        col(s.tex_inv_scale)[tid], col(s.tex_scale)[tid],
        col(s.tex_noise)[tid], col(s.tex_image)[tid]], dim=1)


def derive_replay(scene: SceneArrays, meta: SceneMeta, device):
    """Merged replay rows [S+Q, 27] keyed by global scene id, and the
    media's material rows [M, 14] (None without media).  Plain
    differentiable torch on the scene leaves: a leaf that is a tensor
    with ``requires_grad`` receives its gradient through this assembly.
    Port of the JAX package's ``replay.derive_replay`` with the needed
    part of ``hit.derive``."""
    f = lambda x: _f32(x, device)
    col = lambda x: f(x)[:, None]
    mat_tab = _mat_tab(scene, device)
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]
    sph = torch.cat([
        f(scene.sph_c0), f(scene.sph_dc), col(scene.sph_t0),
        col(scene.sph_inv_dt), col(scene.sph_rad), col(scene.sph_cos),
        col(scene.sph_sin), torch.zeros((S, 1), device=device),
        col(scene.sph_mat), mat_tab[_idx(scene.sph_mat, device)]], dim=1)
    rows = [sph]
    if Q > 0:
        # hit.derive_quads: plane frame and the triple-product vectors
        qq, qu, qv = f(scene.quad_q), f(scene.quad_u), f(scene.quad_v)
        n = _cross(qu, qv)
        nn = (n * n).sum(-1, keepdim=True)
        n_len = sqrt_f32(nn)
        n_unit = n / torch.where(n_len > 0, n_len, 1.0)
        w_vec = n / torch.where(nn > 0, nn, 1.0)
        rows.append(torch.cat([
            n_unit, _cross(qv, w_vec), _cross(w_vec, qu), qq,
            col(scene.quad_mat), mat_tab[_idx(scene.quad_mat, device)]],
            dim=1))
    rep = torch.cat(rows, dim=0)
    med_rows = None
    if meta.n_media > 0:
        med_rows = mat_tab[_idx(scene.med_mat, device)]
    return rep, med_rows


def _media_constants(scene: SceneArrays, meta: SceneMeta, device):
    """[max(M,1), 17] medium boundary rows (f32; see MED_COLS)."""
    M = max(meta.n_media, 1)
    med = np.zeros((M, MED_COLS), np.float32)
    if meta.n_media:
        m = meta.n_media
        a = lambda x: np.asarray(x, np.float32)[:m]
        med[:m, 0] = a(scene.med_kind)
        med[:m, 1:4] = a(scene.med_center)
        med[:m, 4] = a(scene.med_radius)
        med[:m, 5:8] = a(scene.med_bmin)
        med[:m, 8:11] = a(scene.med_bmax)
        med[:m, 11] = a(scene.med_cos)
        med[:m, 12] = a(scene.med_sin)
        med[:m, 13] = a(scene.med_nid)
        med[:m, 14:17] = a(scene.med_off)
    return torch.as_tensor(med, device=device)


def replay_table(scene: SceneArrays, meta: SceneMeta, tex, *,
                 kernel_space=None) -> ReplayTables:
    """The replay's tables for ``scene``, on the device of ``tex``.

    ``tex`` is any object with the mega2 packer's ``perm``, ``vec``,
    ``texels`` and ``img_dims`` (e.g. the trace's `Mega2Tables`).
    ``kernel_space=(remap, s_pad)`` (`mega2.mega2_kernel_id_space`)
    declares tapes of trace-kernel rows: the merged table is permuted into
    kernel row order (a differentiable gather of NP rows) instead of
    mapping the tape to global ids.  Port of the table assembly of the
    JAX package's ``replay_pallas``."""
    device = tex.perm.device
    rep, med_rows = derive_replay(scene, meta, device)
    M = meta.n_media
    if M > 0:
        med_ext = torch.cat([
            torch.zeros((M, 12), device=device),
            _f32(scene.med_mat, device)[:M, None], med_rows], dim=1)
        rep = torch.cat([rep, med_ext], dim=0)
    if kernel_space is not None:
        remap, s_pad = kernel_space
        perm = remap.to(device=device, dtype=torch.int64).clamp_min(0)
        rep = rep[perm]            # padding rows hold row 0: never selected
        S = int(s_pad)
    else:
        S = scene.sph_c0.shape[0]
    return ReplayTables(
        rep=rep, med=_media_constants(scene, meta, device),
        perm=tex.perm.to(device), vec=tex.vec.to(device),
        texels=tex.texels.to(device), img_dims=tex.img_dims.to(device),
        S=S, med_base=rep.shape[0] - M, n_media=M,
        n_noise=max(meta.n_noise, 1) if meta.has_noise else 1,
        has_checker=bool(meta.has_checker), has_noise=bool(meta.has_noise),
        has_image=bool(meta.has_image))


# --------------------------------------------------------------------------
# the XLA taped replay, in the scene's dtype


def taped_rows(scene: SceneArrays, meta: SceneMeta, der: hit_ops.Derived):
    """The XLA replay's merged rows [S+Q, 27] keyed by global id (the
    layout above) and the media's material rows [M, 14] (None without
    media), gathered from `hit.derive`'s tables ``der`` of a tensor scene
    in its dtype: the JAX package's ``derive_replay``."""
    sph, mat = der.sph_tab, der.mat_tab
    rows = [torch.cat([sph[:, 0:11], torch.zeros_like(sph[:, 11:]),
                       sph[:, 11:], mat[scene.sph_mat]], dim=1)]
    if scene.quad_q.shape[0] > 0:
        rows.append(torch.cat([der.quad_tab, mat[scene.quad_mat]], dim=1))
    med_rows = mat[scene.med_mat] if meta.n_media > 0 else None
    return torch.cat(rows, dim=0), med_rows


def taped_record(scene: SceneArrays, meta: SceneMeta, rep, med_rows, o, d,
                 time, t_min, u_med, w) -> HitRecord:
    """HitRecord for a KNOWN winner ``w`` [B] (global id, -1 = miss).

    Re-intersects only the winner from its row of ``rep`` (`taped_rows`,
    one gather).  The tape is authoritative: the winner's t is recomputed
    with the NaN-safe guards, its hit / miss status comes from ``w``
    alone.  Sphere.h:29-58 (direct ``oc`` form) / Quad.h:52-98 (d_plane
    recomputed from the row) / ConstantMedium.h:85-93, expression for
    expression the JAX package's ``taped_record`` (``hit.assemble_record``
    for the record)."""
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]
    NP = S + Q
    w = w.to(torch.int64)
    hit = w >= 0
    kind = torch.where(w < S, 0, torch.where(w < NP, 1, 2))
    row = hit_ops.read_rows(rep, torch.clamp(w, 0, NP - 1))

    # ---- sphere re-intersection (Sphere.h:29-58, direct oc form)
    frac = (time - row[:, 6]) * row[:, 7]
    center = row[:, 0:3] + frac[:, None] * row[:, 3:6]
    rad = row[:, 8]
    oc = o - center
    a = vm.dot(d, d)
    b = vm.dot(oc, d)
    c = vm.dot(oc, oc) - rad * rad
    disc = b * b - a * c
    pos = disc > 0.0
    sq = vm.sqrt_exact(torch.where(pos, disc, 1.0))   # NaN-safe when masked
    inv_a = 1.0 / a
    root1 = (-b - sq) * inv_a
    root2 = (-b + sq) * inv_a
    t_sph = torch.where(root1 > t_min, root1, root2)

    # ---- quad re-intersection (Quad.h:52-64)
    if Q > 0:
        n_u = row[:, 0:3]
        d_plane = vm.dot(n_u, row[:, 9:12])
        denom = vm.dot(d, n_u)
        dok = torch.abs(denom) >= hit_ops.QUAD_PARALLEL_EPS
        t_quad = (d_plane - vm.dot(o, n_u)) / torch.where(dok, denom, 1.0)
    else:
        t_quad = torch.zeros_like(t_sph)

    t = torch.where(kind == 0, t_sph, t_quad)
    i_m = torch.zeros_like(w)
    if meta.n_media > 0:
        # every medium's candidate (the tape generator's arithmetic, so
        # the same t), then the winner's column
        i_m = torch.clamp(w - NP, 0, meta.n_media - 1)
        t_m = hit_ops.medium_candidates(scene, o, d, t_min, u_med)
        t = torch.where(kind == 2, t_m.gather(1, i_m[:, None])[:, 0], t)
    t = torch.where(hit, t, hit_ops.BIG)

    # ---- record assembly (hit.assemble_record, merged row)
    hit_rec = t < hit_ops.BIG * 0.5
    t_safe = torch.where(hit_rec, t, 1.0)
    p = o + t_safe[:, None] * d

    # sphere normal / uv (Sphere.h:40-58 + GetSphereUV:74-81)
    n_out_s = (p - center) / torch.where(rad[:, None] != 0, rad[:, None],
                                         1.0)
    cth, sth = row[:, 9], row[:, 10]
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

    # quad normal / uv (Quad.h:76-98)
    if Q > 0:
        pq = p - row[:, 9:12]
        alpha = (pq * row[:, 3:6]).sum(-1)
        beta = (pq * row[:, 6:9]).sum(-1)
    else:
        alpha = beta = torch.zeros_like(u_s)

    is_sph = kind == 0
    n_out = torch.where(is_sph[:, None], n_out_s, row[:, 0:3])
    uu = torch.where(is_sph, u_s, alpha)
    vv = torch.where(is_sph, v_s, beta)
    mat = row[:, 12]
    mrow = row[:, 13:]
    if meta.n_media > 0:
        is_med = kind == 2
        med_normal = torch.zeros_like(n_out)
        med_normal[:, 0] = 1.0
        n_out = torch.where(is_med[:, None], med_normal, n_out)
        uu = torch.where(is_med, 0.0, uu)
        vv = torch.where(is_med, 0.0, vv)
        mat = torch.where(is_med, scene.med_mat[i_m].to(mat.dtype), mat)
        mrow = torch.where(is_med[:, None],
                           hit_ops.read_rows(med_rows, i_m), mrow)

    front = vm.dot(d, n_out) < 0.0
    normal = torch.where(front[:, None], n_out, -n_out)
    if meta.n_media > 0:
        front = torch.where(is_med, True, front)
        normal = torch.where(is_med[:, None], n_out, normal)

    return HitRecord(t=t, p=p, normal=normal, u=uu, v=vv, front=front,
                     mat=mat.to(torch.int64), hit=hit_rec, mrow=mrow)


def _start(o):
    """The bounce loop's initial throughput, radiance and alive mask."""
    B = o.shape[0]
    return (torch.ones((B, 3), dtype=o.dtype, device=o.device),
            torch.zeros((B, 3), dtype=o.dtype, device=o.device),
            torch.ones(B, dtype=torch.bool, device=o.device))


def generate_tape(scene: SceneArrays, meta: SceneMeta, o, d, time, pix_ctr,
                  sample, *, max_bounces: int, t_min: float,
                  hit_winner_fn=None):
    """Run the bounce loop once (all ``max_bounces``, no early exit) and
    record the winners.

    Returns ``(tape [max_bounces, B] int32, radiance [B, 3])``; the
    radiance is the search's own, for cross-checks.
    ``hit_winner_fn(o, d, time, t_min, u_med) -> (HitRecord, w)`` swaps the
    winner-producing engine (default: ``hit.closest_hit_winner`` over a
    tensor scene).  Differentiates like any torch code: callers that want
    only the tape run it under ``torch.no_grad()`` (`trace_taped`)."""
    if hit_winner_fn is None:
        der = hit_ops.derive(scene)

        def hit_winner_fn(o, d, time, tm, u_med):
            return hit_ops.closest_hit_winner(scene, meta, der, o, d, time,
                                              tm, u_med)

    thr, acc, alive = _start(o)
    ws = []
    for bounce in range(max_bounces):
        u_med = _u_med(meta, pix_ctr, sample, bounce, o.dtype)
        rec, w = hit_winner_fn(o, d, time, t_min, u_med)
        ws.append(torch.where(alive, w, -1).to(torch.int32))
        o, d, thr, acc, alive = advance_from_record(
            scene, meta, rec, o, d, thr, acc, alive, pix_ctr, sample, bounce)
    return torch.stack(ws), acc


def replay(scene: SceneArrays, meta: SceneMeta, tape, o, d, time, pix_ctr,
           sample, *, max_bounces: int, t_min: float):
    """Radiance [B, 3] with the winners of each bounce fixed by ``tape``
    [max_bounces, B] (global ids): the differentiable leg of the taped
    path, O(1) work a segment.  Differentiable in the tensor scene's
    leaves and in ``o``, ``d`` and ``time``."""
    rep, med_rows = taped_rows(scene, meta, hit_ops.derive(scene))
    thr, acc, alive = _start(o)
    for bounce in range(max_bounces):
        u_med = _u_med(meta, pix_ctr, sample, bounce, o.dtype)
        rec = taped_record(scene, meta, rep, med_rows, o, d, time, t_min,
                           u_med, tape[bounce])
        o, d, thr, acc, alive = advance_from_record(
            scene, meta, rec, o, d, thr, acc, alive, pix_ctr, sample, bounce)
    return acc


def trace_taped(scene: SceneArrays, meta: SceneMeta, o, d, time, pix_ctr,
                sample, *, max_bounces: int, t_min: float,
                hit_winner_fn=None):
    """Differentiable radiance, a drop-in for
    ``integrator.trace(differentiable=True)``: the tape once, under
    ``torch.no_grad()`` on detached rays (JAX's ``stop_gradient``: autograd
    keeps none of the search's [B, S] tensors), then the replay."""
    with torch.no_grad():
        tape, _ = generate_tape(
            scene, meta, o.detach(), d.detach(), time.detach(), pix_ctr,
            sample, max_bounces=max_bounces, t_min=t_min,
            hit_winner_fn=hit_winner_fn)
    return replay(scene, meta, tape, o, d, time, pix_ctr, sample,
                  max_bounces=max_bounces, t_min=t_min)


# --------------------------------------------------------------------------
# plain PyTorch version of K3 (its autograd: the plain version of K4)


def _safe_sqrt(x):
    """sqrt with a finite derivative at 0 (``_safe_root(x, 0.5)``)."""
    pos = x > 0.0
    return torch.where(pos, sqrt_f32(torch.where(pos, x, 1.0)), 0.0)


def _safe_cbrt(x):
    """``_safe_root(x, 1/3)``."""
    pos = x > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, x, 1.0), ONE_THIRD),
                       0.0)


def _acos_safe(x):
    return _atan2_poly(_safe_sqrt(1.0 - x * x), x)


def _image_tex(tt: ReplayTables, row, p, ns, kind_q):
    """Nearest texel of the winner's image: sphere UV from the
    object-space normal (rotate-y frame in cols 9/10), quad UV from the
    cached frame (cols 3:12).  Integer texel indices: no gradient."""
    nsx, nsy, nsz = ns
    cth, sth = row[:, 9], row[:, 10]
    ox_n = cth * nsx - sth * nsz
    oz_n = sth * nsx + cth * nsz
    ny_c = torch.clamp(-nsy, -1.0, 1.0)
    theta = _acos_safe(ny_c)
    phi = _atan2_poly(-oz_n, ox_n) + PI
    u_s = phi * INV_2PI
    v_s = theta * INV_PI
    if tt.NP > tt.S:
        pqx = p[0] - row[:, 9]
        pqy = p[1] - row[:, 10]
        pqz = p[2] - row[:, 11]
        u_q = pqx * row[:, 3] + pqy * row[:, 4] + pqz * row[:, 5]
        v_q = pqx * row[:, 6] + pqy * row[:, 7] + pqz * row[:, 8]
        u_s = torch.where(kind_q, u_q, u_s)
        v_s = torch.where(kind_q, v_q, v_s)
    uu = torch.clamp(u_s, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v_s, 0.0, 1.0)
    img_id = row[:, 26]
    out = [torch.zeros_like(uu) for _ in range(3)]
    for i, (iw, ih, off) in enumerate(tt.img_dims.tolist()):
        ix = torch.clamp_max((uu * float(iw)).to(torch.int64), iw - 1)
        iy = torch.clamp_max((vv * float(ih)).to(torch.int64), ih - 1)
        packed = tt.texels[off + iy, ix]
        ci = [((packed >> sh) & 255).to(torch.float32) * INV255
              for sh in (16, 8, 0)]
        if tt.n_images == 1:
            out = ci
        else:
            sel = img_id == float(i)
            out = [torch.where(sel, c, o) for c, o in zip(ci, out)]
    absent = img_id < 0.0                          # missing image: cyan
    return [torch.where(absent, v, o) for v, o in zip((0.0, 1.0, 1.0), out)]


def _media_t(tt: ReplayTables, o, d, a, inv_a, win, pix_ctr, samp, k, t,
             t_min):
    """The winning medium's stochastic scatter t, recomputed with the
    trace's expressions and MEDIUM_STREAM draw (boundaries are constants;
    only o and d carry gradients)."""
    ox, oy, oz = o
    dx, dy, dz = d
    ray_len = sqrt_f32(torch.where(a > 0.0, a, 1.0))
    med = tt.med.tolist()
    for m in range(tt.n_media):
        r = med[m]
        w0 = rng.pcg4d(pix_ctr, samp,
                       torch.full_like(pix_ctr,
                                       rng.to_word(rng.MEDIUM_STREAM | k)),
                       torch.full_like(pix_ctr, m))[0]
        u_m = rng.unit(w0) + INV24                       # (0, 1]
        if int(r[0]) == MED_BOX:
            c2, s2 = r[11], r[12]
            pox, poy, poz = ox - r[14], oy - r[15], oz - r[16]
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
            t0m = torch.maximum(torch.maximum(torch.minimum(ta1, tb1),
                                              torch.minimum(ta2, tb2)),
                                torch.minimum(ta3, tb3))
        else:
            ocx, ocy, ocz = ox - r[1], oy - r[2], oz - r[3]
            bm = ocx * dx + ocy * dy + ocz * dz
            rad = np.float32(r[4])
            ccm = ocx * ocx + ocy * ocy + ocz * ocz - float(rad * rad)
            discm = bm * bm - a * ccm
            posm = discm > 0.0
            sqm = sqrt_f32(torch.where(posm, discm, 1.0))
            t0m = (-bm - sqm) * inv_a
        t0c = torch.maximum(torch.maximum(t0m, torch.full_like(t0m, t_min)),
                            torch.zeros_like(t0m))
        hit_dm = r[13] * torch.log(u_m)
        t_m = t0c + hit_dm / ray_len
        t = torch.where(win == tt.med_base + m, t_m, t)
    return t


def _replay_bounce(tt: ReplayTables, state, bg, win, act, pix_ctr, samp,
                   k: int, t_min: float):
    """One replayed bounce over [N] lanes (``_make_bounce``).  ``state`` is
    (ox, oy, oz, dx, dy, dz, tm, thr_r, thr_g, thr_b); returns (new state,
    radiance delta (r, g, b), alive)."""
    ox, oy, oz, dx, dy, dz, tm, thr_r, thr_g, thr_b = state
    hit = win >= 0
    kind_q = win >= tt.S
    kind_m = None
    if tt.n_media:
        kind_m = win >= tt.med_base
        kind_q = kind_q & ~kind_m
    row = tt.rep[win.clamp(0, tt.NP - 1).long()]
    c = lambda j: row[:, j]

    # sphere re-intersection (moving centre)
    frac = (tm - c(6)) * c(7)
    cx = c(0) + frac * c(3)
    cy = c(1) + frac * c(4)
    cz = c(2) + frac * c(5)
    rad = c(8)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - a * cc
    pos = disc > 0.0
    sq = sqrt_f32(torch.where(pos, disc, 1.0))
    inv_a = 1.0 / torch.where(a > 0.0, a, 1.0)
    root1 = (-b - sq) * inv_a
    root2 = (-b + sq) * inv_a
    t_sph = torch.where(root1 > t_min, root1, root2)

    # quad re-intersection
    nqx, nqy, nqz = c(0), c(1), c(2)
    d_plane = nqx * c(9) + nqy * c(10) + nqz * c(11)
    denom = dx * nqx + dy * nqy + dz * nqz
    dok = torch.abs(denom) >= EPS8
    t_quad = (d_plane - (ox * nqx + oy * nqy + oz * nqz)) / \
        torch.where(dok, denom, 1.0)
    t = torch.where(kind_q, t_quad, t_sph)
    if tt.n_media:
        t = _media_t(tt, (ox, oy, oz), (dx, dy, dz), a, inv_a, win, pix_ctr,
                     samp, k, t, t_min)

    t = torch.where(hit, t, BIG)
    hit_rec = t < HALF_BIG
    t_safe = torch.where(hit_rec, t, 1.0)
    px = ox + t_safe * dx
    py = oy + t_safe * dy
    pz = oz + t_safe * dz

    inv_rad = 1.0 / torch.where(rad != 0.0, rad, 1.0)
    nsx = (px - cx) * inv_rad
    nsy = (py - cy) * inv_rad
    nsz = (pz - cz) * inv_rad
    n_outx = torch.where(kind_q, nqx, nsx)
    n_outy = torch.where(kind_q, nqy, nsy)
    n_outz = torch.where(kind_q, nqz, nsz)
    if tt.n_media:
        n_outx = torch.where(kind_m, 1.0, n_outx)
        n_outy = torch.where(kind_m, 0.0, n_outy)
        n_outz = torch.where(kind_m, 0.0, n_outz)
    d_dot_n = dx * n_outx + dy * n_outy + dz * n_outz
    front = d_dot_n < 0.0
    if tt.n_media:
        front = front | kind_m
    flip = torch.where(front, 1.0, -1.0)
    nx_, ny_, nz_ = n_outx * flip, n_outy * flip, n_outz * flip

    # material and texture
    kind, fuzz, ior = c(13), c(14), c(15)
    texr, texg, texb = c(17), c(18), c(19)
    if tt.has_checker:
        inv_s = c(23)
        cells = (torch.floor(inv_s * px).to(torch.int64)
                 + torch.floor(inv_s * py).to(torch.int64)
                 + torch.floor(inv_s * pz).to(torch.int64))
        odd = (c(16) == float(TEX_CHECKER)) & ((cells & 1) != 0)
        texr = torch.where(odd, c(20), texr)
        texg = torch.where(odd, c(21), texg)
        texb = torch.where(odd, c(22), texb)
    if tt.has_noise:
        is_nz = c(16) == float(TEX_NOISE)
        turb = _perlin_turb(tt, 0, px, py, pz)
        for tbl in range(1, tt.n_noise):
            turb = torch.where(c(25) == float(tbl),
                               _perlin_turb(tt, tbl, px, py, pz), turb)
        marble = 0.5 * (1.0 + torch.sin(c(24) * pz + 10.0 * turb))
        texr = torch.where(is_nz, marble, texr)
        texg = torch.where(is_nz, marble, texg)
        texb = torch.where(is_nz, marble, texb)
    if tt.has_image:
        is_im = c(16) == float(TEX_IMAGE)
        im = _image_tex(tt, row, (px, py, pz), (nsx, nsy, nsz), kind_q)
        texr = torch.where(is_im, im[0], texr)
        texg = torch.where(is_im, im[1], texg)
        texb = torch.where(is_im, im[2], texb)

    is_light = kind == float(MAT_DIFFUSE_LIGHT)
    miss = act & ~hit_rec
    alive = act & hit_rec
    lit = alive & is_light
    dacc = [torch.where(miss, th * bg[..., i], 0.0)
            + torch.where(lit, th * tx, 0.0)
            for i, (th, tx) in enumerate(((thr_r, texr), (thr_g, texg),
                                          (thr_b, texb)))]

    # scatter (SCATTER_STREAM | k)
    w = rng.pcg4d(pix_ctr, samp,
                  torch.full_like(pix_ctr,
                                  rng.to_word(rng.SCATTER_STREAM | k)),
                  torch.zeros_like(pix_ctr))
    u1, u2, u3, u4 = (rng.unit(x) for x in w)
    d_len = _safe_sqrt(a)
    dls = torch.where(d_len > 0.0, d_len, 1.0)
    udx, udy, udz = dx / dls, dy / dls, dz / dls
    zb = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    rho = _safe_sqrt(1.0 - zb * zb)
    r_b = _safe_cbrt(u3)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    bx = r_b * rho * cphi
    by = r_b * rho * sphi
    bz = r_b * zb

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
    cos_t = torch.minimum(-(udx * nx_ + udy * ny_ + udz * nz_),
                          torch.ones_like(udx))
    sin_t = _safe_sqrt(1.0 - cos_t * cos_t)
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    om = 1.0 - cos_t
    om2 = om * om
    reflectance = r0 + (1.0 - r0) * (om * (om2 * om2))   # x**5 as XLA does
    do_refl = cannot | (reflectance > u4)
    ratio_safe = torch.where(cannot, 0.0, ratio)
    fx = ratio_safe * (udx + cos_t * nx_)
    fy = ratio_safe * (udy + cos_t * ny_)
    fz = ratio_safe * (udz + cos_t * nz_)
    kk = torch.abs(1.0 - (fx * fx + fy * fy + fz * fz))
    par = -_safe_sqrt(kk)
    ddx = torch.where(do_refl, rx, fx + par * nx_)
    ddy = torch.where(do_refl, ry, fy + par * ny_)
    ddz = torch.where(do_refl, rz, fz + par * nz_)

    is_l = kind == float(MAT_LAMBERTIAN)
    is_m = kind == float(MAT_METAL)
    is_d = kind == float(MAT_DIELECTRIC)
    newx = torch.where(is_l, lx, udx)
    newy = torch.where(is_l, ly, udy)
    newz = torch.where(is_l, lz, udz)
    newx = torch.where(is_m, mx, newx)
    newy = torch.where(is_m, my, newy)
    newz = torch.where(is_m, mz, newz)
    newx = torch.where(is_d, ddx, newx)
    newy = torch.where(is_d, ddy, newy)
    newz = torch.where(is_d, ddz, newz)
    if tt.n_media:
        is_i = kind == float(MAT_ISOTROPIC)
        newx = torch.where(is_i, rho * cphi, newx)
        newy = torch.where(is_i, rho * sphi, newy)
        newz = torch.where(is_i, zb, newz)

    att = [torch.where(is_d, 1.0, x) for x in (texr, texg, texb)]
    scattered = (~is_m | metal_ok) & ~is_light
    alive2 = alive & scattered
    sel = lambda n, o_: torch.where(alive2, n, o_)
    state = (sel(px, ox), sel(py, oy), sel(pz, oz),
             sel(newx, dx), sel(newy, dy), sel(newz, dz), tm,
             sel(thr_r * att[0], thr_r), sel(thr_g * att[1], thr_g),
             sel(thr_b * att[2], thr_b))
    return state, dacc, alive2


def replay_plain(tt: ReplayTables, rays: torch.Tensor, tape: torch.Tensor,
                 pix_ctr: torch.Tensor, sample: int, bg: torch.Tensor, *,
                 t_min: float) -> torch.Tensor:
    """Radiance [N, 3] of the lanes' paths with winners fixed by ``tape``
    [K, N] (rows of ``tt.rep``; -1 miss / ended).  ``rays`` [N, 7]
    (origin, direction, time), ``pix_ctr`` [N] int32 RNG keys, ``sample``
    the sample id, ``bg`` [3] the background (or [N, 3], one per lane).
    Differentiable in ``tt.rep``, ``rays`` and ``bg``."""
    samp = torch.full_like(pix_ctr, rng.to_word(int(sample)))
    ones = torch.ones_like(rays[:, 0])
    state = (*rays.unbind(1), ones, ones, ones)
    act = torch.ones_like(pix_ctr, dtype=torch.bool)
    acc = [torch.zeros_like(ones) for _ in range(3)]
    for k in range(tape.shape[0]):
        state, dacc, act = _replay_bounce(tt, state, bg, tape[k], act,
                                          pix_ctr, samp, k, t_min)
        acc = [x + y for x, y in zip(acc, dacc)]
    return torch.stack(acc, dim=1)
