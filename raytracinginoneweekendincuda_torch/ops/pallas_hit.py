"""The wavefront_pallas hit stage: geometry packer, kernel K6 and its plain
version.

K6 (``csrc/closest_geo.cu``) replaces the Pallas kernel
``raytracinginoneweekendincuda_tpu/ops/pallas_hit.py::_make_kernel``: the
closest geometry hit ``(t, prim)`` over all spheres, then all quads, for a
batch of rays.  The first index wins a tie, spheres use ``t > t_min`` and
quads ``t >= t_min``; ``prim`` is a padded-table id (sphere lane, or
``S_pad`` + quad lane), -1 for a miss.  A thread of a persistent grid
takes one ray at a time and walks every active primitive
(``csrc/xla_pair.cuh``, shared with K5), reading each primitive's row from
its block's copy of the tables in shared memory (or from global memory,
in the other instantiation, when the rows exceed the opt-in): the pair
loop's instruction issue bounds it; the only device-memory traffic is the
ray in and the winner out, 40 bytes a ray, and the tables.

`closest_geo_plain` is the same arithmetic in PyTorch, in the same order
(frac, centre, oc, half-b, cc, disc, inv_a = 1/a, then the roots).
`closest_geo` dispatches by device: a CPU tensor takes the plain version,
a CUDA tensor launches K6, anything else raises.  Record assembly and the
media stay in plain PyTorch (`ops/hit.py`), as they stay in XLA in the
JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.samplers import sqrt_f32
from . import hit as hit_ops

LANES = 128
BIG = float(np.float32(hit_ops.BIG))
EPS8 = float(np.float32(hit_ops.QUAD_PARALLEL_EPS))
SPH_ACTIVE = 9     # sphere rows: c0(3) dc(3) t0 inv_dt rad active
QUAD_ACTIVE = 12   # quad rows: n_unit(3) d_plane vxw(3) q_vxw wxu(3) q_wxu
                   # active
# rows a plain-version pass evaluates at once (bounds its [rays, prims]
# intermediates)
_PLAIN_PAIRS = 1 << 24


def _pad_cols(a: np.ndarray, n: int) -> np.ndarray:
    return np.pad(a, [(0, 0), (0, n - a.shape[1])])


def pack_geometry(scene, device="cuda"):
    """Scene arrays -> (sphere table [10, S_pad], quad table [13, Q_pad])
    f32 on ``device``, S_pad and Q_pad multiples of 128, with an explicit
    ``active`` row (padding is dead by mask, not by construction: a
    radius-0 sphere far away can still produce an f32 false positive).

    Sphere rows: c0(3) dc(3) t0 inv_dt rad active.
    Quad rows:   n_unit(3) d_plane vxw(3) q_vxw wxu(3) q_wxu active."""
    from .render import resolve_device

    dev = resolve_device(device)
    f = np.float32
    sph = np.concatenate([
        np.asarray(scene.sph_c0, f).T, np.asarray(scene.sph_dc, f).T,
        np.asarray(scene.sph_t0, f)[None], np.asarray(scene.sph_inv_dt, f)[None],
        np.asarray(scene.sph_rad, f)[None],
        np.asarray(scene.sph_active, f)[None]], 0)
    s_pad = max(LANES, -(-sph.shape[1] // LANES) * LANES)
    sph = _pad_cols(sph, s_pad)

    # the derived quad frame in f32, as hit.derive_quads computes it
    t = lambda a: torch.as_tensor(np.asarray(a, f))
    dq = hit_ops.derive_quads(scene._replace(
        quad_u=t(scene.quad_u), quad_v=t(scene.quad_v),
        quad_q=t(scene.quad_q)))
    n = lambda k: dq[k].numpy()
    quad = np.concatenate([
        n("n_unit").T, n("d_plane")[None], n("vxw").T, n("q_vxw")[None],
        n("wxu").T, n("q_wxu")[None],
        np.asarray(scene.quad_active, f)[None]], 0)
    q_pad = max(LANES, -(-quad.shape[1] // LANES) * LANES)
    quad = _pad_cols(quad, q_pad)
    return (torch.as_tensor(sph, device=dev).contiguous(),
            torch.as_tensor(quad, device=dev).contiguous())


# --------------------------------------------------------------------------
# the plain version (shared with K5's plain version, ops/mega.py)


def sphere_quad_t(o, d, tm, sph, quad, t_min: float, s_active: int,
                  q_active: int):
    """[B, S_pad + Q_pad] candidate t (BIG = none) of rays ``o``, ``d``
    [B, 3] and times ``tm`` [B] against the row-major tables ``sph``
    [rows, S_pad] and ``quad`` [rows, Q_pad] (rows 0-8 / 0-11 as in
    `pack_geometry`; the active rows are given)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    tmv = tm[:, None]
    a = dx * dx + dy * dy + dz * dz
    row = lambda r: sph[r][None, :]
    frac = (tmv - row(6)) * row(7)
    cx = row(0) + frac * row(3)
    cy = row(1) + frac * row(4)
    cz = row(2) + frac * row(5)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz                 # half-b
    rad = row(8)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - a * cc
    sq = sqrt_f32(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    r1 = (-b - sq) * inv_a
    r2 = (-b + sq) * inv_a
    t_c = torch.where(r1 > t_min, r1, r2)
    ok = (disc > 0.0) & (t_c > t_min) & (row(s_active) > 0.5)
    t_s = torch.where(ok, t_c, BIG)

    row = lambda r: quad[r][None, :]
    nx, ny, nz = row(0), row(1), row(2)
    denom = dx * nx + dy * ny + dz * nz
    den_ok = torch.abs(denom) >= EPS8
    t_c = (row(3) - (ox * nx + oy * ny + oz * nz)) / torch.where(
        den_ok, denom, 1.0)
    px, py, pz = ox + t_c * dx, oy + t_c * dy, oz + t_c * dz
    alpha = px * row(4) + py * row(5) + pz * row(6) - row(7)
    beta = px * row(8) + py * row(9) + pz * row(10) - row(11)
    ok = (den_ok & (t_c >= t_min) & (alpha >= 0.0) & (alpha <= 1.0)
          & (beta >= 0.0) & (beta <= 1.0) & (row(q_active) > 0.5))
    t_q = torch.where(ok, t_c, BIG)
    return torch.cat([t_s, t_q], dim=1)


def closest_rows(o, d, tm, sph, quad, t_min: float, s_active: int,
                 q_active: int):
    """(t [B] f32, prim [B] i32) of the closest candidate of
    `sphere_quad_t`: the first index of the minimum, -1 (and t = BIG) when
    none.  Evaluated in row blocks to bound the [B, S+Q] intermediates."""
    n_prims = sph.shape[1] + quad.shape[1]
    step = max(1, _PLAIN_PAIRS // n_prims)
    ts, ps = [], []
    for i in range(0, o.shape[0], step):
        t_all = sphere_quad_t(o[i:i + step], d[i:i + step], tm[i:i + step],
                              sph, quad, t_min, s_active, q_active)
        t = t_all.amin(dim=1)
        p = hit_ops.first_argmin(t_all, t)
        ts.append(t)
        ps.append(torch.where(t < BIG, p, -1).to(torch.int32))
    return torch.cat(ts), torch.cat(ps)


def closest_geo_plain(ray_pack, sph_tab, quad_tab, t_min: float):
    """K6 in plain PyTorch: ``ray_pack`` [B, 8] f32 (o, d, time, pad),
    tables from `pack_geometry` -> (t [B] f32, prim [B] i32)."""
    return closest_rows(ray_pack[:, 0:3], ray_pack[:, 3:6], ray_pack[:, 6],
                        sph_tab, quad_tab, float(np.float32(t_min)),
                        SPH_ACTIVE, QUAD_ACTIVE)


# --------------------------------------------------------------------------
# K6: the CUDA kernel, its wrapper and the dispatcher


def load_kernel():
    """Build (at first use) and load K6; returns (CDLL, build record)."""
    from ..utils.cuda_build import load_library

    lib, record = load_library("closest_geo")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.closest_geo_launch.argtypes = [p, i, p, i, p, i, ctypes.c_float, p,
                                       p, ctypes.POINTER(i), p]
    lib.closest_geo_launch.restype = ctypes.c_int
    return lib, record


def _check_f32(name: str, x: torch.Tensor, dev, rows: int | None = None):
    if x.device != dev or x.dtype != torch.float32 or x.dim() != 2 \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D f32 tensor on "
                         f"{dev}")
    if rows is not None and x.shape[0] != rows:
        raise ValueError(f"{name} must have {rows} rows, got {x.shape[0]}")


def closest_geo_cuda(ray_pack, sph_tab, quad_tab, t_min: float):
    """K6 on the card: `closest_geo_plain`'s (t, prim) for CUDA tensors.
    Launches on the current stream and does not synchronise;
    ``closest_geo_cuda.shape`` holds the last launch's (blocks, threads a
    block, shared bytes: 0 when the tables stay in global memory)."""
    dev = ray_pack.device
    if dev.type != "cuda":
        raise ValueError(f"closest_geo_cuda needs CUDA tensors, got {dev}")
    _check_f32("ray_pack", ray_pack, dev)
    if ray_pack.shape[1] != 8 or ray_pack.data_ptr() % 16:
        raise ValueError("ray_pack must be [B, 8], 16-byte aligned")
    _check_f32("sph_tab", sph_tab, dev, 10)
    _check_f32("quad_tab", quad_tab, dev, 13)
    n = ray_pack.shape[0]
    lib, _ = load_kernel()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    p = torch.empty(n, dtype=torch.int32, device=dev)
    shape = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.closest_geo_launch(
            ray_pack.data_ptr(), n, sph_tab.data_ptr(), sph_tab.shape[1],
            quad_tab.data_ptr(), quad_tab.shape[1], float(np.float32(t_min)),
            t.data_ptr(), p.data_ptr(), shape, stream)
    if err != 0:
        raise RuntimeError(f"closest_geo kernel launch failed: CUDA error "
                           f"{err}")
    closest_geo_cuda.launches += 1
    closest_geo_cuda.shape = tuple(shape)
    return t, p


closest_geo_cuda.launches = 0
closest_geo_cuda.shape = None


def closest_geo(ray_pack, sph_tab, quad_tab, t_min: float):
    """(t [B], prim [B]): the plain version for CPU tensors, K6 for CUDA
    tensors.  No fallback between them."""
    if ray_pack.device.type == "cpu":
        return closest_geo_plain(ray_pack, sph_tab, quad_tab, t_min)
    if ray_pack.device.type == "cuda":
        return closest_geo_cuda(ray_pack, sph_tab, quad_tab, t_min)
    raise ValueError(f"no closest_geo for device {ray_pack.device}")


def make_pallas_hit_fn(scene, meta, sph_tab, quad_tab):
    """``hit_fn(o, d, time, t_min, u_med) -> HitRecord`` around K6 for a
    tensor scene (`hit.scene_tensors`); record assembly and media in plain
    PyTorch.  Rays of any float dtype are packed to f32 for the kernel and
    ``t`` is cast back."""
    S_pad = sph_tab.shape[1]
    S = scene.sph_c0.shape[0]
    der = hit_ops.derive(scene)

    def hit_fn(o, d, time, tm, u_med):
        ray_pack = torch.cat([o, d, time[:, None],
                              torch.zeros_like(time)[:, None]],
                             dim=1).to(torch.float32).contiguous()
        t_geo, p = closest_geo(ray_pack, sph_tab, quad_tab, tm)
        p = p.to(torch.int64)
        # padded-table id -> compiled-scene global id (spheres first)
        best_p = torch.where(p >= S_pad, p - S_pad + S, p)
        best_p = torch.where(p < 0, -1, best_p)
        return hit_ops.record_from_geo_winner(
            scene, meta, der, o, d, time, tm, u_med, t_geo.to(o.dtype),
            best_p)

    return hit_fn
