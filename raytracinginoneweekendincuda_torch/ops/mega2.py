"""The mega2 render path: table packer, kernel K1 and its plain version.

K1 (``csrc/mega2_render.cu``) replaces the persistent Pallas render kernel
``raytracinginoneweekendincuda_tpu/ops/mega2.py::_make_kernel(mode="render")``.
Each lane of a persistent grid runs one flat loop, one ``mega2_bounce``
(``csrc/mega2_bounce.cuh``) an iteration: when its path ends it adds the
path's radiance to its pixel's sum (in sample order, the sum order of the
TPU kernel's sample-sequential refill), starts the pixel's next sample in
the same iteration, and after the last one writes the sum and takes the
next pixel id from a queue (one atomic counter, allocated zeroed for each
launch).  Each block copies the pair rows (spheres, loose quads, box
slabs) into shared memory when they fit a block's opt-in shared memory;
a larger world's rows are read from global memory (the launch decides).

What bounds it on an H100: a lane-bounce's closest hit.  In a world of
several sphere chunks the lane walks a tree of the spheres
(`sphere_tree`; ~34 node boxes and ~2 spheres a lane-bounce on the
benchmark's worlds, `tools/tree_walk.py`), in a world large enough for
the JAX package's chunk cull it tests every row of the 64-row chunks whose
box its ray may meet, and otherwise every sphere row; loose quad and box
rows are tested every one.  So the time is lane-bounces x tests over the
rate of lanes that do useful work; the flat loop and the queue keep lanes
busy until the frame's tail (no lane waits for its warp's longest path),
and rows and tree nodes in shared memory cost the loops less than L1
broadcasts do.  Which lane renders which pixel
varies from run to run, a pixel's sum does not: the RNG is keyed on
(pixel, sample, bounce).

``render_radiance_plain`` is the same function in plain PyTorch: batched
over rays, looping over samples and bounces with masks, in the same op
order; it tests every sphere row, which finds the tree's winner wherever
the f32 hit lies in its sphere's box (``tools/tree_walk.py`` emulates the
walk).  ``render_radiance`` dispatches by device: a CPU tensor takes the
plain version, a CUDA tensor launches K1, anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.samplers import sqrt_f32, unit_ball
from ..scene.compiler import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_METAL, MED_BOX, TEX_CHECKER, TEX_IMAGE, TEX_NOISE, SceneArrays,
    SceneMeta,
)
from ..utils import tracing
from ..utils.config import RenderConfig
from .raygen import camera_tuple, generate_rays, pixel_counter

CULL_C = 64        # rows of a chunk, the row padding multiple of the
                   # sphere / quad / box tables
CULL_COLS = 8      # chunk boxes: 0:3 lo, 3:6 hi (f32 of the f64 bounds)
# The JAX package's cull rule: a world whose pair-tested rows (spheres and
# loose quads) exceed DENSE_MAX culls their chunks, and box chunks are
# culled in any world, in both cases only beyond CULL_MIN_CHUNKS chunks in
# all (ops/mega2.py there: DENSE_MAX, CULL_MIN_CHUNKS, _pair_mode).
DENSE_MAX = 1536
CULL_MIN_CHUNKS = 48
SPH_COLS = 16      # 0:3 c0, 3:6 dc, 6 t0, 7 inv_dt, 8 rad, 9 active,
                   # 10 rad^2 (squared in f32 on the host)
QUAD_COLS = 16     # 0:3 n_unit, 3 D, 4:7 vxw, 7 q.vxw, 8:11 wxu, 11 q.wxu,
                   # 12 active; box slab rows: 0:3 bmin, 3:6 bmax,
                   # 6 local quad row of face 0, 7 active
ATTR_COLS = 40     # 0:3 c0|n_unit, 3:6 dc, 6 t0, 7 inv_dt, 8 rad, 9 is_quad,
                   # 10 kind, 11 fuzz, 12 ior, 13 tex_kind, 14:17 tc0,
                   # 17:20 tc1, 20 inv_scale, 21 uv_cos, 22 uv_sin,
                   # 23 noise scale, 24 img_id, 25 noise table id,
                   # 32:35 vxw, 35 q.vxw, 36:39 wxu, 39 q.wxu (quad UVs)
TREE_COLS = 8      # sphere tree nodes: 0:3 lo, 3:6 hi; a leaf's 6 first
                   # row, 7 rows
TREE_LEAF = 1      # sphere rows a leaf of the tree (PERF.md: 1, 2 and 4
                   # timed on the card)
TREE_MIN_CHUNKS = 2    # K1 walks the tree in an unculled world of at least
                       # this many 64-row chunks of active spheres
MED_COLS = 22      # 0 kind, 1:4 center, 4 radius, 5:8 bmin, 8:11 bmax,
                   # 11 cos, 12 sin, 13 -1/density, 14 radius^2 (squared
                   # in f64, as the JAX kernel squares its python-float
                   # radius), 16:19 offset, 19:22 albedo

BIG = float(np.float32(1.0e30))
TINY = float(np.float32(1.0e-30))
HALF_BIG = float(np.float32(1.0e30 * 0.5))
EPS8 = float(np.float32(1.0e-8))
EPS4 = float(np.float32(1.0e-4))
INV24 = rng.INV_2POW24
HALF_PI = float(np.float32(0.5 * np.pi))
PI = float(np.float32(np.pi))
INV_2PI = float(np.float32(0.5 / np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
INV255 = float(np.float32(1.0 / 255.0))
_ATAN_COEF = tuple(float(np.float32(c)) for c in (
    -0.0117212, 0.05265332, -0.11643287, 0.19354346, -0.33262347,
    0.99997726))
# quad-row offset of the box face hit, per axis (min face, max face): the
# scene compiler emits front(+z), right(+x), back(-z), left(-x), top(+y),
# bottom(-y)
_BOX_OFF = ((3, 1), (5, 4), (2, 0))


class Mega2Tables(NamedTuple):
    """Packed scene tables on one device (see the column notes above)."""
    sph: torch.Tensor       # [s_pad, 16] f32
    quad: torch.Tensor      # [q_pad + b_pad, 16] f32
    attr: torch.Tensor      # [np_rows, 40] f32
    med: torch.Tensor       # [M, 22] f32
    perm: torch.Tensor      # [8 * n_tables, 256] i32
    vec: torch.Tensor       # [24 * n_tables, 256] f32
    texels: torch.Tensor    # [sum ih_pad, iw_pad] i32, (r<<16)|(g<<8)|b
    img_dims: torch.Tensor  # [n_images, 3] i32: iw, ih, texel row offset
    remap: torch.Tensor     # [np_geo + M] i32 kernel row -> global scene id
    cull_s: torch.Tensor    # [max(s_pad / 64, 1), 8] f32 sphere chunk boxes
    cull_q: torch.Tensor    # [max((nl_pad + b_pad) / 64, 1), 8] f32 loose-
                            # quad chunk boxes, then box-slab chunk boxes
    s_pad: int              # sphere rows
    nl_pad: int             # loose-quad rows (pair-tested)
    q_pad: int              # quad rows in attr; box slab rows start here
    b_pad: int              # box slab rows
    n_media: int
    n_noise: int
    cull_pairs: bool        # sphere and loose-quad chunks are culled
    cull_boxes: bool        # box-slab chunks are culled
    tree: torch.Tensor      # [2 * max(tree_n, 1), 8] f32 sphere tree nodes
                            # (heap order from 1; row 0 unused)
    tree_p0: int            # sphere rows tested before the tree's
    tree_n: int             # the tree's leaves; 0: no tree

    @property
    def np_rows(self) -> int:
        return self.attr.shape[0]

    @property
    def n_images(self) -> int:
        return self.img_dims.shape[0]


class FrameParams(NamedTuple):
    """Per-frame constants of the render (camera, background, config)."""
    cam: tuple              # `raygen.camera_tuple`
    background: tuple       # 3 floats
    width: int
    height: int
    spp: int
    seed: int
    max_bounces: int
    t_min: float
    samp0: int = 0          # global id of local sample 0 (a sample window)


def frame_params(scene: SceneArrays, cfg: RenderConfig,
                 samp0: int = 0) -> FrameParams:
    """The frame's constants; ``samp0`` makes a render of ``cfg``'s spp
    samples cover global samples ``samp0 .. samp0 + spp - 1`` (the sample
    axis of a sharded render; the JAX kernel's SMEM scalar ``samp0``)."""
    return FrameParams(
        cam=camera_tuple(scene.camera),
        background=tuple(float(x)
                         for x in np.asarray(scene.camera.background)),
        width=cfg.width, height=cfg.height, spp=cfg.samples_per_pixel,
        seed=cfg.seed, max_bounces=cfg.max_bounces,
        t_min=float(np.float32(cfg.t_min)), samp0=int(samp0))


# --------------------------------------------------------------------------
# host packer (port of the JAX package's pack_mega2_tables)


def _mat_cols(scene: SceneArrays, mat_ids: np.ndarray) -> np.ndarray:
    """[n, 16] material + texture columns (attr cols 10..25)."""
    s = scene
    tid = np.clip(np.asarray(s.mat_tex)[mat_ids], 0, s.tex_kind.shape[0] - 1)
    has_img = np.asarray(s.mat_tex)[mat_ids] >= 0
    img_id = np.where(has_img, np.asarray(s.tex_image)[tid], -1)
    return np.stack([
        np.asarray(s.mat_kind, np.float64)[mat_ids],
        np.asarray(s.mat_fuzz, np.float64)[mat_ids],
        np.asarray(s.mat_ior, np.float64)[mat_ids],
        np.asarray(s.tex_kind, np.float64)[tid],
        *[np.asarray(s.tex_c0, np.float64)[tid][:, i] for i in range(3)],
        *[np.asarray(s.tex_c1, np.float64)[tid][:, i] for i in range(3)],
        np.asarray(s.tex_inv_scale, np.float64)[tid],
        np.zeros(len(mat_ids)),                      # uv_cos (set per prim)
        np.zeros(len(mat_ids)),                      # uv_sin (set per prim)
        np.asarray(s.tex_scale, np.float64)[tid],
        np.asarray(img_id, np.float64),
        np.asarray(s.tex_noise, np.float64)[tid],
    ], axis=1)


def _morton(p: np.ndarray) -> np.ndarray:
    """30-bit Morton code of points [n,3] quantized over their bbox."""
    if p.shape[0] == 0:
        return np.zeros(0, np.int64)
    lo = p.min(0)
    ext = np.maximum(p.max(0) - lo, 1e-12)
    q = np.clip(((p - lo) / ext * 1023.0).astype(np.int64), 0, 1023)
    code = np.zeros(p.shape[0], np.int64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return code


def _sphere_order(c0, dc, rad):
    """Oversized spheres first (they are hit by most rays, which tightens
    the running best early), then Morton order: (order, oversized count)."""
    n = c0.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), 0
    med = np.median(rad) if n > 4 else 0.0
    big = rad > max(10.0 * med, 1e-9)
    return np.lexsort((_morton(c0 + 0.5 * dc), ~big)), int(big.sum())


def sphere_tree(sph: np.ndarray, p0: int, ns: int, leaf: int = TREE_LEAF):
    """The tree K1 walks over sphere rows [p0, ns) of the packed rows
    ``sph`` (f64): (nodes [2n, 8] f32, n leaves), (zeros [2, 8], 0) when the
    range is empty.

    Leaf k holds ``leaf`` consecutive rows from ``p0 + k * leaf`` (fewer in
    the last), so the packer's Morton order groups near spheres.  The n
    leaves are the leaves of the complete binary tree in heap order (root
    1, children 2i and 2i + 1, internal nodes 1 .. n-1, leaves n .. 2n-1),
    leaf k at the k-th leaf from the left, so every node holds a run of
    rows.  A node's box holds its spheres swept over their motion
    (c0 .. c0 + dc, as the chunk boxes), grown by 2^-16 of its largest
    coordinate and rounded outward to f32: a margin far above the rounding
    of the kernel's f32 slab test."""
    if ns <= p0:
        return np.zeros((2, TREE_COLS), np.float32), 0
    rows = ns - p0
    n = -(-rows // leaf)
    r = sph[p0:ns]
    c1 = r[:, 0:3] + r[:, 3:6]
    # boxes as (lo, -hi), so that a union is one minimum
    b = np.empty((n * leaf, 6))
    b[:rows, 0:3] = np.minimum(r[:, 0:3], c1) - r[:, 8:9]
    b[:rows, 3:6] = -(np.maximum(r[:, 0:3], c1) + r[:, 8:9])
    b[rows:] = b[rows - 1]                    # the last leaf's missing rows
    m = n.bit_length() - 1                    # 2^m <= n < 2^(m+1)
    k = np.arange(n)
    deep = 2 * (n - (1 << m))                 # leaves one level deeper
    heap = np.where(k < deep, (1 << (m + 1)) + k, n + k - deep)
    box = np.zeros((2 * n, 6))
    box[heap] = b.reshape(n, leaf, 6).min(1)
    for lev in range(m, -1, -1):              # internal nodes, deepest first
        i0, i1 = 1 << lev, min(2 << lev, n)
        box[i0:i1] = np.minimum(box[2 * i0:2 * i1:2],
                                box[2 * i0 + 1:2 * i1:2])
    grow = 2.0 ** -16 * np.abs(box).max(1, keepdims=True)
    out = np.nextafter((box - grow).astype(np.float32),
                       np.float32(-np.inf))
    nodes = np.zeros((2 * n, TREE_COLS), np.float32)
    nodes[1:, 0:3] = out[1:, 0:3]
    nodes[1:, 3:6] = -out[1:, 3:6]
    nodes[heap, 6] = p0 + k * leaf
    nodes[heap, 7] = np.minimum(leaf, rows - k * leaf)
    return nodes, n


def _detect_boxes(qact_idx, q_all, u_all, v_all):
    """Axis-aligned boxes among the active quads: six consecutive rows that
    match the scene compiler's ``_box_quads`` face pattern exactly (rotated
    boxes fail the check and stay loose quads).  Returns a list of
    (orig_ids[6], bmin[3], bmax[3])."""
    out = []
    j = 0
    idx = np.asarray(qact_idx)
    while j + 6 <= len(idx):
        ids = idx[j:j + 6]
        if not np.array_equal(ids, ids[0] + np.arange(6)):
            j += 1
            continue
        mn = q_all[ids[5]]
        ext = np.array([u_all[ids[5]][0], v_all[ids[0]][1],
                        v_all[ids[5]][2]])
        if not np.all(ext > 0.0):
            j += 1
            continue
        mx = mn + ext
        w = np.array([ext[0], 0.0, 0.0])
        h = np.array([0.0, ext[1], 0.0])
        d = np.array([0.0, 0.0, ext[2]])
        want_q = np.stack([
            [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
            [mx[0], mn[1], mn[2]], [mn[0], mn[1], mn[2]],
            [mn[0], mx[1], mx[2]], [mn[0], mn[1], mn[2]]])
        want_u = np.stack([w, -d, -w, d, w, w])
        want_v = np.stack([h, h, h, h, -d, d])
        if (np.array_equal(q_all[ids], want_q)
                and np.array_equal(u_all[ids], want_u)
                and np.array_equal(v_all[ids], want_v)):
            out.append((ids, mn, mx))
            j += 6
        else:
            j += 1
    return out


def _pack_textures(scene: SceneArrays, meta: SceneMeta):
    """Perlin tables and packed texels -> (perm, vec, texels, img_dims).

    perm rows per table t (stride 8): px, px, py, py, pz, pz, 0, 0; vec
    rows (stride 24): vx x8, vy x8, vz x8 -- the JAX package's layout, so
    the tables compare equal.  Texels: per image, [ih_pad, iw_pad] i32
    rows of (r<<16)|(g<<8)|b, stacked; img_dims rows (iw, ih, row offset).
    A scene whose image textures have no image data (the file could not be
    decoded) gets one empty plane; its texture reads debug cyan."""
    with tracing.span("pack.textures"):
        tables = _texture_tables(scene, meta)
    # perm, vec and texels as uploaded: 4-byte elements
    tracing.count("texture_bytes", sum(t.size * 4 for t in tables[:3]))
    return tables


def _texture_tables(scene: SceneArrays, meta: SceneMeta):
    n_noise = max(meta.n_noise, 1) if meta.has_noise else 1
    perm = np.zeros((8 * n_noise, 256), np.int32)
    vec = np.zeros((24 * n_noise, 256), np.float64)
    if meta.has_noise:
        for t in range(meta.n_noise):
            for a, p in enumerate((scene.perlin_px, scene.perlin_py,
                                   scene.perlin_pz)):
                perm[8 * t + 2 * a] = perm[8 * t + 2 * a + 1] = \
                    np.asarray(p)[t]
            v = np.asarray(scene.perlin_vec, np.float64)[t]       # [256,3]
            for a in range(3):
                vec[24 * t + a * 8:24 * t + (a + 1) * 8] = v[:, a]

    if meta.has_image and meta.n_images > 0:
        ws = np.asarray(scene.img_w)
        hs = np.asarray(scene.img_h)
        iw_pad = max(-(-int(w) // 128) * 128 for w in ws[:meta.n_images])
        dims, planes, off = [], [], 0
        for i in range(meta.n_images):
            iw, ih = int(ws[i]), int(hs[i])
            img = np.asarray(scene.img_data, np.float64)[i][:ih, :iw]
            b = np.clip(np.round(img * 255.0), 0, 255).astype(np.int64)
            ih_pad = -(-ih // 8) * 8
            plane = np.zeros((ih_pad, iw_pad), np.int32)
            plane[:ih, :iw] = ((b[..., 0] << 16) | (b[..., 1] << 8)
                               | b[..., 2]).astype(np.int32)
            planes.append(plane)
            dims.append((iw, ih, off))
            off += ih_pad
        texels = np.concatenate(planes, axis=0)
        img_dims = np.asarray(dims, np.int32)
    else:
        texels = np.zeros((8, 128), np.int32)
        img_dims = np.zeros((0, 3), np.int32)
    return perm, vec, texels, img_dims


def pack_mega2_tables(scene: SceneArrays, meta: SceneMeta, device, *,
                      dense_max: int = DENSE_MAX,
                      cull_min_chunks: int = CULL_MIN_CHUNKS) -> Mega2Tables:
    """Compiled scene (numpy) -> the port's tables on ``device``.

    Row order and f32 rounding follow the JAX package's packer exactly
    (ties go to the lowest row, so the order decides winners): spheres
    big-first then Morton, then loose quads (Morton), boxed faces, padding,
    and box slab rows.  Attributes are row-major [np_rows, 40].  Each
    64-row chunk gets a box (spheres swept over their motion, loose quads
    over their corners, box slabs over their boxes; an empty chunk a point
    at 1e30), and the JAX package's rule decides which chunks the closest
    hit culls; ``dense_max`` and ``cull_min_chunks`` move its thresholds
    (``dense_max=0, cull_min_chunks=0`` culls every chunk of any world).
    An unculled world of TREE_MIN_CHUNKS sphere chunks or more gets the
    tree K1 walks for its closest sphere (`sphere_tree`) over its spheres
    but the oversized ones, which K1 tests first."""
    with tracing.span("pack"):
        return _pack_tables(scene, meta, device, dense_max, cull_min_chunks)


def _pack_tables(scene: SceneArrays, meta: SceneMeta, device,
                 dense_max: int, cull_min_chunks: int) -> Mega2Tables:
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]

    # ---- spheres: active rows, reordered, padded to CULL_C
    c0_all = np.asarray(scene.sph_c0, np.float64)
    dc_all = np.asarray(scene.sph_dc, np.float64)
    rad_all = np.asarray(scene.sph_rad, np.float64)
    act_idx = np.nonzero(np.asarray(scene.sph_active))[0]
    order, n_big = _sphere_order(c0_all[act_idx], dc_all[act_idx],
                                 rad_all[act_idx])
    sorder = act_idx[order]
    ns = len(sorder)
    S_pad = max(-(-ns // CULL_C) * CULL_C, CULL_C)
    sph = np.zeros((S_pad, SPH_COLS), np.float64)
    sph[:ns, 0:3] = c0_all[sorder]
    sph[:ns, 3:6] = dc_all[sorder]
    sph[:ns, 6] = np.asarray(scene.sph_t0, np.float64)[sorder]
    sph[:ns, 7] = np.asarray(scene.sph_inv_dt, np.float64)[sorder]
    sph[:ns, 8] = rad_all[sorder]
    sph[:ns, 9] = 1.0
    radf = rad_all[sorder].astype(np.float32)
    sph[:ns, 10] = (radf * radf).astype(np.float64)

    # sphere chunk boxes, swept over the motion (MovingSphere.h:30-36)
    n_s_chunks = S_pad // CULL_C
    cull_s = np.zeros((max(n_s_chunks, 1), CULL_COLS))
    cull_s[:, 0:6] = 1.0e30
    for c in range(n_s_chunks):
        a = sph[c * CULL_C:min((c + 1) * CULL_C, ns)]
        if len(a):
            ends = np.stack([a[:, 0:3], a[:, 0:3] + a[:, 3:6]])
            cull_s[c, 0:3] = (ends.min(0) - a[:, 8:9]).min(0)
            cull_s[c, 3:6] = (ends.max(0) + a[:, 8:9]).max(0)

    # ---- quads: loose quads (Morton) | boxed faces | padding | box rows
    u_all = np.asarray(scene.quad_u, np.float64)
    v_all = np.asarray(scene.quad_v, np.float64)
    q_all = np.asarray(scene.quad_q, np.float64)
    qact_idx = np.nonzero(np.asarray(scene.quad_active))[0]
    boxes = _detect_boxes(qact_idx, q_all, u_all, v_all)
    boxed_ids = np.concatenate([g[0] for g in boxes]) \
        if boxes else np.zeros(0, np.int64)
    loose_ids = np.setdiff1d(qact_idx, boxed_ids)
    qcent = q_all[loose_ids] + 0.5 * (u_all[loose_ids] + v_all[loose_ids])
    loose_ids = loose_ids[np.argsort(_morton(qcent), kind="stable")] \
        if len(loose_ids) else loose_ids
    nl = len(loose_ids)
    nl_pad = -(-nl // CULL_C) * CULL_C
    if boxes:
        bcent = np.stack([0.5 * (g[1] + g[2]) for g in boxes])
        boxes = [boxes[i] for i in np.argsort(_morton(bcent), kind="stable")]
    nB = len(boxes)
    qorder = np.concatenate(
        [loose_ids] + [g[0] for g in boxes]).astype(np.int64) \
        if (nl or nB) else np.zeros(0, np.int64)
    q_rows = np.concatenate(
        [np.arange(nl), nl_pad + np.arange(6 * nB)]).astype(np.int64) \
        if (nl or nB) else np.zeros(0, np.int64)
    Q_pad = max(-(-(nl_pad + 6 * nB) // CULL_C) * CULL_C, CULL_C)
    B_pad = (-(-nB // CULL_C) * CULL_C) if nB else 0

    u = u_all[qorder]
    v = v_all[qorder]
    qq = q_all[qorder]
    n = np.cross(u, v)
    n_len = np.linalg.norm(n, axis=-1, keepdims=True)
    n_unit = n / np.where(n_len > 0, n_len, 1.0)
    nn = (n * n).sum(-1, keepdims=True)
    w_vec = n / np.where(nn > 0, nn, 1.0)
    vxw = np.cross(v, w_vec)
    wxu = np.cross(w_vec, u)
    quad = np.zeros((Q_pad + B_pad, QUAD_COLS), np.float64)
    quad[q_rows, 0:3] = n_unit
    quad[q_rows, 3] = (n_unit * qq).sum(-1)
    quad[q_rows, 4:7] = vxw
    quad[q_rows, 7] = (qq * vxw).sum(-1)
    quad[q_rows, 8:11] = wxu
    quad[q_rows, 11] = (qq * wxu).sum(-1)
    quad[q_rows, 12] = 1.0
    for g, (_ids, bmn, bmx) in enumerate(boxes):
        quad[Q_pad + g, 0:3] = bmn
        quad[Q_pad + g, 3:6] = bmx
        quad[Q_pad + g, 6] = float(nl_pad + 6 * g)
        quad[Q_pad + g, 7] = 1.0

    # chunk boxes: loose-quad chunks (four corners), then box-slab chunks
    n_q_chunks = nl_pad // CULL_C
    n_b_chunks = B_pad // CULL_C
    cull_q = np.zeros((max(n_q_chunks + n_b_chunks, 1), CULL_COLS))
    cull_q[:, 0:6] = 1.0e30
    for c in range(n_q_chunks):
        r = np.arange(c * CULL_C, min((c + 1) * CULL_C, nl))
        if len(r):
            corners = np.stack([qq[r], qq[r] + u[r], qq[r] + v[r],
                                qq[r] + u[r] + v[r]])
            cull_q[c, 0:3] = corners.min((0, 1))
            cull_q[c, 3:6] = corners.max((0, 1))
    for c in range(n_b_chunks):
        gs = boxes[c * CULL_C:(c + 1) * CULL_C]
        if gs:
            cull_q[n_q_chunks + c, 0:3] = np.stack([g[1] for g in gs]).min(0)
            cull_q[n_q_chunks + c, 3:6] = np.stack([g[2] for g in gs]).max(0)

    # the cull rule (the JAX package's _pair_mode and CULL_MIN_CHUNKS): a
    # world without quads counts no quad or box chunks
    nl_c, b_c = (n_q_chunks, n_b_chunks) if meta.n_quads > 0 else (0, 0)
    many = n_s_chunks + nl_c + b_c > cull_min_chunks
    cull_pairs = many and S_pad + nl_c * CULL_C > dense_max
    cull_boxes = many and b_c > 0

    # the sphere tree of an unculled world with several sphere chunks; the
    # oversized spheres (the ground) stay out of it and are tested first
    if cull_pairs or cull_boxes or n_s_chunks < TREE_MIN_CHUNKS:
        tree, tree_n = np.zeros((2, TREE_COLS), np.float32), 0
    else:
        tree, tree_n = sphere_tree(sph, n_big, ns)
    tracing.count("k1_tree_nodes", 2 * tree_n - 1 if tree_n else 0)
    # the rows K1's loops run over outside the tree on every lane-bounce,
    # padded as K1 runs them: the sphere rows before the tree (every sphere
    # row where there is none), the loose-quad and box-slab rows, the media
    tracing.count("k1_tree_prefix_rows", n_big if tree_n else S_pad)
    tracing.count("k1_loose_quad_rows", nl_pad)
    tracing.count("k1_slab_rows", B_pad)
    tracing.count("k1_media", meta.n_media)

    # ---- winner attributes, row-major
    use_quads = meta.n_quads > 0
    NP = S_pad + (Q_pad if use_quads else 0)
    attr = np.zeros((NP, ATTR_COLS), np.float64)
    attr[:S_pad, 0:9] = sph[:, 0:9]
    attr[:ns, 10:26] = _mat_cols(scene, np.asarray(scene.sph_mat)[sorder])
    attr[:ns, 21] = np.asarray(scene.sph_cos, np.float64)[sorder]
    attr[:ns, 22] = np.asarray(scene.sph_sin, np.float64)[sorder]
    if use_quads:
        attr[S_pad:, 0:3] = quad[:Q_pad, 0:3]
        attr[S_pad:, 9] = 1.0
        attr[S_pad + q_rows, 10:26] = _mat_cols(
            scene, np.asarray(scene.quad_mat)[qorder])
        attr[S_pad + q_rows, 32:35] = vxw
        attr[S_pad + q_rows, 35] = (qq * vxw).sum(-1)
        attr[S_pad + q_rows, 36:39] = wxu
        attr[S_pad + q_rows, 39] = (qq * wxu).sum(-1)

    # ---- constant media
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
    med[:, 16:19] = np.asarray(scene.med_off, np.float64)
    mtid = np.clip(np.asarray(scene.mat_tex)[np.asarray(scene.med_mat)], 0,
                   scene.tex_kind.shape[0] - 1)
    med[:, 19:22] = np.asarray(scene.tex_c0, np.float64)[mtid]
    med[:, 14] = med[:, 4] * med[:, 4]

    perm, vec, texels, img_dims = _pack_textures(scene, meta)

    # ---- kernel row -> global scene id (spheres [0,S), quads [S,S+Q),
    # media [S+Q, S+Q+M)); padding rows are -1
    remap = np.full(NP + M, -1, np.int32)
    remap[:ns] = sorder
    if use_quads:
        remap[S_pad + q_rows] = S + qorder
    for m_i in range(meta.n_media):
        remap[NP + m_i] = S + Q + m_i

    f32 = lambda x: np.asarray(x, np.float32)
    i32 = lambda x: np.asarray(x, np.int32)
    host = dict(sph=f32(sph), quad=f32(quad), attr=f32(attr), med=f32(med),
                perm=i32(perm), vec=f32(vec), texels=i32(texels),
                img_dims=i32(img_dims), remap=i32(remap),
                cull_s=f32(cull_s), cull_q=f32(cull_q), tree=tree)
    with tracing.span("pack.upload"):
        tabs = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    tracing.count("upload_bytes", sum(v.nbytes for v in host.values()))
    return Mega2Tables(
        **tabs,
        s_pad=S_pad, nl_pad=nl_pad, q_pad=Q_pad, b_pad=B_pad,
        n_media=meta.n_media, n_noise=max(meta.n_noise, 1),
        cull_pairs=bool(cull_pairs), cull_boxes=bool(cull_boxes),
        tree_p0=n_big, tree_n=tree_n)


# --------------------------------------------------------------------------
# plain PyTorch version of K1


def _argmin_first(x: torch.Tensor):
    """Row-wise (min, index of its first occurrence) of [N, C]."""
    mn = x.min(dim=1).values
    iota = torch.arange(x.shape[1], device=x.device)
    idx = torch.where(x == mn[:, None], iota, x.shape[1]).min(dim=1).values
    return mn, idx


def _recip(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal directions [N, 3] of the chunk slab test, sanitized as the
    JAX kernel does: no component nearer zero than 1e-30, so no inf and no
    NaN (a near-zero component gives huge finite ts, which the interval
    test takes conservatively)."""
    return 1.0 / torch.where(d >= 0.0, torch.clamp_min(d, TINY),
                             torch.clamp_max(d, -TINY))


def _visible(box, o, inv, t_min: float, best, a=None):
    """The JAX kernel's ``chunk_visible`` per ray (AABB.h:68-98): may the
    ray meet chunk ``box`` [8] within (t_min, best)?  Skipping a chunk the
    ray does not meet changes no winner but a rounding hit on a sphere the
    ray misses (ROADMAP.md, queue 3).  ``a`` [N]: ``best`` is in sphere key
    space (t*a), so the box's near t is scaled by it."""
    ta = (box[0:3][None, :] - o) * inv
    tb = (box[3:6][None, :] - o) * inv
    lo = torch.minimum(ta, tb)
    hi = torch.maximum(ta, tb)
    near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    near_k = near if a is None else near * a
    return (far >= torch.clamp_min(near, t_min)) & (near_k < best)


def _chunks(rows: int, chunk: int, box0: int, cull, o, inv, t_min, best,
            stats, kind: str, a=None):
    """The row chunks a closest-hit loop runs: (first row, rows, the rays
    that take the chunk's result or None for all).  Culled (``cull``):
    64-row chunks, box ``box0 + c`` gating chunk c per ray, and chunks that
    no ray may meet are skipped; ``stats`` counts the slab tests, the
    chunks they let through and those chunks' rows."""
    step = CULL_C if cull is not None else chunk
    for c0 in range(0, rows, step):
        n = min(step, rows - c0)
        if cull is None:
            yield c0, n, None
            continue
        vis = _visible(cull[box0 + c0 // CULL_C], o, inv, t_min, best(), a)
        if stats is not None:
            k = int(vis.sum())
            stats["tests"] += vis.numel()
            stats["chunks"] += k
            stats[kind] += k * n
        if bool(vis.any()):
            yield c0, n, vis


def _take(mn, idx, vis, best, win, base):
    """Merge a chunk's (min, index) into the running (best, win): strict <,
    so an earlier row keeps a tie; only rays in ``vis`` (None: all)."""
    better = mn < best
    if vis is not None:
        better = better & vis
    return torch.where(better, mn, best), torch.where(better, base + idx, win)


def _closest_spheres(tab, o, d, tm, a, akey, t_min, chunk, inv, stats):
    """Closest sphere in key space (key = t*a): per ray (key, row or -1)."""
    n = o.shape[0]
    best = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    win = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    tmc, ac, akc = tm[:, None], a[:, None], akey[:, None]
    cull = tab.cull_s if tab.cull_pairs else None
    for c0, m, vis in _chunks(tab.s_pad, chunk, 0, cull, o, inv, t_min,
                              lambda: best, stats, "sphere_rows", a):
        r = tab.sph[c0:c0 + m]
        col = lambda k: r[:, k][None, :]
        frac = (tmc - col(6)) * col(7)
        cx = col(0) + frac * col(3)
        cy = col(1) + frac * col(4)
        cz = col(2) + frac * col(5)
        ocx = ox - cx
        ocy = oy - cy
        ocz = oz - cz
        b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - col(10)
        disc = b * b - ac * cc
        sq = sqrt_f32(disc)             # NaN where disc < 0: rejected below
        k1 = -b - sq
        k2 = -b + sq
        key = torch.where(k1 > akc, k1, k2)
        # explicit active-row mask: padding rows are not left to disc > 0
        ok = (disc > 0.0) & (key > akc) & (col(9) > 0.5)
        mn, idx = _argmin_first(torch.where(ok, key, BIG))
        best, win = _take(mn, idx, vis, best, win, c0)
    return best, win


def _closest_quads(tab, o, d, t_min, best, win, chunk, inv, stats):
    """Loose quads (quad rows [0, nl_pad)), strict < against ``best``."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    cull = tab.cull_q if tab.cull_pairs else None
    for c0, m, vis in _chunks(tab.nl_pad, chunk, 0, cull, o, inv, t_min,
                              lambda: best, stats, "quad_rows"):
        r = tab.quad[c0:c0 + m]
        col = lambda k: r[:, k][None, :]
        nx, ny, nz = col(0), col(1), col(2)
        denom = dx * nx + dy * ny + dz * nz
        den_ok = torch.abs(denom) >= EPS8
        t_c = (col(3) - (ox * nx + oy * ny + oz * nz)) / \
            torch.where(den_ok, denom, 1.0)
        px = ox + t_c * dx
        py = oy + t_c * dy
        pz = oz + t_c * dz
        alpha = px * col(4) + py * col(5) + pz * col(6) - col(7)
        beta = px * col(8) + py * col(9) + pz * col(10) - col(11)
        ok = (den_ok & (t_c >= t_min) & (alpha >= 0.0) & (alpha <= 1.0)
              & (beta >= 0.0) & (beta <= 1.0) & (col(12) > 0.5))
        mn, idx = _argmin_first(torch.where(ok, t_c, BIG))
        best, win = _take(mn, idx, vis, best, win, tab.s_pad + c0)
    return best, win


def _closest_boxes(tab, o, d, t_min, best, win, chunk, inv, stats):
    """Axis-aligned box slabs (quad rows [q_pad, q_pad + b_pad)).  The
    winner is the quad row of the face hit: the first axis whose plane
    gives the entering (or, from inside, exiting) t."""
    cull = tab.cull_q if tab.cull_boxes else None
    for c0, m, vis in _chunks(tab.b_pad, chunk, tab.nl_pad // CULL_C, cull,
                              o, inv, t_min, lambda: best, stats,
                              "box_rows"):
        r = tab.quad[tab.q_pad + c0:tab.q_pad + c0 + m]
        col = lambda k: r[:, k][None, :]
        nears, fars, sides = [], [], []
        for ax in range(3):
            o_a, d_a = o[:, ax:ax + 1], d[:, ax:ax + 1]
            d_ok = torch.abs(d_a) >= EPS8
            dsafe = torch.where(d_ok, d_a, 1.0)
            t1 = (col(ax) - o_a) / dsafe
            t2 = (col(3 + ax) - o_a) / dsafe
            inside = (o_a >= col(ax)) & (o_a <= col(3 + ax))
            nears.append(torch.where(d_ok, torch.minimum(t1, t2),
                                     torch.where(inside, -BIG, BIG)))
            fars.append(torch.where(d_ok, torch.maximum(t1, t2),
                                    torch.where(inside, BIG, -BIG)))
            sides.append(d_a > 0.0)
        t_enter = torch.maximum(torch.maximum(nears[0], nears[1]), nears[2])
        t_exit = torch.minimum(torch.minimum(fars[0], fars[1]), fars[2])
        use_enter = t_enter >= t_min
        t_box = torch.where(use_enter, t_enter, t_exit)
        valid = (t_enter <= t_exit) & (t_box >= t_min) & (col(7) > 0.5)
        off_e = torch.zeros_like(t_box, dtype=torch.int64)
        off_x = torch.zeros_like(off_e)
        seen_e = torch.zeros_like(valid)
        seen_x = torch.zeros_like(valid)
        for ax in range(3):
            mn_o, mx_o = _BOX_OFF[ax]
            oe = torch.where(sides[ax], mn_o, mx_o)
            oxx = torch.where(sides[ax], mx_o, mn_o)
            hit_e = nears[ax] == t_enter
            hit_x = fars[ax] == t_exit
            off_e = torch.where(~seen_e & hit_e, oe, off_e)
            off_x = torch.where(~seen_x & hit_x, oxx, off_x)
            seen_e = seen_e | hit_e
            seen_x = seen_x | hit_x
        cand = col(6).to(torch.int64) + torch.where(use_enter, off_e, off_x)
        # ties between boxes go to the lowest row (= lowest face row)
        mn, idx = _argmin_first(torch.where(valid, t_box, BIG))
        best, win = _take(mn, cand.gather(1, idx[:, None])[:, 0], vis, best,
                          win, tab.s_pad)
    return best, win


def _media(tab, fp, o, d, a, inv_a, pix_ctr, samp, bounce, best, win):
    """Constant media after the geometry: a medium whose sampled scatter
    distance falls before ``best`` wins (strict <, later media after
    earlier ones).  Returns (best, win, is_med, albedo [N,3])."""
    n = o.shape[0]
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    is_med = torch.zeros(n, dtype=torch.bool, device=o.device)
    alb = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    ray_len = sqrt_f32(a)
    for m in range(tab.n_media):
        r = [float(x) for x in tab.med[m].tolist()]
        w0 = rng.pcg4d(pix_ctr, samp, rng.to_word(rng.MEDIUM_STREAM | bounce),
                       torch.full_like(pix_ctr, m))[0]
        u_m = rng.unit(w0) + INV24                        # (0, 1]
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
            m_valid = t1 > t0
        else:
            ocx, ocy, ocz = ox - r[1], oy - r[2], oz - r[3]
            b = ocx * dx + ocy * dy + ocz * dz
            cc = ocx * ocx + ocy * ocy + ocz * ocz - r[14]
            disc = b * b - a * cc
            sq = sqrt_f32(torch.clamp_min(disc, 0.0))
            t0 = (-b - sq) * inv_a
            t1 = (-b + sq) * inv_a
            m_valid = disc > 0.0
        m_valid = m_valid & (t1 > t0 + EPS4)
        t0c = torch.maximum(torch.maximum(t0, torch.full_like(t0, fp.t_min)),
                            torch.zeros_like(t0))
        m_valid = m_valid & (t0c < t1)
        dist_in = (t1 - t0c) * ray_len
        hit_d = r[13] * torch.log(u_m)
        m_valid = m_valid & (hit_d <= dist_in)
        t_m = t0c + hit_d / ray_len
        mwin = m_valid & (t_m < best)
        best = torch.where(mwin, t_m, best)
        is_med = is_med | mwin
        win = torch.where(mwin, tab.np_rows + m, win)
        alb = torch.where(mwin[:, None],
                          torch.tensor(r[19:22], dtype=torch.float32,
                                       device=o.device), alb)
    return best, win, is_med, alb


def _perlin_noise(tab, table, qx, qy, qz):
    """Lattice gradient noise (Perlin.h:38-60) over the packed tables."""
    px = tab.perm[8 * table + 0]
    py = tab.perm[8 * table + 2]
    pz = tab.perm[8 * table + 4]
    vx = tab.vec[24 * table + 0]
    vy = tab.vec[24 * table + 8]
    vz = tab.vec[24 * table + 16]
    fx, fy, fz = torch.floor(qx), torch.floor(qy), torch.floor(qz)
    ux, uy, uz = qx - fx, qy - fy, qz - fz
    i = fx.to(torch.int64)
    j = fy.to(torch.int64)
    k = fz.to(torch.int64)
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
                h = (pa[di] ^ pb[dj] ^ pc[dk]).to(torch.int64)
                dot = (vx[h] * (ux - di) + vy[h] * (uy - dj)
                       + vz[h] * (uz - dk))
                accum = accum + wu * wv * ww * dot
    return accum


def _perlin_turb(tab, table, qx, qy, qz, depth: int = 7):
    """|sum_i 0.5^i noise(2^i p)| (Perlin.h:64-78)."""
    accum = torch.zeros_like(qx)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * _perlin_noise(tab, table, qx, qy, qz)
        weight *= 0.5
        qx, qy, qz = qx * 2.0, qy * 2.0, qz * 2.0
    return torch.abs(accum)


def _atan2_poly(y, x):
    """Branchless minimax atan2 (the JAX package's ``_atan2_poly``)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    r = num / torch.where(den > 0.0, den, 1.0)
    z2 = r * r
    p = torch.full_like(r, _ATAN_COEF[0])
    for c in _ATAN_COEF[1:]:
        p = p * z2 + c
    a = r * p
    a = torch.where(swap, HALF_PI - a, a)
    a = torch.where(x < 0.0, PI - a, a)
    a = torch.where(y < 0.0, -a, a)
    return torch.where((ax + ay) == 0.0, 0.0, a)


def _acos_poly(x):
    s = sqrt_f32(torch.clamp_min(1.0 - x * x, 0.0))
    return _atan2_poly(s, x)


def _image_tex(tab, aw, p, ns, is_quad):
    """Nearest texel (Texture.h:117-127): sphere UV from the object-space
    normal through the minimax acos/atan2, quad UV from attr 32:40; u
    clamped, v flipped; debug cyan when the image is absent."""
    px, py, pz = p.unbind(1)
    nsx, nsy, nsz = ns.unbind(1)
    cth, sth = aw[:, 21], aw[:, 22]
    ox_n = cth * nsx - sth * nsz
    oz_n = sth * nsx + cth * nsz
    ny_c = torch.clamp(-nsy, -1.0, 1.0)
    theta = _acos_poly(ny_c)
    phi = _atan2_poly(-oz_n, ox_n) + PI
    u_s = phi * INV_2PI
    v_s = theta * INV_PI
    u_q = px * aw[:, 32] + py * aw[:, 33] + pz * aw[:, 34] - aw[:, 35]
    v_q = px * aw[:, 36] + py * aw[:, 37] + pz * aw[:, 38] - aw[:, 39]
    u_s = torch.where(is_quad, u_q, u_s)
    v_s = torch.where(is_quad, v_q, v_s)
    uu = torch.clamp(u_s, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v_s, 0.0, 1.0)
    img_id = aw[:, 24]
    out = torch.zeros_like(p)
    n_img = tab.n_images
    for i, (iw, ih, off) in enumerate(tab.img_dims.tolist()):
        ix = torch.clamp_max((uu * float(iw)).to(torch.int64), iw - 1)
        iy = torch.clamp_max((vv * float(ih)).to(torch.int64), ih - 1)
        packed = tab.texels[off + iy, ix]
        ci = torch.stack([((packed >> 16) & 255), ((packed >> 8) & 255),
                          (packed & 255)], dim=1).to(torch.float32) * INV255
        sel = torch.ones_like(is_quad) if n_img == 1 else img_id == float(i)
        out = torch.where(sel[:, None], ci, out)
    cyan = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float32,
                        device=p.device)
    return torch.where((img_id < 0.0)[:, None], cyan, out)


def _scatter(kind, fuzz, ior, front, is_light, n, d, a, u1, u2, u3, u4):
    """New direction + scattered flag over the five materials (the JAX
    package's ``_scatter_dirs``)."""
    (bx, by, bz), iso = unit_ball(u1, u2, u3)
    nx_, ny_, nz_ = n.unbind(1)
    inv_dlen = 1.0 / sqrt_f32(a)
    udx, udy, udz = (d[:, k] * inv_dlen for k in range(3))

    # lambertian (incl. the NearZero fallback)
    lx, ly, lz = nx_ + bx, ny_ + by, nz_ + bz
    near0 = (torch.abs(lx) < EPS8) & (torch.abs(ly) < EPS8) \
        & (torch.abs(lz) < EPS8)
    lx = torch.where(near0, nx_, lx)
    ly = torch.where(near0, ny_, ly)
    lz = torch.where(near0, nz_, lz)

    # metal
    ddn = udx * nx_ + udy * ny_ + udz * nz_
    rx = udx - 2.0 * ddn * nx_
    ry = udy - 2.0 * ddn * ny_
    rz = udz - 2.0 * ddn * nz_
    mx = rx + fuzz * bx
    my = ry + fuzz * by
    mz = rz + fuzz * bz
    metal_ok = (mx * nx_ + my * ny_ + mz * nz_) > 0.0

    # dielectric
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
    plen = torch.abs(1.0 - (fx * fx + fy * fy + fz * fz))
    par = -sqrt_f32(plen)
    gx = fx + par * nx_
    gy = fy + par * ny_
    gz = fz + par * nz_

    is_l = kind == float(MAT_LAMBERTIAN)
    is_m = kind == float(MAT_METAL)
    is_d = kind == float(MAT_DIELECTRIC)
    is_i = kind == float(MAT_ISOTROPIC)
    new = torch.stack([udx, udy, udz], dim=1)
    new = torch.where(is_l[:, None], torch.stack([lx, ly, lz], 1), new)
    new = torch.where(is_m[:, None], torch.stack([mx, my, mz], 1), new)
    new = torch.where(is_d[:, None], torch.where(
        do_refl[:, None], torch.stack([rx, ry, rz], 1),
        torch.stack([gx, gy, gz], 1)), new)
    new = torch.where(is_i[:, None], torch.stack(iso, 1), new)
    scattered = (is_m & metal_ok) | (~is_m & ~is_light)
    return new, scattered


def _bounce(tab, fp, o, d, tm, thr, acc, pix_ctr, samp, bounce, chunk,
            stats=None):
    """One bounce of live rays (all [N, ...]).  Returns (o, d, thr, acc,
    alive, win) after hit -> record -> texture -> emission -> scatter;
    ``win`` is the winner's kernel row (-1 miss, np_rows + m medium m).
    ``stats`` (a `cull_stats` dict) counts the bounces and the cull's
    work."""
    dev = o.device
    dx, dy, dz = d.unbind(1)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    akey = fp.t_min * a
    inv = _recip(d) if tab.cull_pairs or tab.cull_boxes else None
    if stats is not None:
        stats["bounces"] += o.shape[0]
    best, win = _closest_spheres(tab, o, d, tm, a, akey, fp.t_min, chunk,
                                 inv, stats)
    best = torch.where(best < HALF_BIG, best * inv_a, BIG)
    best, win = _closest_quads(tab, o, d, fp.t_min, best, win, chunk, inv,
                               stats)
    best, win = _closest_boxes(tab, o, d, fp.t_min, best, win, chunk, inv,
                               stats)
    best, win, is_med, alb = _media(tab, fp, o, d, a, inv_a, pix_ctr,
                                    samp, bounce, best, win)
    hit = best < HALF_BIG

    bg = torch.tensor(fp.background, dtype=torch.float32, device=dev)
    acc = acc + torch.where((~hit)[:, None], thr * bg, 0.0)

    # winner attributes: misses and medium winners read zeros
    geo = (win >= 0) & (win < tab.np_rows)
    aw = torch.where(geo[:, None], tab.attr[win.clamp(0, tab.np_rows - 1)],
                     0.0)
    frac_w = (tm - aw[:, 6]) * aw[:, 7]
    wc = aw[:, 0:3] + frac_w[:, None] * aw[:, 3:6]
    wrad = aw[:, 8]
    is_quad = (aw[:, 9] > 0.5) & ~is_med
    p = o + best[:, None] * d
    inv_rad = 1.0 / torch.where(wrad != 0.0, wrad, 1.0)
    ns = (p - wc) * inv_rad[:, None]
    n_out = torch.where(is_quad[:, None], wc, ns)
    med_n = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    n_out = torch.where(is_med[:, None], med_n, n_out)
    d_dot_n = dx * n_out[:, 0] + dy * n_out[:, 1] + dz * n_out[:, 2]
    front = (d_dot_n < 0.0) | is_med
    nrm = n_out * torch.where(front, 1.0, -1.0)[:, None]

    # texture value: solid | checker | marble | image; media: albedo
    tex_kind = aw[:, 13]
    tex = aw[:, 14:17]
    cells = torch.floor(aw[:, 20:21] * p).to(torch.int64)
    even = ((cells[:, 0] + cells[:, 1] + cells[:, 2]) & 1) == 0
    is_ck = tex_kind == float(TEX_CHECKER)
    tex = torch.where((is_ck & ~even)[:, None], aw[:, 17:20], tex)
    is_nz = hit & (tex_kind == float(TEX_NOISE))
    if bool(is_nz.any()):
        sel = is_nz.nonzero()[:, 0]
        ps, aws = p[sel], aw[sel]
        table = torch.zeros(sel.shape[0], dtype=torch.int64, device=dev)
        for t in range(1, tab.n_noise):
            table = torch.where(aws[:, 25] == float(t), t, table)
        turb = _perlin_turb(tab, 0, ps[:, 0], ps[:, 1], ps[:, 2])
        for t in range(1, tab.n_noise):
            turb = torch.where(table == t, _perlin_turb(
                tab, t, ps[:, 0], ps[:, 1], ps[:, 2]), turb)
        marble = 0.5 * (1.0 + torch.sin(aws[:, 23] * ps[:, 2] + 10.0 * turb))
        tex = tex.index_put((sel,), marble[:, None].expand(-1, 3))
    is_im = hit & (tex_kind == float(TEX_IMAGE))
    if bool(is_im.any()):
        sel = is_im.nonzero()[:, 0]
        tex = tex.index_put((sel,), _image_tex(tab, aw[sel], p[sel], ns[sel],
                                               is_quad[sel]))
    tex = torch.where(is_med[:, None], alb, tex)

    kind = torch.where(is_med, float(MAT_ISOTROPIC), aw[:, 10])
    is_light = kind == float(MAT_DIFFUSE_LIGHT)
    acc = acc + torch.where((hit & is_light)[:, None], thr * tex, 0.0)

    w = rng.pcg4d(pix_ctr, samp, rng.to_word(rng.SCATTER_STREAM | bounce),
                  torch.zeros_like(pix_ctr))
    u1, u2, u3, u4 = (rng.unit(x) for x in w)
    new_d, scattered = _scatter(kind, aw[:, 11], aw[:, 12], front, is_light,
                                nrm, d, a, u1, u2, u3, u4)
    att = torch.where((kind == float(MAT_DIELECTRIC))[:, None], 1.0, tex)
    alive = hit & scattered
    thr = torch.where(alive[:, None], thr * att, thr)
    return p, new_d, thr, acc, alive, win


def cull_stats() -> dict:
    """Counters of the plain version's closest hit: lane-bounces, chunk
    slab tests, the (ray, chunk) visits they let through, and the active
    rows (padding included) of those chunks by kind."""
    return dict.fromkeys(("bounces", "tests", "chunks", "sphere_rows",
                          "quad_rows", "box_rows"), 0)


def render_radiance_plain(tab: Mega2Tables, pix: torch.Tensor,
                          fp: FrameParams, *, chunk: int = 256,
                          stats: dict | None = None):
    """Radiance summed over ``fp.spp`` samples (global samples ``fp.samp0
    ..``) for pixel ids ``pix`` [P] (ids < 0 give zeros) -> [P, 3] f32.
    Plain PyTorch, batched over rays; rays that end are dropped from the
    batch (each ray's arithmetic is independent of the others, so this
    cannot change a value).  Culled chunks gate each ray's result by its
    own slab test, as K1 does lane by lane; the TPU kernel runs a chunk
    for a whole tile of rays if any of them may meet its box, which finds
    the same winners wherever the f32 hit lies in its chunk's box (a
    rounding hit on a sphere the ray misses can lie outside it:
    ROADMAP.md, queue 3).  ``stats`` (from
    `cull_stats`) accumulates the counts of the run."""
    dev = pix.device
    P = pix.shape[0]
    lane = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    ids = (pix >= 0).nonzero()[:, 0]
    pix_v = pix[ids]
    for s in range(fp.samp0, fp.samp0 + fp.spp):
        o, d, tm, pix_ctr = generate_rays(fp.cam, pix_v, s, fp.width,
                                          fp.height, fp.seed)
        samp = torch.full_like(pix_ctr, s)
        thr = torch.ones_like(o)
        acc = torch.zeros_like(o)
        done = torch.zeros_like(o)
        live = torch.arange(ids.shape[0], device=dev)
        for b in range(max(fp.max_bounces, 1)):
            o, d, thr, acc, alive, _ = _bounce(
                tab, fp, o, d, tm, thr, acc, pix_ctr, samp, b, chunk, stats)
            if b + 1 >= fp.max_bounces:
                alive = torch.zeros_like(alive)
            done[live[~alive]] = acc[~alive]
            keep = alive.nonzero()[:, 0]
            if keep.numel() == 0:
                break
            live = live[keep]
            o, d, tm, thr, acc = o[keep], d[keep], tm[keep], thr[keep], \
                acc[keep]
            pix_ctr, samp = pix_ctr[keep], samp[keep]
        lane[ids] = lane[ids] + done
    return lane


# --------------------------------------------------------------------------
# K1: the CUDA kernel, its wrapper and the dispatcher


class _Params(ctypes.Structure):
    """Mirror of ``mega2::Params`` in ``csrc/mega2_bounce.cuh``."""
    _fields_ = [
        ("sph", ctypes.c_void_p), ("quad", ctypes.c_void_p),
        ("attr", ctypes.c_void_p), ("med", ctypes.c_void_p),
        ("perm", ctypes.c_void_p), ("vec", ctypes.c_void_p),
        ("texels", ctypes.c_void_p), ("img_dims", ctypes.c_void_p),
        ("cam", ctypes.c_float * 21), ("bg", ctypes.c_float * 3),
        ("t_min", ctypes.c_float),
        ("s_pad", ctypes.c_int), ("nl_pad", ctypes.c_int),
        ("q_pad", ctypes.c_int), ("b_pad", ctypes.c_int),
        ("np_rows", ctypes.c_int), ("n_media", ctypes.c_int),
        ("n_noise", ctypes.c_int), ("n_images", ctypes.c_int),
        ("tex_cols", ctypes.c_int), ("width", ctypes.c_int),
        ("height", ctypes.c_int), ("spp", ctypes.c_int),
        ("max_bounces", ctypes.c_int), ("seed", ctypes.c_uint32),
        ("cull_s", ctypes.c_void_p), ("cull_q", ctypes.c_void_p),
        ("cull_pairs", ctypes.c_int), ("cull_boxes", ctypes.c_int),
        ("samp0", ctypes.c_int),
        ("tree", ctypes.c_void_p), ("tree_p0", ctypes.c_int),
        ("tree_n", ctypes.c_int),
    ]


def load_kernel():
    """Build (at first use) and load K1; returns (CDLL, build record)."""
    from ..utils.cuda_build import load_library

    lib, record = load_library("mega2_render")
    lib.mega2_render_launch.argtypes = [
        ctypes.POINTER(_Params), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.mega2_render_launch.restype = ctypes.c_int
    lib.mega2_params_size.argtypes = []
    lib.mega2_params_size.restype = ctypes.c_int
    if lib.mega2_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("mega2::Params and its ctypes mirror differ")
    return lib, record


def render_radiance_cuda(tab: Mega2Tables, pix: torch.Tensor,
                         fp: FrameParams) -> torch.Tensor:
    """K1 on the card: radiance sums [P, 3] f32 for int32 pixel ids ``pix``
    [P] on a CUDA device.  Launches on the current stream and does not
    synchronise; ``render_radiance_cuda.shape`` holds the last launch's
    (blocks, threads a block, shared bytes: 0 when the pair rows stay in
    global memory), ``.tree_launches`` counts the launches whose closest
    sphere walked the tables' sphere tree."""
    dev = pix.device
    if dev.type != "cuda":
        raise ValueError(f"render_radiance_cuda needs CUDA tensors, got {dev}")
    _check_tables(tab, dev)
    if pix.dtype != torch.int32 or pix.dim() != 1:
        raise ValueError("pix must be a 1-D int32 tensor")
    pix = pix.contiguous()
    lib, _ = load_kernel()
    out = torch.empty((pix.shape[0], 3), dtype=torch.float32, device=dev)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    prm = _params(tab, fp)
    shape = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mega2_render_launch(ctypes.byref(prm), pix.data_ptr(),
                                      pix.shape[0], out.data_ptr(),
                                      queue.data_ptr(), shape, stream)
    if err != 0:
        raise RuntimeError(f"mega2 render kernel launch failed: CUDA error "
                           f"{err}")
    render_radiance_cuda.launches += 1
    render_radiance_cuda.shape = tuple(shape)
    if tab.tree_n:
        render_radiance_cuda.tree_launches += 1
        tracing.count("k1_tree_launches", 1)
    return out


render_radiance_cuda.launches = 0
render_radiance_cuda.tree_launches = 0
render_radiance_cuda.shape = None


def render_radiance(tab: Mega2Tables, pix: torch.Tensor,
                    fp: FrameParams) -> torch.Tensor:
    """Radiance sums [P, 3] for pixel ids ``pix`` [P]: the plain version
    for a CPU tensor, K1 for a CUDA tensor.  No fallback between them."""
    if pix.device.type == "cpu":
        return render_radiance_plain(tab, pix, fp)
    if pix.device.type == "cuda":
        return render_radiance_cuda(tab, pix.to(torch.int32), fp)
    raise ValueError(f"no mega2 render for device {pix.device}")


def render_mega2(tab: Mega2Tables, fp: FrameParams) -> torch.Tensor:
    """Radiance sums [H*W, 3] of the whole frame, pixel id j*W + i with j
    counting up from the bottom row, on the tables' device."""
    with tracing.span("k1.enqueue"):
        npix = fp.width * fp.height
        pix = torch.arange(npix, dtype=torch.int32, device=tab.sph.device)
        return render_radiance(tab, pix, fp)


# --------------------------------------------------------------------------
# K2: the winner-tape trace (plain version, CUDA wrapper, mega2_tapes)


def trace_tapes_plain(tab: Mega2Tables, pix: torch.Tensor, samp: torch.Tensor,
                      fp: FrameParams, rays: torch.Tensor | None = None, *,
                      chunk: int = 256) -> torch.Tensor:
    """Winner kernel rows [max_bounces, N] i32 of one (pixel, sample) per
    lane: ``pix`` [N] pixel ids (< 0: padding, all -1), ``samp`` [N]
    sample ids.  -1 marks a miss and every bounce after the path ended.
    ``rays`` [N, 7] (origin, direction, time) replaces the camera rays.
    Plain PyTorch, built from ``_bounce`` as the render runs it (winners
    do not depend on texture values)."""
    dev = pix.device
    K = fp.max_bounces
    N = pix.shape[0]
    tape = torch.full((K, N), -1, dtype=torch.int32, device=dev)
    ids = (pix >= 0).nonzero()[:, 0]
    pix_v = pix[ids]
    samp_v = samp[ids].to(torch.int32)
    if rays is None:
        o, d, tm, pix_ctr = generate_rays(fp.cam, pix_v, samp_v, fp.width,
                                          fp.height, fp.seed)
    else:
        o, d, tm = rays[ids, 0:3], rays[ids, 3:6], rays[ids, 6]
        pix_ctr = pixel_counter(pix_v, fp.seed)
    thr = torch.ones_like(o)
    acc = torch.zeros_like(o)
    live = ids
    for b in range(K):
        o, d, thr, acc, alive, win = _bounce(
            tab, fp, o, d, tm, thr, acc, pix_ctr, samp_v, b, chunk)
        tape[b, live] = win.to(torch.int32)
        keep = alive.nonzero()[:, 0]
        if keep.numel() == 0:
            break
        live = live[keep]
        o, d, tm, thr, acc = o[keep], d[keep], tm[keep], thr[keep], acc[keep]
        pix_ctr, samp_v = pix_ctr[keep], samp_v[keep]
    return tape


def _params(tab: Mega2Tables, fp: FrameParams) -> _Params:
    return _Params(
        sph=tab.sph.data_ptr(), quad=tab.quad.data_ptr(),
        attr=tab.attr.data_ptr(), med=tab.med.data_ptr(),
        perm=tab.perm.data_ptr(), vec=tab.vec.data_ptr(),
        texels=tab.texels.data_ptr(), img_dims=tab.img_dims.data_ptr(),
        cam=(ctypes.c_float * 21)(*fp.cam),
        bg=(ctypes.c_float * 3)(*fp.background),
        t_min=fp.t_min, s_pad=tab.s_pad, nl_pad=tab.nl_pad, q_pad=tab.q_pad,
        b_pad=tab.b_pad, np_rows=tab.np_rows, n_media=tab.n_media,
        n_noise=tab.n_noise, n_images=tab.n_images,
        tex_cols=tab.texels.shape[1], width=fp.width, height=fp.height,
        spp=fp.spp, max_bounces=fp.max_bounces,
        seed=fp.seed & 0xFFFFFFFF,
        cull_s=tab.cull_s.data_ptr(), cull_q=tab.cull_q.data_ptr(),
        cull_pairs=int(tab.cull_pairs), cull_boxes=int(tab.cull_boxes),
        samp0=fp.samp0, tree=tab.tree.data_ptr(), tree_p0=tab.tree_p0,
        tree_n=tab.tree_n)


def _check_tables(tab: Mega2Tables, dev) -> None:
    for name in ("sph", "quad", "attr", "med", "perm", "vec", "texels",
                 "img_dims", "cull_s", "cull_q", "tree"):
        t = getattr(tab, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"table {name} must be contiguous on {dev}")
    for name in ("sph", "quad", "attr", "med", "vec", "cull_s", "cull_q",
                 "tree"):
        if getattr(tab, name).dtype != torch.float32:
            raise ValueError(f"table {name} must be float32")
    if tab.sph.data_ptr() % 16 or tab.quad.data_ptr() % 16 \
            or tab.tree.data_ptr() % 16:
        raise ValueError("tables sph, quad and tree must be 16-byte aligned "
                         "(K1 and K2 read their rows as float4)")


def load_trace_kernel():
    """Build (at first use) and load K2; returns (CDLL, build record)."""
    from ..utils.cuda_build import load_library

    lib, record = load_library("mega2_trace")
    lib.mega2_trace_launch.argtypes = [
        ctypes.POINTER(_Params), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.mega2_trace_launch.restype = ctypes.c_int
    lib.mega2_trace_params_size.argtypes = []
    lib.mega2_trace_params_size.restype = ctypes.c_int
    if lib.mega2_trace_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("mega2::Params and its ctypes mirror differ")
    return lib, record


def trace_tapes_cuda(tab: Mega2Tables, pix: torch.Tensor, samp: torch.Tensor,
                     fp: FrameParams,
                     rays: torch.Tensor | None = None) -> torch.Tensor:
    """K2 on the card: `trace_tapes_plain`'s tape [max_bounces, N] i32 for
    int32 ``pix`` / ``samp`` [N] (and optional f32 ``rays`` [N, 7]) on a
    CUDA device.  Launches on the current stream (a memset of the tape and
    of the lane queue, then the kernel), no synchronisation;
    ``trace_tapes_cuda.shape`` holds the last launch's (blocks, threads a
    block, shared bytes: 0 when the pair rows stay in global memory)."""
    dev = pix.device
    if dev.type != "cuda":
        raise ValueError(f"trace_tapes_cuda needs CUDA tensors, got {dev}")
    _check_tables(tab, dev)
    n = pix.shape[0]
    if pix.dtype != torch.int32 or pix.dim() != 1:
        raise ValueError("pix must be a 1-D int32 tensor")
    if samp.dtype != torch.int32 or samp.shape != pix.shape \
            or samp.device != dev:
        raise ValueError("samp must be an int32 tensor shaped like pix")
    if rays is not None and (rays.dtype != torch.float32
                             or rays.shape != (n, 7) or rays.device != dev):
        raise ValueError("rays must be f32 [N, 7] on the same device")
    if fp.max_bounces < 1:
        raise ValueError("max_bounces must be at least 1")
    pix, samp = pix.contiguous(), samp.contiguous()
    rays = rays.contiguous() if rays is not None else None
    lib, _ = load_trace_kernel()
    out = torch.empty((fp.max_bounces, n), dtype=torch.int32, device=dev)
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    prm = _params(tab, fp)
    shape = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mega2_trace_launch(
            ctypes.byref(prm), pix.data_ptr(), samp.data_ptr(),
            rays.data_ptr() if rays is not None else None, n,
            out.data_ptr(), queue.data_ptr(), shape, stream)
    if err != 0:
        raise RuntimeError(f"mega2 trace kernel launch failed: CUDA error "
                           f"{err}")
    trace_tapes_cuda.launches += 1
    trace_tapes_cuda.shape = tuple(shape)
    return out


trace_tapes_cuda.launches = 0
trace_tapes_cuda.shape = None


def trace_tapes(tab: Mega2Tables, pix: torch.Tensor, samp: torch.Tensor,
                fp: FrameParams, rays: torch.Tensor | None = None):
    """Winner tape [max_bounces, N]: the plain version for CPU tensors, K2
    for CUDA tensors.  No fallback between them."""
    if pix.device.type == "cpu":
        return trace_tapes_plain(tab, pix, samp, fp, rays)
    if pix.device.type == "cuda":
        return trace_tapes_cuda(tab, pix.to(torch.int32),
                                samp.to(torch.int32), fp, rays)
    raise ValueError(f"no mega2 trace for device {pix.device}")


def tape_lanes(pix_ids: torch.Tensor, n_samples: int, samp0: int = 0):
    """Sample-major lanes of a tape batch: lane ``s*B + b`` traces pixel
    ``pix_ids[b]`` at sample ``samp0 + s``.  Returns (pix [L], samp [L])
    int32."""
    B = pix_ids.shape[0]
    lane = torch.arange(B * n_samples, dtype=torch.int64,
                        device=pix_ids.device)
    return pix_ids.to(torch.int32)[lane % B], \
        (lane // B + samp0).to(torch.int32)


def mega2_tapes(scene: SceneArrays, meta: SceneMeta, pix_ids, n_samples: int,
                *, width: int, height: int, max_bounces: int, t_min: float,
                seed: int, id_space: str = "global", device="cuda",
                tab: Mega2Tables | None = None,
                samp0: int = 0) -> torch.Tensor:
    """Winner tapes [n_samples, max_bounces, B] for samples
    samp0..samp0+n_samples-1 of the pixel ids [B], all samples in one
    trace.

    ``id_space="global"`` maps kernel rows to the scene ids of the replay
    (spheres [0, S), quads [S, S+Q), media S+Q+m); ``"kernel"`` keeps the
    trace's own rows (see `mega2_kernel_id_space`).  ``tab`` reuses tables
    already packed from ``scene``."""
    if id_space not in ("global", "kernel"):
        raise ValueError(f"unknown id_space {id_space!r}")
    dev = torch.device(device)
    if tab is None:
        tab = pack_mega2_tables(scene, meta, dev)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=1,
                       max_bounces=max_bounces, t_min=t_min, seed=seed)
    fp = frame_params(scene, cfg)
    pix_ids = torch.as_tensor(np.asarray(pix_ids, np.int32), device=dev)
    B = pix_ids.shape[0]
    pix, samp = tape_lanes(pix_ids, n_samples, samp0)
    tape = trace_tapes(tab, pix, samp, fp)
    if id_space == "global":
        tape = torch.where(tape >= 0, tab.remap[tape.clamp_min(0).long()],
                           -1)
    return tape.reshape(max_bounces, n_samples, B).permute(1, 0, 2)


def mega2_kernel_id_space(tab: Mega2Tables, meta: SceneMeta):
    """(remap, s_pad) of the trace's winner rows: ``remap[k]`` is the
    global scene id of kernel row k (-1 for padding rows, which never
    win); rows [0, s_pad) are spheres, [s_pad, np_rows) quads, and
    np_rows + m is medium m."""
    return tab.remap[:tab.np_rows + meta.n_media], tab.s_pad
