"""Scene compiler: declarative description -> type-tagged SoA arrays.

This is the TPU-native replacement for the reference's device-side world
construction (`CreateWorld<<<1,1>>>`, kernel.cu:176-543) and for its
polymorphism: the `Hittable`/`Material`/`Texture` class hierarchies with
virtual `Hit`/`Scatter`/`Value` (Hittable.h:33-65, Material.h:27-44,
Texture.h:24-30) become integer *kind tags* plus parameter columns; virtual
dispatch becomes masked selects over those tags inside the engine.

Instance transforms (Translate/RotateY, Instance.h:28-159) are *baked* at
compile time: rotating/translating the ray per hit is a pointer-era indirection
— rigid transforms of spheres and parallelograms are exactly representable by
transforming their defining points/vectors, so the engine never pays for them.
The one observable exception is sphere UV orientation (the reference derives
UV from the object-space normal), preserved via a per-sphere (cos, sin)
rotation column.  Constant-medium boundaries keep an explicit world->object
transform so the analytic slab/quadratic entry-exit test runs in object space.

Output is two objects:
  * ``SceneArrays`` — a pytree of numpy arrays (jit-traceable, differentiable
    leaves: every geometric/material parameter is primal here; derived
    quantities like quad plane constants are computed inside the engine so
    gradients flow back to these leaves).
  * ``SceneMeta``   — hashable static metadata (counts + feature flags) that
    gates entire subsystems out of the compiled program per scene.

The port's own copy of ``raytracinginoneweekendincuda_tpu/scene/compiler.py`` (same
arithmetic; only the package it lives in differs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

from ..core.camera import Camera, CameraParams
from . import api
from .perlin import POINT_COUNT, make_perlin_tables

# material kinds
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# texture kinds
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3

# medium boundary kinds
MED_SPHERE = 0
MED_BOX = 1

_FAR = 1.0e8  # parked coordinate for padding rows


class SceneArrays(NamedTuple):
    # spheres (static sphere == zero-motion degenerate, SURVEY §2)
    sph_c0: np.ndarray      # [S,3] center at time0
    sph_dc: np.ndarray      # [S,3] center1 - center0 (zeros when static)
    sph_t0: np.ndarray      # [S]
    sph_inv_dt: np.ndarray  # [S]   1/(t1-t0), 0 when static
    sph_rad: np.ndarray     # [S]
    sph_cos: np.ndarray     # [S]   accumulated instance rotation (UV frame)
    sph_sin: np.ndarray     # [S]
    sph_mat: np.ndarray     # [S] i32
    sph_active: np.ndarray  # [S] bool
    # quads
    quad_q: np.ndarray      # [Q,3]
    quad_u: np.ndarray      # [Q,3]
    quad_v: np.ndarray      # [Q,3]
    quad_mat: np.ndarray    # [Q] i32
    quad_active: np.ndarray  # [Q] bool
    # constant media
    med_kind: np.ndarray    # [M] i32 (MED_SPHERE | MED_BOX)
    med_center: np.ndarray  # [M,3] sphere boundary center (world)
    med_radius: np.ndarray  # [M]
    med_bmin: np.ndarray    # [M,3] box boundary (object space)
    med_bmax: np.ndarray    # [M,3]
    med_cos: np.ndarray     # [M]  world->object rotation for box boundaries
    med_sin: np.ndarray     # [M]
    med_off: np.ndarray     # [M,3] world->object translation
    med_nid: np.ndarray     # [M]  -1/density (ConstantMedium.h:34)
    med_mat: np.ndarray     # [M] i32 (isotropic phase material)
    med_active: np.ndarray  # [M] bool
    # materials
    mat_kind: np.ndarray    # [K] i32
    mat_tex: np.ndarray     # [K] i32
    mat_fuzz: np.ndarray    # [K]
    mat_ior: np.ndarray     # [K]
    # textures
    tex_kind: np.ndarray    # [T] i32
    tex_c0: np.ndarray      # [T,3] solid color | checker even
    tex_c1: np.ndarray      # [T,3] checker odd
    tex_inv_scale: np.ndarray  # [T] checker 1/scale
    tex_scale: np.ndarray   # [T] noise frequency
    tex_noise: np.ndarray   # [T] i32 perlin table id (-1 none)
    tex_image: np.ndarray   # [T] i32 image id (-1 -> debug cyan)
    # perlin tables (stacked per NoiseTexture)
    perlin_vec: np.ndarray  # [NT,256,3]
    perlin_px: np.ndarray   # [NT,256] i32
    perlin_py: np.ndarray   # [NT,256] i32
    perlin_pz: np.ndarray   # [NT,256] i32
    # images (padded to common size)
    img_data: np.ndarray    # [NI,Hm,Wm,3]
    img_w: np.ndarray       # [NI] i32
    img_h: np.ndarray       # [NI] i32
    # camera
    camera: CameraParams


@dataclass(frozen=True)
class SceneMeta:
    """Hashable static scene facts — passed as a static jit argument."""

    n_spheres: int
    n_quads: int
    n_media: int
    n_materials: int
    n_textures: int
    n_noise: int
    n_images: int
    has_checker: bool
    has_noise: bool
    has_image: bool
    has_moving: bool
    has_sphere_uv_rot: bool
    # an image texture bound to a quad needs quad (alpha, beta) UVs in the
    # shading record — supported by the XLA engines, gated out of mega2
    # (no reference scene does this, kernel.cu:176-543)
    image_on_quad: bool = False


def _rot_y(theta: float) -> np.ndarray:
    """Object->world Y rotation by theta (Instance.h:138-141 convention:
    x' = cos*x + sin*z, z' = -sin*x + cos*z)."""
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)


class _Flattener:
    def __init__(self):
        self.spheres = []   # (c0, c2|None, t0, t1, r, mat, theta)
        self.quads = []     # (q, u, v, mat)
        self.media = []     # dict
        self.mat_ids = {}   # id(Material) -> row
        self.materials = []
        self.tex_ids = {}
        self.textures = []
        self.noise_ids = {}
        self.noise_seeds = []
        self.image_ids = {}
        self.images = []

    # ---------------- material / texture interning ----------------

    def _texture(self, t: api.Texture) -> int:
        key = id(t)
        if key in self.tex_ids:
            return self.tex_ids[key]
        row = len(self.textures)
        self.tex_ids[key] = row
        self.textures.append(t)
        if isinstance(t, api.NoiseTexture):
            self.noise_ids[key] = len(self.noise_seeds)
            self.noise_seeds.append(t.table_seed)
        elif isinstance(t, api.ImageTexture) and t.image is not None:
            self.image_ids[key] = len(self.images)
            self.images.append(np.asarray(t.image, np.float64))
        return row

    def _material(self, m: api.Material) -> int:
        key = id(m)
        if key in self.mat_ids:
            return self.mat_ids[key]
        row = len(self.materials)
        self.mat_ids[key] = row
        self.materials.append(m)
        if isinstance(m, (api.Lambertian, api.DiffuseLight, api.Isotropic)):
            self._texture(m.texture)
        elif isinstance(m, api.Metal):
            self._texture(api.SolidColor(tuple(float(x) for x in m.albedo)))
            # re-intern under the material so the metal's solid row is found
            self.tex_ids[("metal", key)] = len(self.textures) - 1
        elif isinstance(m, api.Dielectric):
            pass  # attenuation fixed at (1,1,1), Dielectric.h:26
        return row

    def _mat_tex_row(self, m: api.Material) -> int:
        if isinstance(m, (api.Lambertian, api.DiffuseLight, api.Isotropic)):
            return self.tex_ids[id(m.texture)]
        if isinstance(m, api.Metal):
            return self.tex_ids[("metal", id(m))]
        return -1

    # ------------------------- geometry walk -----------------------

    def visit(self, obj: api.Object, theta: float, off: np.ndarray):
        """theta/off define object->world: p_w = R_theta @ p_o + off."""
        R = _rot_y(theta)
        if isinstance(obj, api.Sphere):
            c0 = R @ np.asarray(obj.center, np.float64) + off
            c2 = None
            if obj.center2 is not None:
                c2 = R @ np.asarray(obj.center2, np.float64) + off
            self._material(obj.material)
            self.spheres.append(
                (c0, c2, obj.time0, obj.time1, float(obj.radius), obj.material, theta)
            )
        elif isinstance(obj, api.Quad):
            self._material(obj.material)
            self.quads.append(
                (
                    R @ np.asarray(obj.q, np.float64) + off,
                    R @ np.asarray(obj.u, np.float64),
                    R @ np.asarray(obj.v, np.float64),
                    obj.material,
                )
            )
        elif isinstance(obj, api.Box):
            if obj.material is None:
                raise ValueError("Box used as geometry needs a material")
            for quad in _box_quads(obj):
                self.visit(quad, theta, off)
        elif isinstance(obj, api.Translate):
            # p_w = R_theta (p_c + t) + off  ->  child offset = off + R_theta t
            t = np.asarray(obj.offset, np.float64)
            self.visit(obj.obj, theta, off + R @ t)
        elif isinstance(obj, api.RotateY):
            self.visit(obj.obj, theta + math.radians(obj.angle_deg), off)
        elif isinstance(obj, api.Group):
            for o in obj.objects:
                self.visit(o, theta, off)
        elif isinstance(obj, api.ConstantMedium):
            self._visit_medium(obj, theta, off)
        else:
            raise TypeError(f"unknown scene object {type(obj)}")

    def _visit_medium(self, med: api.ConstantMedium, theta: float, off: np.ndarray):
        phase = api.Isotropic(med.texture)
        self._material(phase)
        kind, leaf, th, tr = _resolve_boundary(med.boundary, theta, off)
        row = {
            "nid": -1.0 / med.density,
            "mat": phase,
        }
        if kind == MED_SPHERE:
            R = _rot_y(th)
            row.update(
                kind=MED_SPHERE,
                center=R @ np.asarray(leaf.center, np.float64) + tr,
                radius=float(leaf.radius),
                bmin=np.zeros(3),
                bmax=np.zeros(3),
                cos=1.0,
                sin=0.0,
                off=np.zeros(3),
            )
        else:
            a = np.asarray(leaf.a, np.float64)
            b = np.asarray(leaf.b, np.float64)
            row.update(
                kind=MED_BOX,
                center=np.zeros(3),
                radius=0.0,
                bmin=np.minimum(a, b),
                bmax=np.maximum(a, b),
                cos=math.cos(th),
                sin=math.sin(th),
                off=tr,
            )
        self.media.append(row)


def _resolve_boundary(obj: api.Object, theta: float, off: np.ndarray):
    """Reduce a medium boundary subtree to (kind, leaf, theta, offset)."""
    R = _rot_y(theta)
    if isinstance(obj, api.Sphere):
        return MED_SPHERE, obj, theta, off
    if isinstance(obj, api.Box):
        return MED_BOX, obj, theta, off
    if isinstance(obj, api.Translate):
        t = np.asarray(obj.offset, np.float64)
        return _resolve_boundary(obj.obj, theta, off + R @ t)
    if isinstance(obj, api.RotateY):
        return _resolve_boundary(obj.obj, theta + math.radians(obj.angle_deg), off)
    raise TypeError(
        f"ConstantMedium boundary must reduce to Sphere or Box, got {type(obj)}"
    )


def _box_quads(box: api.Box):
    """Six quads of an axis-aligned box, same winding as Instance.h:176-181."""
    a = np.asarray(box.a, np.float64)
    b = np.asarray(box.b, np.float64)
    mn, mx = np.minimum(a, b), np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0.0, 0.0])
    dy = np.array([0.0, mx[1] - mn[1], 0.0])
    dz = np.array([0.0, 0.0, mx[2] - mn[2]])
    m = box.material
    return [
        api.Quad((mn[0], mn[1], mx[2]), tuple(dx), tuple(dy), m),   # front
        api.Quad((mx[0], mn[1], mx[2]), tuple(-dz), tuple(dy), m),  # right
        api.Quad((mx[0], mn[1], mn[2]), tuple(-dx), tuple(dy), m),  # back
        api.Quad((mn[0], mn[1], mn[2]), tuple(dz), tuple(dy), m),   # left
        api.Quad((mn[0], mx[1], mx[2]), tuple(dx), tuple(-dz), m),  # top
        api.Quad((mn[0], mn[1], mn[2]), tuple(dx), tuple(dz), m),   # bottom
    ]


def _pad_to(n: int, multiple: int) -> int:
    if n == 0:
        return multiple
    return -(-n // multiple) * multiple


def cached_pack(cache: dict, scene: SceneArrays, tag: str, make,
                max_entries: int = 16):
    """Host-side packed-table cache keyed on the IDENTITY of EVERY array
    leaf of the scene (plus ``tag``).

    Two hazards this closes (round-1 advice + round-2 training):
      * id() keys alone can collide after GC recycles an address — the
        entry holds strong refs to the keyed leaves and re-verifies
        identity on hit, so a recycled id can never serve another scene's
        tables;
      * keying on geometry leaves only would serve STALE tables during
        training, where optimizer steps `_replace()` texture/material
        leaves while the geometry ids stay put.
    """
    leaves = tuple(scene[:-1]) + tuple(scene.camera)
    key = (tag,) + tuple(map(id, leaves))
    hit = cache.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], leaves)):
        return hit[1]
    val = make()
    if len(cache) > max_entries:
        cache.clear()
    cache[key] = (leaves, val)
    return val


def compile_scene(
    desc: api.SceneDesc,
    width: int,
    height: int,
    dtype=np.float32,
    pad_multiple: int = 8,
):
    """Flatten a SceneDesc into (SceneArrays, SceneMeta)."""
    fl = _Flattener()
    for obj in desc.objects:
        fl.visit(obj, 0.0, np.zeros(3, np.float64))

    f = dtype
    S = _pad_to(len(fl.spheres), pad_multiple)
    Q = _pad_to(len(fl.quads), pad_multiple)
    M = max(len(fl.media), 1)
    K = max(len(fl.materials), 1)
    T = max(len(fl.textures), 1)
    NT = max(len(fl.noise_seeds), 1)
    NI = max(len(fl.images), 1)

    # ---- spheres
    sph_c0 = np.full((S, 3), _FAR, np.float64)
    sph_dc = np.zeros((S, 3), np.float64)
    sph_t0 = np.zeros(S, np.float64)
    sph_inv_dt = np.zeros(S, np.float64)
    sph_rad = np.zeros(S, np.float64)
    sph_cos = np.ones(S, np.float64)
    sph_sin = np.zeros(S, np.float64)
    sph_mat = np.zeros(S, np.int32)
    sph_active = np.zeros(S, bool)
    for i, (c0, c2, t0, t1, r, mat, theta) in enumerate(fl.spheres):
        sph_c0[i] = c0
        if c2 is not None:
            sph_dc[i] = c2 - c0
            sph_t0[i] = t0
            sph_inv_dt[i] = 1.0 / (t1 - t0)
        sph_rad[i] = r
        sph_cos[i] = math.cos(theta)
        sph_sin[i] = math.sin(theta)
        sph_mat[i] = fl.mat_ids[id(mat)]
        sph_active[i] = True

    # ---- quads
    quad_q = np.full((Q, 3), _FAR, np.float64)
    quad_u = np.tile(np.array([1.0, 0.0, 0.0]), (Q, 1))
    quad_v = np.tile(np.array([0.0, 1.0, 0.0]), (Q, 1))
    quad_mat = np.zeros(Q, np.int32)
    quad_active = np.zeros(Q, bool)
    for i, (q, u, v, mat) in enumerate(fl.quads):
        quad_q[i] = q
        quad_u[i] = u
        quad_v[i] = v
        quad_mat[i] = fl.mat_ids[id(mat)]
        quad_active[i] = True

    # ---- media
    med_kind = np.zeros(M, np.int32)
    med_center = np.full((M, 3), _FAR, np.float64)
    med_radius = np.zeros(M, np.float64)
    med_bmin = np.zeros((M, 3), np.float64)
    med_bmax = np.zeros((M, 3), np.float64)
    med_cos = np.ones(M, np.float64)
    med_sin = np.zeros(M, np.float64)
    med_off = np.zeros((M, 3), np.float64)
    med_nid = np.full(M, -1.0, np.float64)
    med_mat = np.zeros(M, np.int32)
    med_active = np.zeros(M, bool)
    for i, row in enumerate(fl.media):
        med_kind[i] = row["kind"]
        med_center[i] = row["center"]
        med_radius[i] = row["radius"]
        med_bmin[i] = row["bmin"]
        med_bmax[i] = row["bmax"]
        med_cos[i] = row["cos"]
        med_sin[i] = row["sin"]
        med_off[i] = row["off"]
        med_nid[i] = row["nid"]
        med_mat[i] = fl.mat_ids[id(row["mat"])]
        med_active[i] = True

    # ---- materials
    mat_kind = np.zeros(K, np.int32)
    mat_tex = np.full(K, -1, np.int32)
    mat_fuzz = np.zeros(K, np.float64)
    mat_ior = np.ones(K, np.float64)
    kind_of = {
        api.Lambertian: MAT_LAMBERTIAN,
        api.Metal: MAT_METAL,
        api.Dielectric: MAT_DIELECTRIC,
        api.DiffuseLight: MAT_DIFFUSE_LIGHT,
        api.Isotropic: MAT_ISOTROPIC,
    }
    for i, m in enumerate(fl.materials):
        mat_kind[i] = kind_of[type(m)]
        mat_tex[i] = fl._mat_tex_row(m)
        if isinstance(m, api.Metal):
            mat_fuzz[i] = min(float(m.fuzz), 1.0)  # Metal.h:14 clamp
        if isinstance(m, api.Dielectric):
            mat_ior[i] = float(m.ior)

    # ---- textures
    tex_kind = np.zeros(T, np.int32)
    tex_c0 = np.zeros((T, 3), np.float64)
    tex_c1 = np.zeros((T, 3), np.float64)
    tex_inv_scale = np.ones(T, np.float64)
    tex_scale = np.ones(T, np.float64)
    tex_noise = np.full(T, -1, np.int32)
    tex_image = np.full(T, -1, np.int32)
    for i, t in enumerate(fl.textures):
        if isinstance(t, api.SolidColor):
            tex_kind[i] = TEX_SOLID
            tex_c0[i] = np.asarray(t.color, np.float64)
        elif isinstance(t, api.CheckerTexture):
            tex_kind[i] = TEX_CHECKER
            tex_c0[i] = np.asarray(t.even.color, np.float64)
            tex_c1[i] = np.asarray(t.odd.color, np.float64)
            tex_inv_scale[i] = 1.0 / float(t.scale)  # Texture.h:64
        elif isinstance(t, api.ImageTexture):
            tex_kind[i] = TEX_IMAGE
            tex_image[i] = fl.image_ids.get(id(t), -1)
        elif isinstance(t, api.NoiseTexture):
            tex_kind[i] = TEX_NOISE
            tex_scale[i] = float(t.scale)
            tex_noise[i] = fl.noise_ids[id(t)]
        else:
            raise TypeError(f"unknown texture {type(t)}")

    # ---- perlin tables
    perlin_vec = np.zeros((NT, POINT_COUNT, 3), np.float64)
    perlin_perm = [np.zeros((NT, POINT_COUNT), np.int32) for _ in range(3)]
    for i, seed in enumerate(fl.noise_seeds):
        vec, px, py, pz = make_perlin_tables(seed)
        perlin_vec[i] = vec
        perlin_perm[0][i] = px
        perlin_perm[1][i] = py
        perlin_perm[2][i] = pz

    # ---- images (pad to common max size)
    if fl.images:
        hm = max(im.shape[0] for im in fl.images)
        wm = max(im.shape[1] for im in fl.images)
        img_data = np.zeros((NI, hm, wm, 3), np.float64)
        img_w = np.zeros(NI, np.int32)
        img_h = np.zeros(NI, np.int32)
        for i, im in enumerate(fl.images):
            img_data[i, : im.shape[0], : im.shape[1]] = im
            img_h[i], img_w[i] = im.shape[0], im.shape[1]
    else:
        img_data = np.zeros((1, 1, 1, 3), np.float64)
        img_w = np.ones(1, np.int32)
        img_h = np.ones(1, np.int32)

    camera: Camera = desc.camera or Camera()
    cam = camera.build(float(width) / float(height), dtype=f)

    arrays = SceneArrays(
        sph_c0=sph_c0.astype(f), sph_dc=sph_dc.astype(f),
        sph_t0=sph_t0.astype(f), sph_inv_dt=sph_inv_dt.astype(f),
        sph_rad=sph_rad.astype(f), sph_cos=sph_cos.astype(f),
        sph_sin=sph_sin.astype(f), sph_mat=sph_mat, sph_active=sph_active,
        quad_q=quad_q.astype(f), quad_u=quad_u.astype(f),
        quad_v=quad_v.astype(f), quad_mat=quad_mat, quad_active=quad_active,
        med_kind=med_kind, med_center=med_center.astype(f),
        med_radius=med_radius.astype(f), med_bmin=med_bmin.astype(f),
        med_bmax=med_bmax.astype(f), med_cos=med_cos.astype(f),
        med_sin=med_sin.astype(f), med_off=med_off.astype(f),
        med_nid=med_nid.astype(f), med_mat=med_mat, med_active=med_active,
        mat_kind=mat_kind, mat_tex=mat_tex, mat_fuzz=mat_fuzz.astype(f),
        mat_ior=mat_ior.astype(f),
        tex_kind=tex_kind, tex_c0=tex_c0.astype(f), tex_c1=tex_c1.astype(f),
        tex_inv_scale=tex_inv_scale.astype(f), tex_scale=tex_scale.astype(f),
        tex_noise=tex_noise, tex_image=tex_image,
        perlin_vec=perlin_vec.astype(f),
        perlin_px=perlin_perm[0], perlin_py=perlin_perm[1],
        perlin_pz=perlin_perm[2],
        img_data=img_data.astype(f), img_w=img_w, img_h=img_h,
        camera=cam,
    )
    meta = SceneMeta(
        n_spheres=len(fl.spheres),
        n_quads=len(fl.quads),
        n_media=len(fl.media),
        n_materials=len(fl.materials),
        n_textures=len(fl.textures),
        n_noise=len(fl.noise_seeds),
        n_images=len(fl.images),
        has_checker=any(k == TEX_CHECKER for k in tex_kind[: len(fl.textures)]),
        has_noise=len(fl.noise_seeds) > 0,
        has_image=any(
            isinstance(t, api.ImageTexture) for t in fl.textures
        ),
        has_moving=bool(np.any(sph_inv_dt != 0.0)),
        has_sphere_uv_rot=bool(np.any(sph_sin[: len(fl.spheres)] != 0.0)),
        image_on_quad=any(
            isinstance(m, (api.Lambertian, api.DiffuseLight, api.Isotropic))
            and isinstance(m.texture, api.ImageTexture)
            for (_, _, _, m) in fl.quads
        ),
    )
    return arrays, meta
