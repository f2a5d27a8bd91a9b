"""Book 2 worlds: the hittables of the reference CUDA repository's scenes
(Sphere.h, MovingSphere.h, Quad.h, Instance.h, ConstantMedium.h), their
materials (Material.h, Metal.h, Dielectric.h) and textures (Texture.h,
Perlin.h, RtwImage.h).

A world is a list of top-level hittables, in the order the scene adds
them, and a `Camera` (`../world.py`).  The hittables:

- `Sphere`, moving from ``center`` to ``center2`` over the shutter [0, 1];
- `Quad` (Q, u, v);
- `Box`, MakeBox's six quads (Instance.h:166-184) in an owning list;
- `Medium`, a ConstantMedium of a sphere boundary, its phase function
  isotropic with a solid colour;
- `Instance`, Translate(RotateY(an owning list of spheres, angle),
  offset) (Instance.h:28-159).  The tracer takes its spheres folded into
  world space, as the port's scene compiler folds them (``R(theta) @ c +
  offset`` in f64, then f32), where Instance.h moves the ray instead;
  a sphere keeps its rotation for its texture coordinates.

Textures: `Solid`, `Image` (bytes [H, W, 3], decoded by `load_image`)
and `Noise` (Perlin marble, its tables from `perlin_tables`).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np

from ..world import Camera

LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC = 0, 1, 2, 3, 4
SOLID, IMAGE, NOISE = 0, 2, 3
POINT_COUNT = 256                                   # Perlin.h:81
# the checkout's assets/ (the images the scenes read)
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "assets")


@dataclass(frozen=True)
class Solid:
    color: tuple


@dataclass(frozen=True, eq=False)
class Image:
    texels: np.ndarray          # uint8 [H, W, 3], row 0 the image's top


@dataclass(frozen=True)
class Noise:
    scale: float
    table_seed: int = 0


@dataclass(frozen=True)
class Material:
    kind: int
    texture: object = Solid((0.0, 0.0, 0.0))
    fuzz: float = 0.0
    ior: float = 1.0


def _tex(t) -> object:
    return t if isinstance(t, (Solid, Image, Noise)) else Solid(tuple(t))


def lambertian(t) -> Material:
    return Material(LAMBERTIAN, _tex(t))


def metal(albedo, fuzz: float) -> Material:
    return Material(METAL, Solid(tuple(albedo)), fuzz=min(float(fuzz), 1.0))


def dielectric(ior: float) -> Material:
    return Material(DIELECTRIC, ior=float(ior))


def diffuse_light(t) -> Material:
    return Material(DIFFUSE_LIGHT, _tex(t))


@dataclass(frozen=True)
class Sphere:
    center: tuple
    radius: float
    material: Material
    center2: Optional[tuple] = None
    theta: float = 0.0          # the instance rotation its texture undoes


@dataclass(frozen=True)
class Quad:
    q: tuple
    u: tuple
    v: tuple
    material: Material


@dataclass(frozen=True)
class Box:
    a: tuple
    b: tuple
    material: Material

    def corners(self) -> tuple:
        a, b = np.asarray(self.a, np.float64), np.asarray(self.b, np.float64)
        return np.minimum(a, b), np.maximum(a, b)

    def quads(self) -> list:
        """MakeBox's faces (Instance.h:176-181): front (+z), right (+x),
        back (-z), left (-x), top (+y), bottom (-y)."""
        mn, mx = self.corners()
        dx = (mx[0] - mn[0], 0.0, 0.0)
        dy = (0.0, mx[1] - mn[1], 0.0)
        dz = (0.0, 0.0, mx[2] - mn[2])
        neg = lambda v: tuple(-x for x in v)
        m = self.material
        return [Quad((mn[0], mn[1], mx[2]), dx, dy, m),
                Quad((mx[0], mn[1], mx[2]), neg(dz), dy, m),
                Quad((mx[0], mn[1], mn[2]), neg(dx), dy, m),
                Quad((mn[0], mn[1], mn[2]), dz, dy, m),
                Quad((mn[0], mx[1], mx[2]), dx, neg(dz), m),
                Quad((mn[0], mn[1], mn[2]), dx, dz, m)]


# the face a slab hit enters or leaves by, per axis: (min face, max face)
FACE = ((3, 1), (5, 4), (2, 0))


@dataclass(frozen=True)
class Medium:
    boundary: Sphere
    density: float
    color: tuple


def rot_y(theta: float) -> np.ndarray:
    """Object -> world rotation about y (Instance.h:138-141: x' = cos x +
    sin z, z' = -sin x + cos z)."""
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)


@dataclass(frozen=True)
class Instance:
    """Translate(RotateY(an owning list of ``spheres``, ``angle_deg``),
    ``offset``)."""
    spheres: tuple
    angle_deg: float
    offset: tuple

    def world_spheres(self) -> list:
        theta = math.radians(self.angle_deg)
        R = rot_y(theta)
        off = np.asarray(self.offset, np.float64)
        out = []
        for s in self.spheres:
            c2 = None if s.center2 is None else \
                tuple(R @ np.asarray(s.center2, np.float64) + off)
            out.append(Sphere(tuple(R @ np.asarray(s.center, np.float64)
                                    + off), s.radius, s.material, c2,
                              s.theta + theta))
        return out

    def box(self) -> tuple:
        """(lo, hi) f64 in world space: the list's box in object space,
        its eight corners rotated (Instance.h:83-111), then offset
        (Instance.h:33-37)."""
        lo = np.min([sphere_box(s)[0] for s in self.spheres], axis=0)
        hi = np.max([sphere_box(s)[1] for s in self.spheres], axis=0)
        R = rot_y(math.radians(self.angle_deg))
        corners = np.array([[(hi if i else lo)[0], (hi if j else lo)[1],
                             (hi if k else lo)[2]] for i in (0, 1)
                            for j in (0, 1) for k in (0, 1)])
        w = corners @ R.T + np.asarray(self.offset, np.float64)
        return w.min(0), w.max(0)


def sphere_box(s: Sphere) -> tuple:
    """(lo, hi) f64 of a sphere over its motion (MovingSphere.h:30-36)."""
    c0 = np.asarray(s.center, np.float64)
    c1 = c0 if s.center2 is None else np.asarray(s.center2, np.float64)
    r = abs(float(s.radius))
    return np.minimum(c0, c1) - r, np.maximum(c0, c1) + r


class World(NamedTuple):
    hittables: list
    camera: Camera


@dataclass
class Flat:
    """A world's primitives by kind, in the order of its hittables (an
    instance's spheres in place, folded into world space)."""
    spheres: list = field(default_factory=list)
    quads: list = field(default_factory=list)
    boxes: list = field(default_factory=list)
    media: list = field(default_factory=list)


def flatten(world: World) -> Flat:
    out = Flat()
    for h in world.hittables:
        if isinstance(h, Sphere):
            out.spheres.append(h)
        elif isinstance(h, Instance):
            out.spheres.extend(h.world_spheres())
        elif isinstance(h, Quad):
            out.quads.append(h)
        elif isinstance(h, Box):
            out.boxes.append(h)
        elif isinstance(h, Medium):
            out.media.append(h)
        else:
            raise TypeError(f"no Book 2 hittable: {type(h)}")
    return out


def load_image(path: str) -> Image:
    """``RtwImage::Load`` (RtwImage.h:51-87): the file decoded to 8-bit
    RGB, each byte to linear float as stb's ``stbi_loadf`` does
    (``powf(byte / 255, 2.2)``, in f32), then to a byte by ``FloatToByte``
    (RtwImage.h:100-105: 0 at or below 0, 255 at or above 1, else
    ``int(256 * x)``).  Raises where the file cannot be read or decoded:
    the reference never renders a stand-in colour."""
    from PIL import Image as PILImage
    try:
        with PILImage.open(path) as im:
            raw = np.asarray(im.convert("RGB"), np.uint8)
    except (OSError, ValueError) as e:
        raise RuntimeError(f"the reference cannot decode {path}: {e}") from e
    x = np.power(np.arange(256, dtype=np.float32) / np.float32(255.0),
                 np.float32(2.2))
    lut = np.where(x <= 0.0, 0, np.where(
        x >= 1.0, 255, (np.float32(256.0) * x).astype(np.int64)))
    return Image(lut.astype(np.uint8)[raw])


def perlin_tables(table_seed: int) -> tuple:
    """(gradients [256, 3] f64, perm_x, perm_y, perm_z [256] i32): the
    port's host generator (``scene/perlin.py::make_perlin_tables`` at
    commit 9ffa69c3c03932ed590ed26d5f5b18b188be7409), where Perlin.h:27-35
    draws from the world's curand stream: unit vectors of uniform points
    in the cube, and three uniform shuffles."""
    rs = np.random.default_rng(np.uint64(0x9E3779B97F4A7C15)
                               ^ np.uint64(table_seed))
    v = rs.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    norms[norms == 0.0] = 1.0
    perms = [rs.permutation(POINT_COUNT).astype(np.int32) for _ in range(3)]
    return (v / norms, *perms)
