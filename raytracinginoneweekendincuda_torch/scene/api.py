"""Declarative scene description API.

The reference constructs its world as a heap object graph *on the device*
inside `CreateWorld<<<1,1>>>` (kernel.cu:176-543) — spheres, quads, boxes,
instance wrappers, media, materials and textures all `new`-ed and linked by
raw pointers, hit via virtual dispatch.  Device-side construction and
pointer-graph dispatch are CUDA-isms; the capability is *describing a scene*.

Here the same vocabulary is a host-side declarative layer: small frozen
dataclasses that the scene compiler (`scene/compiler.py`) flattens into
type-tagged SoA arrays.  Object sharing works like the reference's shared
pointers: passing the same ``Material``/``Texture`` instance twice dedupes to
one table row (cf. shared checker texture, kernel.cu:262-269).

The port's own copy of ``raytracinginoneweekendincuda_tpu/scene/api.py`` (same
arithmetic; only the package it lives in differs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np

Vec = Sequence[float]

# ----------------------------------------------------------------- textures


@dataclass(frozen=True, eq=False)
class Texture:
    pass


@dataclass(frozen=True, eq=False)
class SolidColor(Texture):
    """Constant color (Texture.h:35-55)."""

    color: Vec


@dataclass(frozen=True, eq=False)
class CheckerTexture(Texture):
    """3-D solid checker; parity of per-axis floor(p/scale) (Texture.h:60-87).

    Sub-textures are restricted to solid colors — the only form any reference
    scene uses (kernel.cu:203-206, 263-266).
    """

    scale: float
    even: SolidColor
    odd: SolidColor


@dataclass(frozen=True, eq=False)
class ImageTexture(Texture):
    """Nearest-neighbor image lookup (Texture.h:98-139).

    ``image`` is an [H,W,3] float array in [0,1] (see
    `core.image.load_texture_image` for the reference-parity decode), or
    ``None`` for the debug-cyan fallback (Texture.h:112-114).
    """

    image: Optional[np.ndarray]


@dataclass(frozen=True, eq=False)
class NoiseTexture(Texture):
    """Perlin 'marble': 0.5*(1+sin(scale*z + 10*turb(p,7))) (Texture.h:150-176).

    ``table_seed`` determines the (host-precomputed) gradient/permutation
    tables; the reference builds them from the world-gen curand stream
    (Perlin.h:27-35) — deterministic per construction order, which a seed
    models directly.
    """

    scale: float
    table_seed: int = 0


# ---------------------------------------------------------------- materials


@dataclass(frozen=True, eq=False)
class Material:
    pass


def _as_texture(t: Union[Texture, Vec]) -> Texture:
    """Color → SolidColor auto-wrap ("every color is a texture",
    Material.h:57-60)."""
    return t if isinstance(t, Texture) else SolidColor(tuple(float(x) for x in t))


@dataclass(frozen=True, eq=False)
class Lambertian(Material):
    """Diffuse: scatter = normal + point-in-unit-ball (Material.h:52-90)."""

    texture: Texture

    def __init__(self, texture_or_color):
        object.__setattr__(self, "texture", _as_texture(texture_or_color))


@dataclass(frozen=True, eq=False)
class Metal(Material):
    """Mirror + fuzz perturbation; absorbs below-surface scatters
    (Metal.h:9-35). fuzz clamps to <= 1 (Metal.h:14)."""

    albedo: Vec
    fuzz: float = 0.0


@dataclass(frozen=True, eq=False)
class Dielectric(Material):
    """Glass: Schlick-probabilistic reflect/refract, attenuation (1,1,1)
    (Dielectric.h:10-69)."""

    ior: float


@dataclass(frozen=True, eq=False)
class DiffuseLight(Material):
    """Emissive, never scatters (Material.h:100-132)."""

    texture: Texture

    def __init__(self, texture_or_color):
        object.__setattr__(self, "texture", _as_texture(texture_or_color))


@dataclass(frozen=True, eq=False)
class Isotropic(Material):
    """Uniform-direction phase function for media (Material.h:139-167)."""

    texture: Texture

    def __init__(self, texture_or_color):
        object.__setattr__(self, "texture", _as_texture(texture_or_color))


# ----------------------------------------------------------------- geometry


@dataclass(frozen=True, eq=False)
class Object:
    pass


@dataclass(frozen=True, eq=False)
class Sphere(Object):
    """Static or moving sphere (Sphere.h / MovingSphere.h).

    ``center2`` set => linear motion from ``center`` at ``time0`` to
    ``center2`` at ``time1`` (MovingSphere.h:39-42).
    """

    center: Vec
    radius: float
    material: Material
    center2: Optional[Vec] = None
    time0: float = 0.0
    time1: float = 1.0


@dataclass(frozen=True, eq=False)
class Quad(Object):
    """Parallelogram (Q, u, v) (Quad.h:22-110)."""

    q: Vec
    u: Vec
    v: Vec
    material: Material


@dataclass(frozen=True, eq=False)
class Box(Object):
    """Axis-aligned box between corners a and b.

    As geometry it compiles to 6 quads (the reference's MakeBox,
    Instance.h:166-184); as a ConstantMedium boundary it stays analytic
    (slab entry/exit).
    """

    a: Vec
    b: Vec
    material: Optional[Material] = None


@dataclass(frozen=True, eq=False)
class Translate(Object):
    """Instance translation (Instance.h:28-64); compiled by baking the
    offset into child coordinates (exact for every primitive type)."""

    obj: Object
    offset: Vec


@dataclass(frozen=True, eq=False)
class RotateY(Object):
    """Instance Y-rotation (Instance.h:71-159); compiled by rotating child
    coordinates.  Sphere UVs keep object-space orientation via a per-sphere
    rotation column (the reference computes UV before un-rotating the hit)."""

    obj: Object
    angle_deg: float


@dataclass(frozen=True, eq=False)
class Group(Object):
    """A list of objects sharing instance transforms (the reference's owning
    HittableList, e.g. the 1000-sphere cluster, kernel.cu:497-508)."""

    objects: Sequence[Object]


@dataclass(frozen=True, eq=False)
class ConstantMedium(Object):
    """Homogeneous medium inside a convex boundary (ConstantMedium.h:29-102).

    ``boundary`` must reduce to a Sphere or Box (possibly wrapped in
    Translate/RotateY) — the forms the reference's scenes use; its material
    is ignored (geometry only)."""

    boundary: Object
    density: float
    texture: Texture

    def __init__(self, boundary, density, texture_or_color):
        object.__setattr__(self, "boundary", boundary)
        object.__setattr__(self, "density", float(density))
        object.__setattr__(self, "texture", _as_texture(texture_or_color))


def make_box(a: Vec, b: Vec, material: Material) -> Box:
    """Convenience mirroring MakeBox (Instance.h:166-184)."""
    return Box(tuple(a), tuple(b), material)


@dataclass(eq=False)
class SceneDesc:
    """A scene: object list + camera (what CreateWorld assembles)."""

    objects: list = field(default_factory=list)
    camera: "Camera" = None  # core.camera.Camera

    def add(self, *objs: Object) -> "SceneDesc":
        self.objects.extend(objs)
        return self
