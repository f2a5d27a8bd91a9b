"""Material shading: emission + scatter.

Port of ``raytracinginoneweekendincuda_tpu/ops/shade.py``: the reference's
five-way ``Material::Emitted/Scatter`` dispatch (Material.h:27-44 and
subclasses) as branchless evaluation of every scatter model followed by
kind-tag selects.  Material and texture parameters come pre-gathered in
the record's ``mrow``.  One 4-uniform draw per bounce (SCATTER_STREAM |
bounce): u1, u2, u3 feed the ball / direction sample, u4 the dielectric's
reflectance lottery (Dielectric.h:41).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..core.samplers import unit_ball_xyz, unit_sphere_surface
from ..scene.compiler import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_METAL,
)
from .textures import texture_value_rows


class ScatterResult(NamedTuple):
    emitted: torch.Tensor      # [B, 3]
    direction: torch.Tensor    # [B, 3] new ray direction
    attenuation: torch.Tensor  # [B, 3]
    scattered: torch.Tensor    # [B] bool (False = absorbed / pure emitter)


def shade(scene, meta, rec, d_in, u1, u2, u3, u4) -> ScatterResult:
    """Emission + scatter for hit records ``rec`` (`hit.HitRecord`)."""
    mrow = rec.mrow
    kind = mrow[:, 0].to(torch.int64)
    fuzz = mrow[:, 1]
    ior = mrow[:, 2]

    texv = texture_value_rows(scene, meta, mrow, rec.u, rec.v, rec.p)

    is_light = kind == MAT_DIFFUSE_LIGHT
    emitted = torch.where(is_light[:, None], texv, 0.0)  # Material.h:114-117

    d_len = vm.length(d_in)[:, None]
    unit_d = d_in / torch.where(d_len > 0, d_len, 1.0)
    ball = unit_ball_xyz(u1, u2, u3)

    # Lambertian: normal + ball sample, near-zero fallback (Material.h:75-79)
    lamb_dir = rec.normal + ball
    lamb_dir = torch.where(vm.near_zero(lamb_dir)[:, None], rec.normal,
                           lamb_dir)

    # Metal: mirror + fuzz*ball; absorbed below surface (Metal.h:25-29)
    refl = vm.reflect(unit_d, rec.normal)
    metal_dir = refl + fuzz[:, None] * ball
    metal_ok = vm.dot(metal_dir, rec.normal) > 0.0

    # Dielectric (Dielectric.h:18-55)
    ratio = torch.where(rec.front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(vm.dot(-unit_d, rec.normal), 1.0)
    sin_sq = 1.0 - cos_t * cos_t
    sin_pos = sin_sq > 0.0
    sin_t = torch.where(sin_pos,
                        vm.sqrt_exact(torch.where(sin_pos, sin_sq, 1.0)), 0.0)
    cannot_refract = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    # Schlick (Dielectric.h:63-68); x**5 as JAX's integer_pow multiplies it
    om = 1.0 - cos_t
    om2 = om * om
    reflectance = r0 + (1.0 - r0) * (om * (om2 * om2))
    do_reflect = cannot_refract | (reflectance > u4)
    ratio_safe = torch.where(cannot_refract, 0.0, ratio)
    diel_dir = torch.where(do_reflect[:, None], refl,
                           vm.refract(unit_d, rec.normal, ratio_safe))

    # Isotropic: uniform direction from the ball's (u1, u2) (Material.h:160)
    iso_dir = unit_sphere_surface(u1, u2)

    direction = torch.where((kind == MAT_LAMBERTIAN)[:, None], lamb_dir,
                            unit_d)
    direction = torch.where((kind == MAT_METAL)[:, None], metal_dir,
                            direction)
    direction = torch.where((kind == MAT_DIELECTRIC)[:, None], diel_dir,
                            direction)
    direction = torch.where((kind == MAT_ISOTROPIC)[:, None], iso_dir,
                            direction)

    attenuation = torch.where((kind == MAT_DIELECTRIC)[:, None], 1.0, texv)

    scattered = torch.where(kind == MAT_METAL, metal_ok, True)
    scattered = torch.where(is_light, False, scattered)  # Material.h:120-128
    return ScatterResult(emitted=emitted, direction=direction,
                         attenuation=attenuation, scattered=scattered)
