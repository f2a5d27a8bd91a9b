"""Sphere worlds and the thin-lens, motion-blur camera of the reference
(Camera.h:36-71, Sphere.h, MovingSphere.h, Material.h, Texture.h), and
their f32 tables for the tracer.

A world is a list of `Sphere` and a `Camera`.  Materials: lambertian
(albedo or checker), metal (albedo, fuzz clamped to 1), dielectric (ior).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
SKY = (0.70, 0.80, 1.00)


@dataclass(frozen=True)
class Checker:
    scale: float
    even: tuple
    odd: tuple


@dataclass(frozen=True)
class Sphere:
    center: tuple
    radius: float
    kind: int
    albedo: tuple = (0.0, 0.0, 0.0)
    checker: Optional[Checker] = None
    fuzz: float = 0.0
    ior: float = 1.0
    center2: Optional[tuple] = None     # moves to center2 over [0, 1]


@dataclass(frozen=True)
class Camera:
    lookfrom: tuple = (13.0, 2.0, 3.0)
    lookat: tuple = (0.0, 0.0, 0.0)
    vup: tuple = (0.0, 1.0, 0.0)
    vfov: float = 20.0
    aperture: float = 0.0
    focus_dist: float = 10.0
    time0: float = 0.0
    time1: float = 0.0
    background: tuple = SKY

    def frame(self, aspect: float) -> dict:
        """The camera's derived frame in f64, each value then rounded to
        f32 (Camera.h:47-71)."""
        lookfrom = np.asarray(self.lookfrom, np.float64)
        lookat = np.asarray(self.lookat, np.float64)
        vup = np.asarray(self.vup, np.float64)
        half_h = math.tan(self.vfov * math.pi / 180.0 / 2.0)
        half_w = aspect * half_h
        w = lookfrom - lookat
        w /= np.linalg.norm(w)
        u = np.cross(vup, w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)
        fd = self.focus_dist
        f32 = lambda x: np.asarray(x, np.float32)
        return dict(
            origin=f32(lookfrom),
            lower_left=f32(lookfrom - half_w * fd * u - half_h * fd * v
                           - fd * w),
            horizontal=f32(2.0 * half_w * fd * u),
            vertical=f32(2.0 * half_h * fd * v),
            u=f32(u), v=f32(v), lens_radius=f32(self.aperture / 2.0),
            time0=f32(self.time0), time1=f32(self.time1),
            background=f32(self.background))


class World(NamedTuple):
    spheres: list
    camera: Camera


class Tables(NamedTuple):
    """Per-sphere columns [S] / [S, 3] on one device, in one dtype."""
    c0: torch.Tensor
    dc: torch.Tensor
    t0: torch.Tensor
    inv_dt: torch.Tensor
    rad: torch.Tensor
    rad2: torch.Tensor
    kind: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor
    checker: torch.Tensor     # bool
    c_even: torch.Tensor      # albedo, or the checker's even colour
    c_odd: torch.Tensor
    inv_scale: torch.Tensor


def tables(world: World, device, dtype=torch.float32) -> Tables:
    """The spheres' columns, each rounded to f32 from its f64 value (the
    squared radius squared in f32), then cast to ``dtype``."""
    S = len(world.spheres)
    c0 = np.zeros((S, 3))
    dc = np.zeros((S, 3))
    t0, inv_dt, rad = np.zeros(S), np.zeros(S), np.zeros(S)
    kind, fuzz, ior = np.zeros(S), np.zeros(S), np.ones(S)
    checker = np.zeros(S, bool)
    c_even, c_odd = np.zeros((S, 3)), np.zeros((S, 3))
    inv_scale = np.ones(S)
    for i, s in enumerate(world.spheres):
        c0[i] = s.center
        if s.center2 is not None:
            dc[i] = np.asarray(s.center2, np.float64) - c0[i]
            inv_dt[i] = 1.0
        rad[i] = s.radius
        kind[i] = s.kind
        fuzz[i] = min(float(s.fuzz), 1.0)
        ior[i] = s.ior if s.kind == DIELECTRIC else 1.0
        if s.checker is not None:
            checker[i] = True
            c_even[i] = s.checker.even
            c_odd[i] = s.checker.odd
            inv_scale[i] = 1.0 / float(s.checker.scale)
        else:
            c_even[i] = s.albedo
    radf = rad.astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).to(dtype)
    return Tables(c0=t(c0), dc=t(dc), t0=t(t0), inv_dt=t(inv_dt), rad=t(rad),
                  rad2=t(radf * radf), kind=t(kind), fuzz=t(fuzz),
                  ior=t(ior),
                  checker=torch.as_tensor(checker, device=device),
                  c_even=t(c_even), c_odd=t(c_odd), inv_scale=t(inv_scale))
