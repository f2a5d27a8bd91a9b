"""Thin-lens + motion-blur camera.

Host-side construction of the derived camera frame (the reference builds this
on-device in `Camera.h:36-71`; device-side construction was a CUDA-ism — the
math is identical and belongs on the host).  Ray *generation* from these
parameters is a batched engine stage (`ops/raygen.py`).

The port's own copy of ``raytracinginoneweekendincuda_tpu/core/camera.py`` (same
arithmetic; only the package it lives in differs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np


class CameraParams(NamedTuple):
    """Flat camera parameter block (a pytree of arrays; dtype = engine dtype).

    Field-for-field the cached state of the reference camera
    (`Camera.h:92-101`): origin, lower-left corner of the focus-plane
    viewport, the two viewport spanning vectors, the lens basis (u, v), lens
    radius, shutter interval, and the per-scene background color
    (`Camera.h:87-90`).
    """

    origin: np.ndarray       # (3,)
    lower_left: np.ndarray   # (3,)
    horizontal: np.ndarray   # (3,)
    vertical: np.ndarray     # (3,)
    u: np.ndarray            # (3,) lens basis
    v: np.ndarray            # (3,)
    lens_radius: np.ndarray  # ()
    time0: np.ndarray        # ()
    time1: np.ndarray        # ()
    background: np.ndarray   # (3,)


@dataclass
class Camera:
    """User-facing camera description (the arguments of Camera.h:36-46)."""

    lookfrom: tuple = (13.0, 2.0, 3.0)
    lookat: tuple = (0.0, 0.0, 0.0)
    vup: tuple = (0.0, 1.0, 0.0)
    vfov: float = 20.0          # vertical field of view, degrees
    aperture: float = 0.0
    focus_dist: float = 10.0
    time0: float = 0.0
    time1: float = 0.0
    background: tuple = (0.70, 0.80, 1.00)  # kernel.cu:197 default sky

    def build(self, aspect: float, dtype=np.float32) -> CameraParams:
        """Compute the derived frame in f64, then cast (Camera.h:47-71)."""
        lookfrom = np.asarray(self.lookfrom, np.float64)
        lookat = np.asarray(self.lookat, np.float64)
        vup = np.asarray(self.vup, np.float64)

        theta = self.vfov * math.pi / 180.0
        half_height = math.tan(theta / 2.0)
        half_width = aspect * half_height

        w = lookfrom - lookat
        w /= np.linalg.norm(w)
        u = np.cross(vup, w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)

        origin = lookfrom
        lower_left = (
            origin
            - half_width * self.focus_dist * u
            - half_height * self.focus_dist * v
            - self.focus_dist * w
        )
        horizontal = 2.0 * half_width * self.focus_dist * u
        vertical = 2.0 * half_height * self.focus_dist * v

        f = lambda x: np.asarray(x, dtype)
        return CameraParams(
            origin=f(origin),
            lower_left=f(lower_left),
            horizontal=f(horizontal),
            vertical=f(vertical),
            u=f(u),
            v=f(v),
            lens_radius=f(self.aperture / 2.0),
            time0=f(self.time0),
            time1=f(self.time1),
            background=f(self.background),
        )
