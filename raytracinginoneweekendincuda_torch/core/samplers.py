"""Branchless samplers used by raygen and scatter.

Port of the parts of ``raytracinginoneweekendincuda_tpu/core/samplers.py``
that the mega2 path uses, in the op order of the mega2 kernel
(``ops/mega2.py:_scatter_dirs`` and ``raygen`` there): the lens disk and
the unit-ball sample.  Square roots go through :func:`sqrt_f32`.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = float(np.float32(2.0 * np.pi))
ONE_THIRD = float(np.float32(1.0 / 3.0))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  PyTorch's vectorized CPU sqrt can
    miss the IEEE result by an ulp; the f64 root rounded to f32 is exact
    (53 >= 2*24 + 2 bits), and it is what ``sqrtf`` gives on the card."""
    return torch.sqrt(x.double()).float()


def unit_disk(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform point in the unit disk: (r cos phi, r sin phi), r = sqrt(u1)."""
    r = sqrt_f32(u1)
    phi = TWO_PI * u2
    return r * torch.cos(phi), r * torch.sin(phi)


def unit_ball(u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor):
    """Uniform point in the unit ball, plus the unit-sphere direction it is
    built from (the isotropic phase sample).  Returns
    ((bx, by, bz), (rxy * cos, rxy * sin, z))."""
    zb = 1.0 - 2.0 * u1
    rxy = sqrt_f32(torch.abs(1.0 - zb * zb))
    phi = TWO_PI * u2
    sb = torch.sin(phi)
    cb = torch.cos(phi)
    rad_b = torch.pow(u3, ONE_THIRD)
    ball = (rad_b * rxy * cb, rad_b * rxy * sb, rad_b * zb)
    sphere = (rxy * cb, rxy * sb, zb)
    return ball, sphere
