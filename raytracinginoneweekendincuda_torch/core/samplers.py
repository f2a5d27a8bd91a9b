"""Branchless samplers used by raygen and scatter.

Port of ``raytracinginoneweekendincuda_tpu/core/samplers.py``.  The lens
disk serves every engine.  `unit_ball` follows the op order of the mega2
kernel (``ops/mega2.py:_scatter_dirs``) in f32; `unit_ball_xyz` and
`unit_sphere_surface` are the XLA engines' samplers as written, for f32
and f64.  Square roots are correctly rounded (:func:`sqrt_f32`).  The
``*_numpy`` samplers are the JAX package's ``xp=np`` paths, expression for
expression, for the f64 oracle (`testing/oracle.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from .vecmath import sqrt_exact

TWO_PI = float(np.float32(2.0 * np.pi))
ONE_THIRD = float(np.float32(1.0 / 3.0))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  PyTorch's vectorized CPU sqrt can
    miss the IEEE result by an ulp; the f64 root rounded to f32 is exact
    (53 >= 2*24 + 2 bits), and it is what ``sqrtf`` gives on the card."""
    return torch.sqrt(x.double()).float()


def unit_disk(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform point in the unit disk: (r cos phi, r sin phi), r = sqrt(u1),
    in ``u1``'s dtype (f32 or f64)."""
    r = sqrt_exact(u1)
    phi = (2.0 * np.pi) * u2
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


# ---- the XLA engines' samplers, any float dtype (the JAX package's
# core/samplers.py as written: stacked [..., 3] results, guarded roots)


def safe_root(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x ** p`` for ``x > 0``, else exactly 0 (``_safe_root``).  ``p`` is
    0.5 (a correctly rounded sqrt) or 1/3 (``pow`` with the exponent
    rounded to ``x``'s dtype, as JAX's weakly typed literal is)."""
    pos = x > 0
    xs = torch.where(pos, x, 1.0)
    if p == 0.5:
        r = sqrt_exact(xs)
    else:
        r = torch.pow(xs, float(np.float32(p)) if x.dtype == torch.float32
                      else p)
    return torch.where(pos, r, 0.0)


def unit_ball_xyz(u1, u2, u3) -> torch.Tensor:
    """Uniform point in the unit ball [..., 3]: z uniform, azimuth
    uniform, cube-root radius (replaces the rejection loop at
    Material.h:14-24)."""
    z = 1.0 - 2.0 * u1
    phi = (2.0 * np.pi) * u2
    rho = safe_root(1.0 - z * z, 0.5)
    r = safe_root(u3, 1.0 / 3.0)
    return torch.stack((r * rho * torch.cos(phi), r * rho * torch.sin(phi),
                        r * z), dim=-1)


def unit_sphere_surface(u1, u2) -> torch.Tensor:
    """Uniform direction on the unit sphere [..., 3] (the isotropic phase
    function, Material.h:160), from the same (u1, u2) as the ball."""
    z = 1.0 - 2.0 * u1
    phi = (2.0 * np.pi) * u2
    rho = safe_root(1.0 - z * z, 0.5)
    return torch.stack((rho * torch.cos(phi), rho * torch.sin(phi), z),
                       dim=-1)


# ---- the same samplers over numpy arrays / scalars (the JAX package's
# ``xp=np`` paths as written), for the f64 oracle

TWO_PI_F64 = 2.0 * np.pi


def _safe_root_numpy(x, p):
    pos = x > 0
    return np.where(pos, np.where(pos, x, 1.0) ** p, 0.0)


def unit_ball_numpy(u1, u2, u3):
    """Uniform point in the unit ball [..., 3] (numpy)."""
    z = 1.0 - 2.0 * u1
    phi = TWO_PI_F64 * u2
    rho = _safe_root_numpy(1.0 - z * z, 0.5)
    r = _safe_root_numpy(u3, 1.0 / 3.0)
    return np.stack((r * rho * np.cos(phi), r * rho * np.sin(phi), r * z),
                    axis=-1)


def unit_sphere_surface_numpy(u1, u2):
    """Uniform direction on the unit sphere [..., 3] (numpy)."""
    z = 1.0 - 2.0 * u1
    phi = TWO_PI_F64 * u2
    rho = _safe_root_numpy(1.0 - z * z, 0.5)
    return np.stack((rho * np.cos(phi), rho * np.sin(phi), z), axis=-1)


def unit_disk_numpy(u1, u2):
    """Uniform point in the unit disk [..., 2] (numpy)."""
    r = _safe_root_numpy(u1, 0.5)
    theta = TWO_PI_F64 * u2
    return np.stack((r * np.cos(theta), r * np.sin(theta)), axis=-1)
