"""3-vector math on ``(..., 3)`` tensors.

Port of ``raytracinginoneweekendincuda_tpu/core/vecmath.py`` (the
reference's ``Vector3`` helpers, Vec3.h:10-141) for any float dtype.  Sums
over the 3-axis are written out component by component, in index order,
so a result does not depend on how a reduction kernel associates them.
"""

from __future__ import annotations

import torch

NEAR_ZERO_EPS = 1e-8  # Vec3.h:58


def sqrt_exact(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in ``x``'s dtype.  PyTorch's
    vectorized f32 CPU sqrt can miss the IEEE result by an ulp; the f64
    root rounded to f32 is exact (53 >= 2*24 + 2 bits), and it is what
    ``sqrtf`` gives on the card."""
    if x.dtype == torch.float64:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def dot(u, v):
    """Dot product over the trailing 3-axis (Vec3.h:108-113)."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def length_squared(v):
    return dot(v, v)


def length(v):
    return sqrt_exact(length_squared(v))


def cross(u, v):
    """Cross product (Vec3.h:115-120)."""
    return torch.stack((
        u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
    ), dim=-1)


def unit_vector(v):
    """v / |v| (Vec3.h:122-125)."""
    return v / length(v)[..., None]


def near_zero(v):
    """True where all three components are below 1e-8 (Vec3.h:56-63)."""
    a = torch.abs(v)
    return (a[..., 0] < NEAR_ZERO_EPS) & (a[..., 1] < NEAR_ZERO_EPS) \
        & (a[..., 2] < NEAR_ZERO_EPS)


def reflect(v, n):
    """Mirror reflection about normal n (Vec3.h:127-130)."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(uv, n, eta_ratio):
    """Snell refraction of unit vector ``uv`` about ``n`` (Vec3.h:132-141);
    ``eta_ratio`` has the batch shape."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    r_perp = eta_ratio[..., None] * (uv + cos_theta[..., None] * n)
    k = torch.abs(1.0 - length_squared(r_perp))
    pos = k > 0
    root = torch.where(pos, sqrt_exact(torch.where(pos, k, 1.0)), 0.0)
    return r_perp + (-root)[..., None] * n
