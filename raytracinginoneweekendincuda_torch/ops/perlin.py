"""Perlin lattice noise evaluation, batched over rays.

Port of ``raytracinginoneweekendincuda_tpu/ops/perlin.py``: XOR-hashed
permutation lookups into the gradient table (Perlin.h:49-57), Hermite
smoothed trilinear interpolation of gradient dots (Perlin.h:120-139) and
the 7-octave turbulence sum (Perlin.h:64-78), with libm ``sin`` left to
the caller.  These are the XLA engines' formulas, not the polynomials of
the mega2 kernel.

The eight lattice corners and the seven octaves run at once along leading
axes, each point's operations those of the JAX package's loops, and the
corners' and octaves' terms are summed in its loop order, so the values
are the loops' bit for bit at a few dozen launches a call.
"""

from __future__ import annotations

import torch

# the lattice corners (di, dj, dk) in the loop order of Perlin.h:126-134
CORNERS = tuple((di, dj, dk) for di in (0, 1) for dj in (0, 1)
                for dk in (0, 1))


def noise(perlin_vec, px, py, pz, nid, p):
    """Perlin noise in [-1, 1] at points ``p`` [..., B, 3] using table
    ``nid`` [B] (int64) of the [NT, 256, 3] / [NT, 256] tables; returns
    [..., B]."""
    fl = torch.floor(p)
    uvw = p - fl
    ijk = fl.to(torch.int64)

    # Hermite cubic smoothing (Perlin.h:122-124)
    s = uvw * uvw * (3.0 - 2.0 * uvw)

    corner = torch.tensor(CORNERS, device=p.device).reshape(
        (8,) + (1,) * (p.dim() - 1) + (3,))              # [8, ..., 1, 3]
    idx = (ijk + corner) & 255                            # [8, ..., B, 3]
    xi = px[nid, idx[..., 0]]
    yj = py[nid, idx[..., 1]]
    zk = pz[nid, idx[..., 2]]
    grad = perlin_vec[nid, xi ^ yj ^ zk]                  # [8, ..., B, 3]
    off = uvw - corner.to(p.dtype)
    dot = (grad[..., 0] * off[..., 0] + grad[..., 1] * off[..., 1]
           + grad[..., 2] * off[..., 2])
    w = torch.where(corner.bool(), s, 1.0 - s)            # wu, wv, ww
    term = w[..., 0] * w[..., 1] * w[..., 2] * dot        # [8, ..., B]

    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for t in term:
        accum = accum + t
    return accum


def turbulence(perlin_vec, px, py, pz, nid, p, depth: int = 7):
    """|sum_i 0.5^i noise(2^i p)| (Perlin.h:64-78) at points ``p`` [B, 3]
    (2^i p exactly the loop's repeated doubling)."""
    scale = torch.tensor([2.0 ** i for i in range(depth)], dtype=p.dtype,
                         device=p.device)
    octaves = noise(perlin_vec, px, py, pz, nid, p * scale[:, None, None])
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    for n in octaves:
        accum = accum + weight * n
        weight *= 0.5
    return torch.abs(accum)
