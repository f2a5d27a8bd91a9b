"""Perlin lattice noise evaluation, batched over rays.

Port of ``raytracinginoneweekendincuda_tpu/ops/perlin.py``: XOR-hashed
permutation lookups into the gradient table (Perlin.h:49-57), Hermite
smoothed trilinear interpolation of gradient dots (Perlin.h:120-139) and
the 7-octave turbulence sum (Perlin.h:64-78), with libm ``sin`` left to
the caller.  These are the XLA engines' formulas, not the polynomials of
the mega2 kernel.
"""

from __future__ import annotations

import torch


def noise(perlin_vec, px, py, pz, nid, p):
    """Perlin noise in [-1, 1] at points ``p`` [B, 3] using table ``nid``
    [B] (int64) of the [NT, 256, 3] / [NT, 256] tables."""
    fl = torch.floor(p)
    uvw = p - fl
    ijk = fl.to(torch.int64)
    i, j, k = ijk[..., 0], ijk[..., 1], ijk[..., 2]

    # Hermite cubic smoothing (Perlin.h:122-124)
    s = uvw * uvw * (3.0 - 2.0 * uvw)
    su, sv, sw = s[..., 0], s[..., 1], s[..., 2]

    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in (0, 1):
        xi = px[nid, (i + di) & 255]
        wu = su if di else (1.0 - su)
        for dj in (0, 1):
            yj = py[nid, (j + dj) & 255]
            wv = sv if dj else (1.0 - sv)
            for dk in (0, 1):
                zk = pz[nid, (k + dk) & 255]
                ww = sw if dk else (1.0 - sw)
                grad = perlin_vec[nid, xi ^ yj ^ zk]           # [B, 3]
                dot = (grad[..., 0] * (uvw[..., 0] - di)
                       + grad[..., 1] * (uvw[..., 1] - dj)
                       + grad[..., 2] * (uvw[..., 2] - dk))
                accum = accum + wu * wv * ww * dot
    return accum


def turbulence(perlin_vec, px, py, pz, nid, p, depth: int = 7):
    """|sum_i 0.5^i noise(2^i p)| (Perlin.h:64-78)."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    q = p
    for _ in range(depth):
        accum = accum + weight * noise(perlin_vec, px, py, pz, nid, q)
        weight *= 0.5
        q = q * 2.0
    return torch.abs(accum)
