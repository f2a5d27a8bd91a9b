"""Host-side Perlin noise table generation.

The reference builds its 256-entry gradient-vector + 3 permutation tables on
the device with sequential curand draws (Perlin.h:27-35, Fisher-Yates at
Perlin.h:104-116).  Table *construction* is one-shot setup, not a parallel
workload — it belongs on the host; only the lattice *lookup* is hot and lives
in the engine (`ops/perlin.py`).

Distribution parity: gradient vectors are normalized uniform-in-cube samples
(exactly the reference's ``UnitVector(RandomVector(-1,1))``, Perlin.h:30 —
deliberately *not* uniform on the sphere), and the permutations are uniform
shuffles.

The port's own copy of ``raytracinginoneweekendincuda_tpu/scene/perlin.py`` (same
arithmetic; only the package it lives in differs).
"""

from __future__ import annotations

import numpy as np

POINT_COUNT = 256  # Perlin.h:81


def make_perlin_tables(table_seed: int):
    """Returns (rand_vec [256,3] f64, perm_x, perm_y, perm_z [256] i32)."""
    rs = np.random.default_rng(np.uint64(0x9E3779B97F4A7C15) ^ np.uint64(table_seed))
    v = rs.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    # guard the (measure-zero) zero vector before normalizing
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    norms[norms == 0.0] = 1.0
    rand_vec = v / norms
    perms = [rs.permutation(POINT_COUNT).astype(np.int32) for _ in range(3)]
    return rand_vec, perms[0], perms[1], perms[2]
