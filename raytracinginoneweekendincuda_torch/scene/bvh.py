"""Host-side BVH build -> flattened, threaded node arrays (numpy).

The port's own copy of ``raytracinginoneweekendincuda_tpu/scene/bvh.py``:
the reference's longest-axis median split (`BvhNode.h:50-90`, insertion
sort by bbox min along that axis `BvhNode.h:170-193`) on the host, with a
stable sort, and a *threaded* preorder layout (escape links) so that the
traversal needs no stack (`ops/bvh_engine.py`).  The arrays are the JAX
package's pure-Python build, element for element.

The JAX package can also build through its g++ helper (``native/``); the
port keeps only the numpy build, which takes a fraction of a second on
the largest world it renders (`chip_smoke.py` phase 16 times it).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

QUAD_PAD = 1.0e-4  # AABB::PadToMinimums delta (AABB.h:114-120)


class BvhArrays(NamedTuple):
    """Flattened threaded BVH (node 0 = root, DFS preorder).

    ``prim[i] >= 0`` marks a leaf holding that global primitive id
    (< n_spheres: sphere row; else quad row ``prim - n_spheres``).
    ``escape[i]`` is the preorder index to resume at when node ``i``'s
    subtree is skipped (AABB miss) or finished; the root's escape is
    ``n_nodes`` (terminate).
    """

    nmin: np.ndarray    # [M, 3] f32 / f64
    nmax: np.ndarray    # [M, 3]
    prim: np.ndarray    # [M] i32, -1 for internal nodes
    escape: np.ndarray  # [M] i32


def primitive_bounds(scene) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """AABBs + global ids for every *active* sphere and quad.

    Sphere: center +- |r|; moving sphere: union of the boxes at both
    endpoints (MovingSphere.h:30-36).  Quad: box of the two diagonals,
    padded per axis to >= 1e-4 (Quad.h:43-48 + AABB.h:114-120).
    """
    mins, maxs, ids = [], [], []
    S = scene.sph_c0.shape[0]
    sph_active = np.asarray(scene.sph_active)
    c0 = np.asarray(scene.sph_c0, np.float64)
    c1 = c0 + np.asarray(scene.sph_dc, np.float64)
    r = np.abs(np.asarray(scene.sph_rad, np.float64))[:, None]
    lo = np.minimum(c0 - r, c1 - r)
    hi = np.maximum(c0 + r, c1 + r)
    for i in np.nonzero(sph_active)[0]:
        mins.append(lo[i]); maxs.append(hi[i]); ids.append(i)

    quad_active = np.asarray(scene.quad_active)
    q = np.asarray(scene.quad_q, np.float64)
    u = np.asarray(scene.quad_u, np.float64)
    v = np.asarray(scene.quad_v, np.float64)
    corners = np.stack([q, q + u, q + v, q + u + v], 1)    # [Q, 4, 3]
    qlo = corners.min(1)
    qhi = corners.max(1)
    thin = (qhi - qlo) < QUAD_PAD
    pad = 0.5 * QUAD_PAD
    qlo = np.where(thin, qlo - pad, qlo)
    qhi = np.where(thin, qhi + pad, qhi)
    for i in np.nonzero(quad_active)[0]:
        mins.append(qlo[i]); maxs.append(qhi[i]); ids.append(S + i)

    if not mins:
        z = np.zeros((0, 3))
        return z, z.copy(), np.zeros(0, np.int64)
    return np.asarray(mins), np.asarray(maxs), np.asarray(ids, np.int64)


def build_bvh(bbox_min: np.ndarray, bbox_max: np.ndarray,
              prim_ids: np.ndarray, dtype=np.float32) -> BvhArrays:
    """Longest-axis median-split build (BvhNode.h:50-90) -> threaded
    arrays."""
    n = bbox_min.shape[0]
    if n == 0:
        z3 = np.zeros((0, 3), dtype)
        return BvhArrays(z3, z3.copy(), np.zeros(0, np.int32),
                         np.zeros(0, np.int32))

    nmin, nmax, prim, escape = [], [], [], []

    def emit(lo, hi, p):
        nmin.append(lo); nmax.append(hi); prim.append(p); escape.append(-1)
        return len(prim) - 1

    def rec(ids: np.ndarray) -> int:
        lo = bbox_min[ids].min(0)
        hi = bbox_max[ids].max(0)
        if len(ids) == 1:
            return emit(lo, hi, int(prim_ids[ids[0]]))
        axis = int(np.argmax(hi - lo))            # LongestAxis, AABB.h:101-107
        # stable: the insertion sort of BvhNode.h:170-193
        order = np.argsort(bbox_min[ids, axis], kind="stable")
        ids = ids[order]
        mid = len(ids) // 2                       # median split, BvhNode.h:69
        me = emit(lo, hi, -1)
        left_idx = rec(ids[:mid])
        right_idx = rec(ids[mid:])
        escape[left_idx] = right_idx              # after left subtree -> right
        return me

    root = rec(np.arange(n))
    assert root == 0
    m = len(prim)
    # the remaining escapes: where traversal resumes after a node's subtree.
    # The root's subtree ends at m; an internal node's right child inherits
    # the parent's escape; left children were linked to their sibling above.
    esc = np.asarray(escape, np.int64)
    prim_a = np.asarray(prim, np.int32)

    def fill(idx: int, after: int):
        while True:
            if prim_a[idx] >= 0:                  # leaf
                esc[idx] = after
                return
            left = idx + 1
            right = esc[left] if esc[left] >= 0 else -1
            esc[idx] = after
            fill(left, right)                     # left's escape -> right
            idx, after = right, after             # tail-recurse into right

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * m + 100))
    try:
        fill(0, m)
    finally:
        sys.setrecursionlimit(old)

    return BvhArrays(
        nmin=np.asarray(nmin, dtype),
        nmax=np.asarray(nmax, dtype),
        prim=prim_a,
        escape=esc.astype(np.int32),
    )


def build_scene_bvh(scene, dtype=None) -> BvhArrays:
    """BVH over the active spheres + quads of a compiled scene, in the
    scene's float dtype unless ``dtype`` is given."""
    if dtype is None:
        dtype = np.asarray(scene.sph_c0).dtype
    lo, hi, ids = primitive_bounds(scene)
    return build_bvh(lo, hi, ids, dtype=dtype)
