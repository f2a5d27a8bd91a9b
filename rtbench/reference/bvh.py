"""The reference CUDA repository's BVH over a sphere world, in plain
PyTorch, to count the work its own algorithm does on given rays: the
yardstick of K1's roofline (`rtbench/roofline/k1.py`).

Build (``BvhNode.h:50-90``): a node boxes its spheres, sorts them stably
by box minimum along the longest axis of that box (``AABB.h:101-107``:
x only where it is longer than both others, else y only where it is
longer than z, else z) and splits them at the median, ``n // 2`` to the
left; one sphere a leaf, boxed by its own box.  A moving sphere is boxed
over its whole motion, centre ``c0`` to ``c0 + dc`` (``MovingSphere``'s
bounding box).  The boxes are rounded outward to f32.

Walk (``BvhNode::Hit``, ``BvhNode.h:101-158``): an explicit stack starts
with the root.  Each popped node's box is tested by the slab test of
``AABB.h:68-98`` (per axis ``1 / d``, the two slab distances, their
``fminf`` / ``fmaxf``, then the interval's bounds; a hit where the
interval stays open) against ``[t_min, closest]``.  A hit internal node
pushes its right child, then its left, so the left is walked first; a
hit leaf tests its sphere with the tracer's own sphere test
(`tracer.sphere_keys`), and a nearer hit shrinks ``closest``.  Of equal
keys the lower sphere index wins, as in `tracer._closest`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .tracer import BIG, HALF_BIG, sphere_keys
from .world import Tables


class Tree(NamedTuple):
    """Nodes in depth-first order, the root first, on one device."""
    lo: torch.Tensor        # [M, 3] f32 box
    hi: torch.Tensor        # [M, 3]
    left: torch.Tensor      # [M] int64, -1 for a leaf
    right: torch.Tensor     # [M] int64, -1 for a leaf
    sphere: torch.Tensor    # [M] int64, -1 for an internal node
    height: int             # internal nodes on the longest root-leaf path


def sphere_boxes(tab: Tables) -> tuple:
    """(lo [S, 3], hi [S, 3]) f32 (as float64 arrays) of each sphere over
    its motion, rounded outward from their f64 values."""
    c0 = tab.c0.double().cpu().numpy()
    c1 = c0 + tab.dc.double().cpu().numpy()
    r = np.abs(tab.rad.double().cpu().numpy())[:, None]
    lo = np.minimum(c0, c1) - r
    hi = np.maximum(c0, c1) + r
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32.astype(np.float64), hi32.astype(np.float64)


def longest_axis(size) -> int:
    """``AABB::LongestAxis``: ties go to the later axis."""
    if size[0] > size[1]:
        return 0 if size[0] > size[2] else 2
    return 1 if size[1] > size[2] else 2


def build(tab: Tables) -> Tree:
    """The tree over every sphere of ``tab``, on its device."""
    blo, bhi = sphere_boxes(tab)
    lo, hi, left, right, sphere = [], [], [], [], []

    def node(ids) -> tuple:
        """(index, height) of the subtree over spheres ``ids``."""
        me = len(sphere)
        lo.append(blo[ids].min(0))
        hi.append(bhi[ids].max(0))
        left.append(-1)
        right.append(-1)
        sphere.append(int(ids[0]) if len(ids) == 1 else -1)
        if len(ids) == 1:
            return me, 0
        axis = longest_axis(hi[me] - lo[me])
        ids = ids[np.argsort(blo[ids, axis], kind="stable")]
        mid = len(ids) // 2
        left[me], hl = node(ids[:mid])
        right[me], hr = node(ids[mid:])
        return me, 1 + max(hl, hr)

    _, height = node(np.arange(tab.rad.shape[0]))
    dev = tab.rad.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
    return Tree(f32(lo), f32(hi), i64(left), i64(right), i64(sphere), height)


def walk(tree: Tree, tab: Tables, o, d, tm, t_min: float) -> tuple:
    """The walk of rays (origin ``o`` [N, 3], direction ``d`` [N, 3], time
    ``tm`` [N], f32): (box tests [N], sphere tests [N], winning sphere or
    -1 [N]), all int64."""
    N, dev = o.shape[0], o.device
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    akey = t_min * a
    inv = 1.0 / d
    boxes = torch.zeros(N, dtype=torch.int64, device=dev)
    spheres = torch.zeros(N, dtype=torch.int64, device=dev)
    win = torch.full((N,), -1, dtype=torch.int64, device=dev)
    # the live rays' state; finished rays are written out and dropped
    ray = torch.arange(N, device=dev)
    best = torch.full((N,), BIG, dtype=o.dtype, device=dev)
    won = win.clone()
    nb = torch.zeros_like(boxes)
    ns = torch.zeros_like(boxes)
    stack = torch.zeros((N, tree.height + 2), dtype=torch.int64, device=dev)
    sp = torch.ones_like(boxes)
    row = torch.arange(N, device=dev)
    while ray.numel():
        sp -= 1
        nd = stack[row, sp]
        ro, rinv = o[ray], inv[ray]
        t0 = (tree.lo[nd] - ro) * rinv
        t1 = (tree.hi[nd] - ro) * rinv
        near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
        lo = torch.full_like(best, t_min)
        hi = torch.where(best < HALF_BIG, best * (1.0 / a[ray]), BIG)
        for k in range(3):
            lo = torch.fmax(lo, near[:, k])
            hi = torch.fmin(hi, far[:, k])
        hit = hi > lo
        nb += 1
        leaf = tree.sphere[nd] >= 0
        push = (hit & ~leaf).nonzero()[:, 0]
        stack[push, sp[push]] = tree.right[nd[push]]
        stack[push, sp[push] + 1] = tree.left[nd[push]]
        sp[push] += 2
        test = (hit & leaf).nonzero()[:, 0]
        if test.numel():
            r, s = ray[test], tree.sphere[nd[test]]
            key = sphere_keys(
                o[r].unbind(1), d[r].unbind(1), tm[r], a[r], akey[r],
                tab.c0[s].unbind(1), tab.dc[s].unbind(1), tab.t0[s],
                tab.inv_dt[s], tab.rad2[s])
            b, w = best[test], won[test]
            nearer = (key < b) | ((key == b) & (key < BIG) & (s < w))
            best[test] = torch.where(nearer, key, b)
            won[test] = torch.where(nearer, s, w)
            ns[test] += 1
        done = sp == 0
        if done.any():
            fin = ray[done]
            boxes[fin], spheres[fin], win[fin] = nb[done], ns[done], won[done]
            keep = (~done).nonzero()[:, 0]
            ray, best, won, nb, ns = (x[keep] for x in (ray, best, won, nb,
                                                         ns))
            stack, sp = stack[keep], sp[keep]
            row = row[:keep.numel()]
    return boxes, spheres, win
