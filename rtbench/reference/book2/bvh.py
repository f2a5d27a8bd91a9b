"""The reference CUDA repository's BVH over a Book 2 world's top-level
hittables, in plain PyTorch, to count the work its own algorithm does on
given rays: the yardstick of K1's roofline on these worlds
(`rtbench/roofline/k1_world.py`).

The reference adds each hittable of a scene to one list and builds one
BvhNode over it (kernel.cu:436-528).  A leaf is one hittable:

- a box: MakeBox's owning list of six quads, whose ``HittableList::Hit``
  tests all six (six quad tests);
- a quad, or a sphere (one test each; a moving sphere boxed over its
  motion);
- a medium: ``ConstantMedium::Hit``, its boundary hit twice and a draw
  (one medium test);
- an instance, Translate(RotateY(an owning list of spheres)): one
  instance entry, then ``HittableList::Hit`` over every sphere of the
  list.  The list has no BVH of its own: SURVEY.md (§3.2-3.3) gives the
  1,000-sphere cluster as an owning HittableList hit in a loop, and the
  1,024 BVH nodes that kernel.cu:630-639 allocates could not hold a
  second tree over it.

A leaf's box is its hittable's ``BoundingBox``: a sphere's over its
motion, a quad's over its corners with a flat side padded to 1e-4 (Book
2's ``aabb::pad_to_minimums``), a box's the union of its faces', a
medium's its boundary's, an instance's the rotated corners of its list's
box, offset (Instance.h:33-37, 83-111); rounded outward to f32.  The
tree is built as `../bvh.py` builds it (``BvhNode.h:50-90``, a hittable a
leaf) and walked as `../bvh.py` walks it (``BvhNode::Hit``, the slab
test of ``AABB.h:68-98`` against ``[t_min, closest]``), closest in t.  A
hit leaf runs the tracer's own test of its hittable (`tracer.py`: the
sphere key, the quad, the box slab, the medium's draw, a brute force over
the instance's spheres), so that its winners are the tracer's; of equal
t the lower surface row wins, as in the tracer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bvh import longest_axis
from ..tracer import BIG, HALF_BIG, sphere_keys
from . import tracer
from .world import Box, Instance, Medium, Quad, Sphere, World, sphere_box

SPHERE, QUAD, BOX, MEDIUM, INSTANCE = range(5)
COUNTS = ("box_tests", "sphere_tests", "quad_tests", "medium_tests",
          "instance_entries")
PAD = 1.0e-4


class Tree(NamedTuple):
    """Nodes in depth-first order, the root first, on one device; a leaf
    names its hittable's kind and its first row in the tracer's tables."""
    lo: torch.Tensor        # [M, 3] f32 box
    hi: torch.Tensor        # [M, 3]
    left: torch.Tensor      # [M] int64, -1 for a leaf
    right: torch.Tensor     # [M] int64, -1 for a leaf
    kind: torch.Tensor      # [M] int64, -1 for an internal node
    ref: torch.Tensor       # [M] int64: sphere / quad / box / medium row,
                            # an instance's first sphere row
    size: torch.Tensor      # [M] int64: an instance's spheres
    height: int             # internal nodes on the longest root-leaf path


def _quad_box(q: Quad) -> tuple:
    c = np.asarray(q.q, np.float64)
    u, v = np.asarray(q.u, np.float64), np.asarray(q.v, np.float64)
    pts = np.stack([c, c + u, c + v, c + u + v])
    lo, hi = pts.min(0), pts.max(0)
    thin = hi - lo < PAD
    return np.where(thin, lo - PAD / 2, lo), np.where(thin, hi + PAD / 2, hi)


def leaves(world: World) -> list:
    """(kind, first row, rows, lo, hi) of each top-level hittable, its box
    in f64, rows counted as `tracer.tables` lays them out."""
    out, n = [], dict(s=0, q=0, b=0, m=0)
    for h in world.hittables:
        if isinstance(h, Sphere):
            out.append((SPHERE, n["s"], 1, *sphere_box(h)))
            n["s"] += 1
        elif isinstance(h, Instance):
            k = len(h.spheres)
            out.append((INSTANCE, n["s"], k, *h.box()))
            n["s"] += k
        elif isinstance(h, Quad):
            out.append((QUAD, n["q"], 1, *_quad_box(h)))
            n["q"] += 1
        elif isinstance(h, Box):
            boxes = [_quad_box(q) for q in h.quads()]
            out.append((BOX, n["b"], 1, np.min([b[0] for b in boxes], 0),
                        np.max([b[1] for b in boxes], 0)))
            n["b"] += 1
        elif isinstance(h, Medium):
            out.append((MEDIUM, n["m"], 1, *sphere_box(h.boundary)))
            n["m"] += 1
        else:
            raise TypeError(f"no Book 2 hittable: {type(h)}")
    return out


def _outward(lo, hi) -> tuple:
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32.astype(np.float64), hi32.astype(np.float64)


def build(world: World, device) -> Tree:
    """The tree over the world's top-level hittables, on ``device``."""
    lv = leaves(world)
    blo, bhi = _outward(np.stack([x[3] for x in lv]),
                        np.stack([x[4] for x in lv]))
    cols = dict(lo=[], hi=[], left=[], right=[], kind=[], ref=[], size=[])

    def node(ids) -> tuple:
        me = len(cols["kind"])
        cols["lo"].append(blo[ids].min(0))
        cols["hi"].append(bhi[ids].max(0))
        one = lv[ids[0]] if len(ids) == 1 else (-1, -1, 0)
        for k, v in zip(("left", "right", "kind", "ref", "size"),
                        (-1, -1, *one[:3])):
            cols[k].append(v)
        if len(ids) == 1:
            return me, 0
        cur = cols["hi"][me] - cols["lo"][me]
        ids = ids[np.argsort(blo[ids, longest_axis(cur)], kind="stable")]
        mid = len(ids) // 2
        cols["left"][me], hl = node(ids[:mid])
        cols["right"][me], hr = node(ids[mid:])
        return me, 1 + max(hl, hr)

    _, height = node(np.arange(len(lv)))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    return Tree(f32(cols["lo"]), f32(cols["hi"]), i64(cols["left"]),
                i64(cols["right"]), i64(cols["kind"]), i64(cols["ref"]),
                i64(cols["size"]), height)


def _leaf_tests(fr, kind: int, ref, size, o, d, tm, a, inv_a, akey,
                pix_ctr, samp, bounce):
    """(t or BIG, surface row, tests by `COUNTS` [5, n]) of rays on leaves
    of one kind, ``ref`` their first rows and ``size`` an instance's
    spheres."""
    tab, n = fr.tab, o.shape[0]
    S, Q = tab.s_c0.shape[0], tab.q_n.shape[0]
    cnt = torch.zeros((5, n), dtype=torch.int64, device=o.device)
    ou, du = o.unbind(1), d.unbind(1)
    if kind == SPHERE:
        key = sphere_keys(ou, du, tm, a, akey, tab.s_c0[ref].unbind(1),
                          tab.s_dc[ref].unbind(1), tab.s_t0[ref],
                          tab.s_inv_dt[ref], tab.s_rad2[ref])
        cnt[1] = 1
        return torch.where(key < HALF_BIG, key * inv_a, BIG), ref, cnt
    if kind == QUAD:
        t = tracer.quad_t(ou, du, tab.q_n[ref].unbind(1), tab.q_d[ref],
                          tab.q_a[ref].unbind(1), tab.q_a0[ref],
                          tab.q_b[ref].unbind(1), tab.q_b0[ref], fr.t_min)
        cnt[2] = 1
        return t, S + ref, cnt
    if kind == BOX:
        t, face = tracer.box_hits(tab.b_lo[ref].unbind(1),
                                  tab.b_hi[ref].unbind(1), ou, du, fr.t_min)
        cnt[2] = 6
        return t, S + Q + 6 * ref + face, cnt
    t = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    row = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    for r0 in ref.unique().tolist():
        s = (ref == r0).nonzero()[:, 0]
        if kind == MEDIUM:
            u = tracer.medium_draw(pix_ctr[s], samp[s], bounce[s], r0,
                                   fr.dtype)
            tm_, ok = tracer.medium_hit(tab.media[r0], o[s], d[s], a[s],
                                        inv_a[s], fr.t_min, u)
            t[s] = torch.where(ok, tm_, BIG)
            row[s] = tab.rows + r0
            cnt[3, s] = 1
        else:
            k = int(size[s[0]])
            part = slice(r0, r0 + k)
            sub = tab._replace(s_c0=tab.s_c0[part], s_dc=tab.s_dc[part],
                               s_t0=tab.s_t0[part],
                               s_inv_dt=tab.s_inv_dt[part],
                               s_rad2=tab.s_rad2[part])
            key, idx = tracer.closest_spheres(sub, o[s], d[s], tm[s], a[s],
                                              akey[s])
            t[s] = torch.where(key < HALF_BIG, key * inv_a[s], BIG)
            row[s] = torch.where(idx >= 0, r0 + idx, -1)
            cnt[1, s] = k
            cnt[4, s] = 1
    return t, row, cnt


def walk(tree: Tree, fr, o, d, tm, pix_ctr, samp, bounce) -> tuple:
    """The walk of rays (``o``, ``d`` [N, 3], ``tm`` [N] f32; ``pix_ctr``,
    ``samp``, ``bounce`` [N] int, for the media's draws): (tests [5, N]
    int64 by `COUNTS`, winning surface row or -1 [N], its t or BIG [N])."""
    N, dev = o.shape[0], o.device
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    inv_a = 1.0 / a
    akey = fr.t_min * a
    inv = 1.0 / d
    counts = torch.zeros((5, N), dtype=torch.int64, device=dev)
    win = torch.full((N,), -1, dtype=torch.int64, device=dev)
    t_win = torch.full((N,), BIG, dtype=o.dtype, device=dev)
    # the live rays' state; finished rays are written out and dropped
    ray = torch.arange(N, device=dev)
    best = t_win.clone()
    won = win.clone()
    cnt = counts.clone()
    stack = torch.zeros((N, tree.height + 2), dtype=torch.int64, device=dev)
    sp = torch.ones(N, dtype=torch.int64, device=dev)
    row = torch.arange(N, device=dev)
    while ray.numel():
        sp -= 1
        nd = stack[row, sp]
        ro, rinv = o[ray], inv[ray]
        t0 = (tree.lo[nd] - ro) * rinv
        t1 = (tree.hi[nd] - ro) * rinv
        near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
        lo = torch.full_like(best, fr.t_min)
        hi = best
        for k in range(3):
            lo = torch.fmax(lo, near[:, k])
            hi = torch.fmin(hi, far[:, k])
        hit = hi > lo
        cnt[0] += 1
        leaf = tree.kind[nd] >= 0
        push = (hit & ~leaf).nonzero()[:, 0]
        stack[push, sp[push]] = tree.right[nd[push]]
        stack[push, sp[push] + 1] = tree.left[nd[push]]
        sp[push] += 2
        test = (hit & leaf).nonzero()[:, 0]
        kinds = tree.kind[nd[test]]
        for kind in kinds.unique().tolist():
            sel = test[kinds == kind]
            r = ray[sel]
            t, rw, c = _leaf_tests(fr, kind, tree.ref[nd[sel]],
                                   tree.size[nd[sel]], o[r], d[r], tm[r],
                                   a[r], inv_a[r], akey[r], pix_ctr[r],
                                   samp[r], bounce[r])
            b, w = best[sel], won[sel]
            nearer = (t < b) | ((t == b) & (t < BIG) & (rw < w))
            best[sel] = torch.where(nearer, t, b)
            won[sel] = torch.where(nearer, rw, w)
            cnt[:, sel] += c
        done = sp == 0
        if done.any():
            fin = ray[done]
            counts[:, fin] = cnt[:, done]
            win[fin], t_win[fin] = won[done], best[done]
            keep = (~done).nonzero()[:, 0]
            ray, best, won = ray[keep], best[keep], won[keep]
            cnt, stack, sp = cnt[:, keep], stack[keep], sp[keep]
            row = row[:keep.numel()]
    return counts, win, t_win
