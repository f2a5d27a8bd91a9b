"""Threaded-BVH closest-hit engine (engines ``bvh`` and ``wavefront_bvh``).

Port of ``raytracinginoneweekendincuda_tpu/ops/bvh_engine.py``, plain
PyTorch: the JAX engine is XLA (a ``lax.while_loop``), not a Pallas
kernel.  The reference walks its tree with a per-thread 32-entry stack
(`BvhNode.h:101-158`); the threaded layout (`scene/bvh.py`) needs none:
each ray's traversal state is one integer -- descend to ``node + 1`` on
an AABB hit of an internal node, else jump to ``escape[node]``.  The
whole batch advances in lockstep until every lane has walked off the end.
Leaf tests are the sphere / quad hit math of `ops/hit.py` for one
gathered primitive a (ray, step), and the closest-so-far ``t_best``
prunes boxes as the reference's shrinking tMax does (`BvhNode.h:150`).
Constant media are tested brute-force and merged by the shared tail,
`hit.record_from_geo_winner`.

Two differences from the JAX code, neither in the values:

* JAX bitcasts the integer ``prim`` / ``escape`` columns into its f32
  node table so that one gather fetches a node (an XLA gather-packing
  trick); here they are int tensors of their own.
* JAX tests its loop condition, ``(node < M).any()``, every step.  Here
  that test is a host sync, so it runs every `SYNC_EVERY` steps: a step
  leaves a finished lane (``node >= M``) as it is, so the extra steps
  change nothing.

``lax.while_loop`` has no reverse-mode derivative, so no gradient is
asked of the traversal; the scan form of `integrator.trace` runs over it
forward only, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..scene.bvh import BvhArrays
from . import hit as hit_ops
from .integrator import trace

BIG = hit_ops.BIG
SYNC_EVERY = 8   # traversal steps between two tests of the loop condition


class BvhTables(NamedTuple):
    """Node and primitive columns on the device, and the shared record /
    shade tables."""
    nlo: torch.Tensor     # [M, 3] node box
    nhi: torch.Tensor     # [M, 3]
    prim: torch.Tensor    # [M] int64, -1 for internal nodes
    escape: torch.Tensor  # [M] int64
    sph: torch.Tensor     # [S, 9] c0(3) dc(3) t0 inv_dt rad
    quad: torch.Tensor    # [Q, 12] n_unit(3) d_plane vxw(3) q_vxw wxu(3) q_wxu
    der: hit_ops.Derived


def pack_tables(scene, bvh: BvhArrays) -> BvhTables:
    """The traversal's tables for a tensor scene (`hit.scene_tensors`)
    and its BVH arrays (numpy), on the scene's device in its dtype."""
    f = scene.sph_rad.dtype
    dev = scene.sph_rad.device
    as_f = lambda a: torch.as_tensor(a, dtype=f, device=dev)
    as_i = lambda a: torch.as_tensor(a, device=dev).to(torch.int64)
    col = lambda a: a.to(f)[:, None]
    der = hit_ops.derive(scene)
    dq = der.dq
    sph = torch.cat([scene.sph_c0, scene.sph_dc, col(scene.sph_t0),
                     col(scene.sph_inv_dt), col(scene.sph_rad)], dim=1)
    quad = torch.cat([dq["n_unit"], dq["d_plane"][:, None], dq["vxw"],
                      dq["q_vxw"][:, None], dq["wxu"],
                      dq["q_wxu"][:, None]], dim=1)
    return BvhTables(nlo=as_f(bvh.nmin), nhi=as_f(bvh.nmax),
                     prim=as_i(bvh.prim), escape=as_i(bvh.escape),
                     sph=sph, quad=quad, der=der)


def _slab_min(ta, tb):
    """CUDA ``fminf``: the other operand where one is NaN.  ``0 * inf``
    makes a NaN in ta or tb when a direction component is 0 and the origin
    lies on a slab bound; ``torch.minimum`` would carry it and cull a node
    that the brute-force engine hits."""
    return torch.where(ta < tb, ta, torch.where(torch.isnan(tb), ta, tb))


def _slab_max(ta, tb):
    """CUDA ``fmaxf`` (see `_slab_min`)."""
    return torch.where(ta > tb, ta, torch.where(torch.isnan(tb), ta, tb))


def traverse(tabs: BvhTables, S: int, o, d, time, t_min):
    """Stackless traversal of every ray -> (t_best [B], prim [B] int64,
    -1 = no geometry hit, steps run)."""
    B = o.shape[0]
    M = tabs.prim.shape[0]
    Q = tabs.quad.shape[0]
    node = torch.zeros(B, dtype=torch.int64, device=o.device)
    t_best = torch.full((B,), BIG, dtype=o.dtype, device=o.device)
    best_p = torch.full((B,), -1, dtype=torch.int64, device=o.device)
    inv_d = 1.0 / d                                  # per ray, hoisted
    a_coef = vm.dot(d, d)
    steps = 0
    while M > 0:
        for _ in range(SYNC_EVERY):
            live = node < M
            nid = torch.clamp(node, max=M - 1)
            lo = tabs.nlo.index_select(0, nid)
            hi = tabs.nhi.index_select(0, nid)
            prim = tabs.prim.index_select(0, nid)
            esc = tabs.escape.index_select(0, nid)

            # branchless slab test with the shrinking tMax (AABB.h:68-98,
            # BvhNode.h:150)
            ta = (lo - o) * inv_d
            tb = (hi - o) * inv_d
            near = torch.clamp_min(_slab_min(ta, tb).amax(-1), t_min)
            far = torch.minimum(_slab_max(ta, tb).amin(-1), t_best)
            box_hit = (far > near) & live
            is_leaf = prim >= 0
            test = box_hit & is_leaf

            # leaf sphere (Sphere.h:29-59 / MovingSphere.h:52-58), direct
            # oc form
            srow = tabs.sph.index_select(0, torch.clamp(prim, 0, S - 1))
            frac = (time - srow[:, 6]) * srow[:, 7]
            center = srow[:, 0:3] + frac[:, None] * srow[:, 3:6]
            oc = o - center
            b_half = vm.dot(oc, d)
            c_coef = vm.dot(oc, oc) - srow[:, 8] * srow[:, 8]
            disc = b_half * b_half - a_coef * c_coef
            dpos = disc > 0.0
            sq = vm.sqrt_exact(torch.where(dpos, disc, 1.0))
            root1 = (-b_half - sq) / a_coef
            root2 = (-b_half + sq) / a_coef
            t_sph = torch.where(root1 > t_min, root1, root2)
            sph_ok = dpos & (t_sph > t_min)

            # leaf quad (Quad.h:52-99)
            qrow = tabs.quad.index_select(
                0, torch.clamp(prim - S, 0, Q - 1))
            n_unit = qrow[:, 0:3]
            denom = vm.dot(d, n_unit)
            denom_ok = torch.abs(denom) >= hit_ops.QUAD_PARALLEL_EPS
            t_quad = (qrow[:, 3] - vm.dot(o, n_unit)) \
                / torch.where(denom_ok, denom, 1.0)
            pq = o + t_quad[:, None] * d
            alpha = vm.dot(pq, qrow[:, 4:7]) - qrow[:, 7]
            beta = vm.dot(pq, qrow[:, 8:11]) - qrow[:, 11]
            quad_ok = (denom_ok & (t_quad >= t_min)
                       & (alpha >= 0.0) & (alpha <= 1.0)
                       & (beta >= 0.0) & (beta <= 1.0))

            is_sph = prim < S
            t_cand = torch.where(is_sph, t_sph, t_quad)
            ok = test & torch.where(is_sph, sph_ok, quad_ok) \
                & (t_cand < t_best)                  # strict: first hit wins
            t_best = torch.where(ok, t_cand, t_best)
            best_p = torch.where(ok, prim, best_p)
            node = torch.where(live, torch.where(box_hit & ~is_leaf,
                                                 node + 1, esc), node)
        steps += SYNC_EVERY
        if not bool((node < M).any()):
            break
    return t_best, best_p, steps


def bvh_closest_hit(scene, meta, tabs: BvhTables, o, d, time, t_min,
                    u_med):
    """Stackless traversal -> HitRecord, the record semantics of
    `hit.closest_hit`.  Counts its calls and traversal steps in
    ``bvh_closest_hit.calls`` / ``.steps``."""
    S = scene.sph_c0.shape[0]
    t_best, best_p, steps = traverse(tabs, S, o, d, time, t_min)
    bvh_closest_hit.calls += 1
    bvh_closest_hit.steps += steps
    return hit_ops.record_from_geo_winner(
        scene, meta, tabs.der, o, d, time, t_min, u_med,
        torch.where(best_p >= 0, t_best, BIG), best_p)


bvh_closest_hit.calls = 0
bvh_closest_hit.steps = 0


def bvh_hit_fn(scene, meta, bvh: BvhArrays):
    """``hit_fn(o, d, time, t_min, u_med) -> HitRecord`` over the BVH of a
    tensor scene, its tables packed once."""
    tabs = pack_tables(scene, bvh)

    def hit_fn(o, d, time, t_min, u_med):
        return bvh_closest_hit(scene, meta, tabs, o, d, time, t_min, u_med)

    return hit_fn


def trace_bvh(scene, meta, bvh: BvhArrays, o, d, time, pix_ctr, sample, *,
              max_bounces: int, t_min: float, differentiable: bool = False):
    """BVH-accelerated `integrator.trace` (the same bounce loop)."""
    return trace(scene, meta, o, d, time, pix_ctr, sample,
                 max_bounces=max_bounces, t_min=t_min,
                 differentiable=differentiable,
                 hit_fn=bvh_hit_fn(scene, meta, bvh))
