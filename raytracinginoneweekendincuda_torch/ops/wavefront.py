"""Persistent-wavefront render engine (engines ``wavefront``,
``wavefront_bvh`` and ``wavefront_pallas``).

Port of ``raytracinginoneweekendincuda_tpu/ops/wavefront.py``.  A fixed
pool of rays advances one bounce per iteration; every iteration

  1. scatters the finished lanes' radiance into the framebuffer
     (``index_add_``),
  2. refills finished lanes in place with the next (pixel, sample) work
     items (work item k -> pixel k % npix, sample k // npix; camera rays
     come from the counter RNG, so there is no state to carry),
  3. advances the whole pool one `bounce_step`, with the brute-force hit
     (``wavefront``), the threaded-BVH hit (``wavefront_bvh``,
     `ops/bvh_engine.py`) or kernel K6 (``wavefront_pallas``).

Every radiance sample uses the chunked engine's RNG counters, so the two
agree up to the order of the framebuffer sums.  The loop condition costs
one host sync per iteration.  All samples render in one frame loop (the
JAX package splits them into batches to keep TPU executions short).
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.compiler import cached_pack
from . import hit as hit_ops
from .integrator import bounce_step
from .mega import refill_lanes
from .raygen import generate_rays


def render_wavefront_frame(scene, meta, hit_fn, *, width: int, height: int,
                           spp: int, seed: int, max_bounces: int,
                           t_min: float, pool: int,
                           npix_local: int | None = None, pix_base: int = 0,
                           samp_base: int = 0) -> torch.Tensor:
    """Radiance SUM over samples [samp_base, samp_base + spp) -> [npix, 3]
    in the scene's dtype, for a tensor scene (`hit.scene_tensors`) and its
    closest-hit function ``hit_fn(o, d, time, t_min, u_med) ->
    HitRecord``.  ``npix`` is W*H, or ``npix_local``: a contiguous window
    of the frame (a sharded render, `parallel/render.py`), whose local
    pixel k is global pixel ``pix_base + k`` in the RNG counters and the
    camera rays (JAX ``render_wavefront_frame``'s arguments)."""
    dtype = scene.camera.origin.dtype
    dev = scene.camera.origin.device
    npix = npix_local if npix_local is not None else width * height
    n_work = npix * spp
    P = -(-min(pool, n_work) // 512) * 512   # the JAX engine's lane tiling

    z3 = torch.zeros((P, 3), dtype=dtype, device=dev)
    o, d, thr, acc = z3, z3, z3, z3
    time = torch.zeros(P, dtype=dtype, device=dev)
    pix_ctr = torch.zeros(P, dtype=torch.int32, device=dev)
    pix_id = torch.zeros(P, dtype=torch.int64, device=dev)
    samp = torch.zeros(P, dtype=torch.int32, device=dev)
    bounce = torch.zeros(P, dtype=torch.int32, device=dev)
    active = torch.zeros(P, dtype=torch.bool, device=dev)
    done = torch.ones(P, dtype=torch.bool, device=dev)
    next_ray = torch.zeros((), dtype=torch.int64, device=dev)
    fb = torch.zeros((npix, 3), dtype=dtype, device=dev)

    while bool((next_ray < n_work) | active.any()):
        # 1. scatter finished paths into the framebuffer
        emit = active & done
        fb.index_add_(0, pix_id, torch.where(emit[:, None], acc, 0.0))
        # 2. refill finished lanes with fresh work
        take, new_pix, new_samp, next_ray, pix_id = refill_lanes(
            done, next_ray, pix_id, npix=npix, n_work=n_work)
        new_samp = new_samp + samp_base
        no, nd, ntime, npc = generate_rays(scene.camera, new_pix + pix_base,
                                           new_samp, width, height, seed)
        t2 = take[:, None]
        o = torch.where(t2, no, o)
        d = torch.where(t2, nd, d)
        time = torch.where(take, ntime, time)
        thr = torch.where(t2, 1.0, thr)
        acc = torch.where(t2, 0.0, acc)
        pix_ctr = torch.where(take, npc, pix_ctr)
        samp = torch.where(take, new_samp.to(torch.int32), samp)
        bounce = torch.where(take, 0, bounce)
        active = torch.where(done, take, active)
        # 3. advance every live lane one bounce
        o, d, thr, acc, alive = bounce_step(
            scene, meta, hit_fn, o, d, time, thr, acc, active, pix_ctr,
            samp, bounce, t_min=t_min)
        bounce = bounce + 1
        done = ~alive | (bounce >= max_bounces)
    return fb


_BVH_CACHE: dict = {}


def wavefront_hit_fn(scene, meta, engine: str, device):
    """(tensor scene, closest-hit function) of wavefront engine ``engine``
    (``wavefront``, ``wavefront_bvh`` or ``wavefront_pallas``) on
    ``device``.  The host BVH build of ``wavefront_bvh`` is cached per
    scene (`cached_pack`, keyed on every leaf), as the JAX engine's
    ``_accel_for``."""
    st = hit_ops.scene_tensors(scene, device)
    if engine == "wavefront_bvh":
        from ..scene.bvh import build_scene_bvh
        from .bvh_engine import bvh_hit_fn

        bvh = cached_pack(_BVH_CACHE, scene, engine,
                          lambda: build_scene_bvh(scene))
        return st, bvh_hit_fn(st, meta, bvh)
    if engine == "wavefront_pallas":
        from .pallas_hit import make_pallas_hit_fn, pack_geometry

        return st, make_pallas_hit_fn(st, meta,
                                      *pack_geometry(scene, device))
    if engine == "wavefront":
        return st, hit_ops.brute_force_hit_fn(st, meta)
    raise ValueError(f"not a wavefront engine: {engine!r}")


def render_wavefront(scene, meta, cfg, *, device) -> torch.Tensor:
    """Radiance sums [H*W, 3] of the whole frame through the wavefront
    engine ``cfg.engine`` (`wavefront_hit_fn`) on ``device``, in the
    scene's dtype."""
    st, hit_fn = wavefront_hit_fn(scene, meta, cfg.engine, device)
    return render_wavefront_frame(
        st, meta, hit_fn, width=cfg.width, height=cfg.height,
        spp=cfg.samples_per_pixel, seed=cfg.seed,
        max_bounces=cfg.max_bounces, t_min=float(np.asarray(
            cfg.t_min, np.asarray(scene.sph_rad).dtype)),
        pool=cfg.rays_per_batch)
