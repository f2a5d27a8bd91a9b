"""The path integrator: iterative bounce loop with throughput and emission
accumulators -- the batched ``RayColor`` (kernel.cu:65-98).

Port of ``raytracinginoneweekendincuda_tpu/ops/integrator.py``:
  * at most ``max_bounces`` bounces, t_min the shadow epsilon (kernel.cu:71,74)
  * miss  -> accumulated += throughput * background, terminate (74-79)
  * hit   -> accumulated += throughput * emitted (82-83)
  * no scatter (light / absorbed metal) -> terminate (87-91)
  * else    throughput *= attenuation; ray = scattered (93-94)

Two loop forms over the same body:
  * the ``while`` form, the inference path: the loop ends early once no
    lane is alive (one host sync per bounce);
  * the scan form (``differentiable=True``), the reverse-differentiable
    path: every one of ``max_bounces`` bounces runs, no host sync, each
    under ``torch.utils.checkpoint`` (JAX's ``lax.scan`` over
    ``jax.checkpoint``), so the backward keeps one bounce's activations
    at a time and recomputes them.  The counter RNG makes the recompute
    draw what the forward drew.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng
from . import hit as hit_ops
from .shade import shade


def _stream(base: int, bounce):
    """``base | bounce`` as int32 words (bounce an int or an int tensor)."""
    if isinstance(bounce, torch.Tensor):
        return rng.to_word(base) | bounce.to(torch.int32)
    return rng.to_word(base | int(bounce))


def _u_med(meta, pix_ctr, samp, bounce, dtype):
    """Per-(ray, medium) uniforms [B, max(M, 1)] in (0, 1] of a bounce
    (MEDIUM_STREAM | bounce): the draw of `bounce_step`, shared with the
    taped replay (`ops/replay.py`)."""
    n_media = max(meta.n_media, 1)
    med_slots = torch.arange(n_media, dtype=torch.int32,
                             device=pix_ctr.device)[None, :]
    samp_c = samp[:, None] if isinstance(samp, torch.Tensor) else samp
    stream = _stream(rng.MEDIUM_STREAM, bounce)
    stream_c = stream[:, None] if isinstance(stream, torch.Tensor) else stream
    return rng.uniform_open4(pix_ctr[:, None], samp_c, stream_c, med_slots,
                             dtype)[0]


def bounce_step(scene, meta, hit_fn, o, d, time, thr, acc, alive, pix_ctr,
                samp, bounce, *, t_min: float):
    """One hit + shade bounce over a ray batch (the loop body of RayColor,
    kernel.cu:71-95).  ``samp`` and ``bounce`` are ints or per-lane int
    tensors (the wavefront pool mixes samples and depths; the RNG counters
    keep every draw identical to the chunked schedule)."""
    u_med = _u_med(meta, pix_ctr, samp, bounce, o.dtype)
    rec = hit_fn(o, d, time, t_min, u_med)
    return advance_from_record(scene, meta, rec, o, d, thr, acc, alive,
                               pix_ctr, samp, bounce)


def advance_from_record(scene, meta, rec, o, d, thr, acc, alive, pix_ctr,
                        samp, bounce):
    """The miss / emit / scatter / advance tail of `bounce_step`
    (kernel.cu:74-95) for an already-built HitRecord."""
    background = scene.camera.background
    miss = alive & ~rec.hit
    acc = acc + torch.where(miss[:, None], thr * background, 0.0)
    alive = alive & rec.hit

    u1, u2, u3, u4 = rng.uniform4(pix_ctr, samp,
                                  _stream(rng.SCATTER_STREAM, bounce), 0,
                                  o.dtype)
    sc = shade(scene, meta, rec, d, u1, u2, u3, u4)

    acc = acc + torch.where(alive[:, None], thr * sc.emitted, 0.0)
    alive = alive & sc.scattered
    thr = torch.where(alive[:, None], thr * sc.attenuation, thr)
    o = torch.where(alive[:, None], rec.p, o)
    d = torch.where(alive[:, None], sc.direction, d)
    return o, d, thr, acc, alive


def trace(scene, meta, o, d, time, pix_ctr, sample, *, max_bounces: int,
          t_min: float, differentiable: bool = False, hit_fn=None):
    """Radiance [B, 3] for a batch of primary rays of one sample.

    ``hit_fn(o, d, time, t_min, u_med) -> HitRecord`` swaps the
    closest-hit engine (default: `hit.brute_force_hit_fn`, the brute-force
    closest hit over the whole scene); ``differentiable`` selects the scan
    form (module notes)."""
    if hit_fn is None:
        hit_fn = hit_ops.brute_force_hit_fn(scene, meta)
    B = o.shape[0]
    thr = torch.ones((B, 3), dtype=o.dtype, device=o.device)
    acc = torch.zeros((B, 3), dtype=o.dtype, device=o.device)
    alive = torch.ones(B, dtype=torch.bool, device=o.device)
    if differentiable:
        def body(bounce, o, d, thr, acc, alive):
            return bounce_step(scene, meta, hit_fn, o, d, time, thr, acc,
                               alive, pix_ctr, sample, bounce, t_min=t_min)

        for bounce in range(max_bounces):
            # non-reentrant: the gradients of the tensors the bounce only
            # closes over (the scene leaves, hit_fn's derived tables)
            # arrive; the bounce draws from no torch generator
            o, d, thr, acc, alive = checkpoint(
                body, bounce, o, d, thr, acc, alive, use_reentrant=False,
                preserve_rng_state=False)
        return acc
    for bounce in range(max_bounces):
        if not bool(alive.any()):
            break
        o, d, thr, acc, alive = bounce_step(
            scene, meta, hit_fn, o, d, time, thr, acc, alive, pix_ctr,
            sample, bounce, t_min=t_min)
    return acc
