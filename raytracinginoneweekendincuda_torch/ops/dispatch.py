"""Engine dispatch of the chunked renderer: route a ray batch to its
closest-hit engine.

Port of ``raytracinginoneweekendincuda_tpu/ops/dispatch.py``.  Only the
brute-force engine is ported; the flattened-BVH engine (``bvh``) is still
to port (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from .integrator import trace


def trace_dispatch(scene, meta, o, d, time, pix_ctr, sample, *,
                   engine: str = "bruteforce", max_bounces: int,
                   t_min: float):
    if engine != "bruteforce":
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet (see ROADMAP.md, queue 1)")
    return trace(scene, meta, o, d, time, pix_ctr, sample,
                 max_bounces=max_bounces, t_min=t_min)
