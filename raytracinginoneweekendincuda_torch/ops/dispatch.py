"""Engine dispatch of the chunked renderer: route a ray batch to its
closest-hit engine.

Port of ``raytracinginoneweekendincuda_tpu/ops/dispatch.py``: the
brute-force engine (`ops/hit.py`) or the flattened-BVH engine
(`ops/bvh_engine.py`).  Both give the same images from the same RNG
streams, up to ulp ties (``tests/test_torch_bvh.py``).
"""

from __future__ import annotations

from .integrator import trace


def trace_dispatch(scene, meta, o, d, time, pix_ctr, sample, *,
                   engine: str = "bruteforce", max_bounces: int,
                   t_min: float, differentiable: bool = False, bvh=None):
    if engine == "bvh":
        from .bvh_engine import trace_bvh

        if bvh is None:
            raise ValueError("engine='bvh' needs BVH arrays (scene/bvh.py)")
        return trace_bvh(scene, meta, bvh, o, d, time, pix_ctr, sample,
                         max_bounces=max_bounces, t_min=t_min,
                         differentiable=differentiable)
    if engine != "bruteforce":
        raise ValueError(f"unknown engine {engine!r}")
    return trace(scene, meta, o, d, time, pix_ctr, sample,
                 max_bounces=max_bounces, t_min=t_min,
                 differentiable=differentiable)
