"""Render configuration.

The reference has no runtime configuration at all — resolution, scene id,
samples, block size and bounce cap are compile-time constants in ``main()``
(`kernel.cu:572-593`) and switching scenes means editing + rebuilding.  For
a framework, configuration is product surface, so it is a first-class
dataclass here (consumed by the engine, the CLI, and the benchmarks).

The port's own copy of ``raytracinginoneweekendincuda_tpu/utils/config.py`` (same
arithmetic; only the package it lives in differs).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1440                # kernel.cu:572
    height: int = 720                # kernel.cu:573
    samples_per_pixel: int = 10      # kernel.cu:593 (per-scene in the CLI)
    max_bounces: int = 50            # kernel.cu:71
    seed: int = 1984                 # kernel.cu:105,118
    t_min: float = 1.0e-3            # shadow-acne epsilon, kernel.cu:74
    # --- engine knobs (no reference equivalent; TPU scheduling surface) ---
    rays_per_batch: int = 1 << 17    # pixel chunk (chunked) / pool size (wavefront)
    engine: str = "bruteforce"       # bruteforce | bvh | wavefront |
                                     # wavefront_bvh | wavefront_pallas |
                                     # mega | mega2 (the TPU fast path)
    differentiable: bool = False     # scan-based bounce loop (reverse-mode safe)
    dtype: str = "float32"           # engine dtype ("float64" for oracle parity)

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)

    @property
    def aspect(self) -> float:
        return float(self.width) / float(self.height)


def reference_samples_for_scene(scene_id: int) -> int:
    """The reference's per-scene spp choice (kernel.cu:593)."""
    if scene_id == 9:
        return 100
    if 5 <= scene_id <= 8:
        return 200
    return 10
