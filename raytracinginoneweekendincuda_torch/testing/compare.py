"""Image comparison helpers for engine-vs-oracle parity (the port's own
copy of ``raytracinginoneweekendincuda_tpu/testing/compare.py``).

Path tracing is chaotic at discrete boundaries: a root-validity or
Schlick-lottery flip from last-ulp arithmetic differences sends that one
sample down a completely different path.  Aggregate metrics therefore pair a
tight bound on the *bulk* of pixels with a loose bound on the worst case.
"""

from __future__ import annotations

import numpy as np


def assert_images_close(
    got: np.ndarray,
    want: np.ndarray,
    *,
    bulk_tol: float = 1e-9,
    bulk_frac: float = 0.995,
    max_mean: float = 1e-6,
    max_worst: float = 0.5,
    label: str = "",
):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got - want).max(-1)  # per-pixel max channel diff
    frac_ok = float((diff <= bulk_tol).mean())
    mean = float(diff.mean())
    worst = float(diff.max())
    msg = (
        f"{label}: bulk {frac_ok:.4%} of pixels within {bulk_tol:g} "
        f"(need {bulk_frac:.2%}); mean diff {mean:.3g} (max {max_mean:g}); "
        f"worst {worst:.3g} (max {max_worst:g})"
    )
    assert frac_ok >= bulk_frac and mean <= max_mean and worst <= max_worst, msg
    return frac_ok, mean, worst
