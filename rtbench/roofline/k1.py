"""K1, the render kernel: its FP32 operations and bytes for one launch.

Every lane-bounce tests every row of the world (no cull below 1,536
rows): a sphere row (moving centre, quadratic, discriminant) 26 ops, a
loose quad row 16, a box slab row 36, a medium 40, and the rest of the
bounce (record, texture, scatter, RNG) 100; each add, multiply, compare,
divide or square root one op.  Bytes: the sphere table and the winner
attributes read once (16 + 40 f32 a sphere row), each pixel id read and
its radiance sum written (4 + 12 bytes).
"""

from __future__ import annotations

from .peaks import bound_s

OPS_SPHERE, OPS_QUAD, OPS_BOX, OPS_MEDIUM, OPS_BOUNCE = 26, 16, 36, 40, 100


def ops_per_lane_bounce(spheres: int, quads: int = 0, boxes: int = 0,
                        media: int = 0) -> int:
    return (spheres * OPS_SPHERE + quads * OPS_QUAD + boxes * OPS_BOX
            + media * OPS_MEDIUM + OPS_BOUNCE)


def launch_bytes(spheres: int, ids: int) -> int:
    return spheres * (16 + 40) * 4 + ids * (4 + 12)


def bound(spheres: int, ids: int, lane_bounces: float) -> tuple:
    """(seconds, bound by) of a K1 launch over ``ids`` pixel ids of a
    sphere world that runs ``lane_bounces`` lane-bounces."""
    return bound_s(launch_bytes(spheres, ids),
                   lane_bounces * ops_per_lane_bounce(spheres))
