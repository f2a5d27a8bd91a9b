"""K1, the render kernel: its FP32 operations and bytes for one launch,
held to the work of the reference's own algorithm on the reference's own
paths, whatever K1 itself runs (every sphere row, or a tree).

The reference CUDA repository walks a BVH (``BvhNode.h:50-158``, built
and walked by `rtbench/reference/bvh.py`), so a lane-bounce costs the box
tests and sphere tests that walk makes on the traced paths
(``ref_box_tests_per_lane_bounce``, ``ref_sphere_tests_per_lane_bounce``,
counted by `drivers/render_loop.py`):

- a box test, the slab test of ``AABB.h:68-98``, 28 ops: per axis the
  reciprocal of the direction, two subtracts and two multiplies to the
  slabs, their min and max, and the interval's max and min (9); then the
  final compare;
- a sphere test (moving centre, quadratic, discriminant) 26 ops;
- the rest of the bounce (record, texture, scatter, RNG) 100.

Each add, multiply, compare, min, max, divide or square root is one op.
Bytes: the sphere table and the winner attributes read once (16 + 40 f32
a sphere), each tree node read once (its box and two links, 32 bytes),
each pixel id read and its radiance sum written (4 + 12 bytes).
"""

from __future__ import annotations

from .peaks import bound_s

OPS_NODE, OPS_SPHERE, OPS_BOUNCE = 28, 26, 100
NODE_BYTES = 32


def ops_per_lane_bounce(box_tests: float, sphere_tests: float) -> float:
    return box_tests * OPS_NODE + sphere_tests * OPS_SPHERE + OPS_BOUNCE


def launch_bytes(spheres: int, nodes: int, ids: int) -> int:
    return spheres * (16 + 40) * 4 + nodes * NODE_BYTES + ids * (4 + 12)


def bound(spheres: int, nodes: int, ids: int, lane_bounces: float,
          box_tests: float, sphere_tests: float) -> tuple:
    """(seconds, bound by) of a K1 launch over ``ids`` pixel ids of a
    sphere world whose tree has ``nodes`` nodes, running ``lane_bounces``
    lane-bounces of ``box_tests`` and ``sphere_tests`` each on average."""
    return bound_s(launch_bytes(spheres, nodes, ids),
                   lane_bounces * ops_per_lane_bounce(box_tests,
                                                      sphere_tests))
