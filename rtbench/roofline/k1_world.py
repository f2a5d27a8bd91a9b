"""K1 on a Book 2 world: its FP32 operations and bytes for one launch,
held to the work of the reference's own BVH on the reference's own paths
(`reference/book2/bvh.py`), as `k1.py` holds K1 on a sphere world,
whatever K1 itself runs (a sphere tree beside every quad, box and medium
row).

A lane-bounce costs the tests of that walk, counted a lane-bounce by
`drivers/render_loop_book2.py`:

- a box test, the slab test of ``AABB.h:68-98``: 28 ops (`k1.OPS_NODE`);
- a sphere test: 26 (`k1.OPS_SPHERE`);
- a quad test, ``Quad.h:52-83``: 57 ops -- the plane's denominator, a
  dot product (5), its magnitude against 1e-8 (2), t = (D - n . O) /
  denominator (7), t in the interval (2), the hit point O + t D (6), its
  offset from Q (3), alpha and beta each a cross product and a dot
  product with w (14 + 14), the four interior compares (4);
- a medium test, ``ConstantMedium.h:52-94``: 76 ops -- the boundary hit
  twice (26, then 1 + 26 from t1 + 1e-4), four interval clamps and
  compares (4), the ray's length (6), the distance inside (2), the
  sampled distance -log(u) / density (2, the log counted as one op),
  its compare (1), t (2) and the point (6);
- an instance entry, ``Instance.h:41-56, 116-150``: 30 ops -- the
  origin moved by the offset and back (3 + 3), the origin and direction
  turned into the object's frame (6 + 6), the point and normal turned
  back (6 + 6);
- the rest of the bounce (record, texture, scatter, RNG): 100
  (`k1.OPS_BOUNCE`; a Perlin or image texture costs more, so the bound
  reads low there, never high).

Each add, multiply, compare, min, max, divide, square root or log is one
op.  Bytes, each read once: a sphere's and a quad's row and winner
attributes (16 + 40 f32, as `k1.py`), a medium's row (22 f32), a node
(32), the texture tables (the image's texels, 3 bytes each; 256 x (3
permutations + 3 gradient components) x 4 bytes a noise table), and each
pixel id read and its radiance sum written (4 + 12).
"""

from __future__ import annotations

from . import k1
from .peaks import bound_s

OPS = {"box_tests": k1.OPS_NODE, "sphere_tests": k1.OPS_SPHERE,
       "quad_tests": 57, "medium_tests": 76, "instance_entries": 30}


def ops_per_lane_bounce(tests: dict) -> float:
    """The ops of a lane-bounce that makes ``tests[k]`` of each `OPS` key
    on average."""
    return sum(tests[k] * v for k, v in OPS.items()) + k1.OPS_BOUNCE


def launch_bytes(spheres: int, quads: int, media: int, nodes: int,
                 texture_bytes: int, ids: int) -> int:
    return ((spheres + quads) * (16 + 40) * 4 + media * 22 * 4
            + nodes * k1.NODE_BYTES + texture_bytes + ids * (4 + 12))


def bound(spheres: int, quads: int, media: int, nodes: int,
          texture_bytes: int, ids: int, lane_bounces: float,
          tests: dict) -> tuple:
    """(seconds, bound by) of a K1 launch over ``ids`` pixel ids of a
    world whose reference tree has ``nodes`` nodes, running
    ``lane_bounces`` lane-bounces of ``tests`` each on average."""
    return bound_s(launch_bytes(spheres, quads, media, nodes, texture_bytes,
                                ids),
                   lane_bounces * ops_per_lane_bounce(tests))
