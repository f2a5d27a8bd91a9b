"""K1's share of its roofline on a Book 2 world over the traced window
(%): the bound of the window's frames (`roofline.k1_world`: lane-bounces
by the reference's path counter, each costing the box, sphere, quad and
medium tests and instance entries of the reference's BVH walk over the
world's hittables on those paths) over K1's device time in the
profiler's trace.  None without that count (a sphere world's cell) or
without K1's device records (a run off the card)."""

from rtbench.roofline import k1_world

KERNEL = "mega2_render_kernel"


def read(win):
    t = win.seconds(KERNEL)
    c = win.counts
    if t <= 0.0 or not c.get("frames") \
            or "ref_quad_tests_per_lane_bounce" not in c:
        return None
    tests = {k: c[f"ref_{k}_per_lane_bounce"] for k in k1_world.OPS}
    b, _ = k1_world.bound(c["spheres"], c["quads"], c["media"],
                          c["ref_bvh_nodes"], c["texture_bytes"],
                          c["pixels"], c["lane_bounces_per_frame"], tests)
    return 100.0 * c["frames"] * b / t
