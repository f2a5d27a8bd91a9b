"""K1's share of its roofline over the traced window (%): the bound of the
window's frames (`roofline.k1`: lane-bounces by the reference's path
counter, each costing the box and sphere tests of the reference's BVH
walk on those paths) over K1's device time in the profiler's trace."""

from rtbench.roofline import k1

KERNEL = "mega2_render_kernel"


def read(win):
    t = win.seconds(KERNEL)
    c = win.counts
    if t <= 0.0 or not c.get("frames"):
        return None
    b, _ = k1.bound(c["spheres"], c["ref_bvh_nodes"], c["pixels"],
                    c["lane_bounces_per_frame"],
                    c["ref_box_tests_per_lane_bounce"],
                    c["ref_sphere_tests_per_lane_bounce"])
    return 100.0 * c["frames"] * b / t
