"""The roofline functions against hand counts at small shapes,
and the reference BVH's work counted by hand on a small world."""

import pytest
import torch

from rtbench import spec
from rtbench.reference import bvh
from rtbench.reference.world import LAMBERTIAN, Camera, Sphere, World, tables
from rtbench.roofline import k1, peaks
from rtbench.trace import Window


def test_peaks_bound_takes_the_larger_time():
    s, by = peaks.bound_s(3.35e12, 1.0)
    assert s == pytest.approx(1.0) and by == "bytes"
    s, by = peaks.bound_s(1.0, 67e12 * 2)
    assert s == pytest.approx(2.0) and by == "operations"


def test_k1_ops_a_lane_bounce_by_hand():
    # 5 box tests (28 each: 3 x 9 + 1) and 1 sphere test (26), + 100
    assert k1.ops_per_lane_bounce(5, 1) == 5 * 28 + 26 + 100
    assert k1.ops_per_lane_bounce(7, 4) == 7 * 28 + 4 * 26 + 100
    assert k1.ops_per_lane_bounce(0.5, 0.25) == pytest.approx(
        14 + 6.5 + 100)


def test_k1_bound_by_hand():
    # 4 spheres, 7 nodes, 10 pixel ids, 1000 lane-bounces of 5 box tests
    # and 1 sphere test
    ops = 1000 * (5 * 28 + 26 + 100)
    by = 4 * 56 * 4 + 7 * 32 + 10 * 16
    s, what = k1.bound(4, 7, 10, 1000, 5, 1)
    assert s == pytest.approx(max(ops / 67e12, by / 3.35e12))
    assert what == "operations"
    assert k1.launch_bytes(4, 7, 10) == by


def in_a_row(n=4):
    """``n`` spheres of radius 1 at x = 0, 3, 6, ... on the x axis.  The
    tree of four, by hand: the root (x from -1 to 10, longest) splits
    {0, 1} | {2, 3}; each half (x from -1 to 4, and 5 to 10) splits into
    its two leaves."""
    sph = [Sphere((3.0 * i, 0.0, 0.0), 1.0, LAMBERTIAN) for i in range(n)]
    return tables(World(sph, Camera()), "cpu")


def test_the_small_world_s_tree_by_hand():
    tree = bvh.build(in_a_row())
    # depth first: root, {0, 1}, 0, 1, {2, 3}, 2, 3
    assert tree.sphere.tolist() == [-1, -1, 0, 1, -1, 2, 3]
    assert tree.left.tolist() == [1, 2, -1, -1, 5, -1, -1]
    assert tree.right.tolist() == [4, 3, -1, -1, 6, -1, -1]
    assert tree.height == 2
    assert tree.lo[0].tolist() == [-1.0, -1.0, -1.0]
    assert tree.hi[1].tolist() == [4.0, 1.0, 1.0]
    # three: n // 2 = 1 to the left
    assert bvh.build(in_a_row(3)).sphere.tolist() == [-1, 0, -1, 1, 2]


@pytest.mark.parametrize("origin,direction,boxes,spheres,win", [
    # from -x: root, {0, 1}, leaf 0 (hit at t 4); leaf 1 (t 7-9) and
    # {2, 3} (t 10-15) lie beyond closest 4: 5 boxes, 1 sphere
    ((-5.0, 0.0, 0.0), (1.0, 0.0, 0.0), 5, 1, 0),
    # from +x the left half is walked first and each leaf is nearer than
    # the last: root, {0, 1}, leaf 0 (t 14), leaf 1 (t 11), {2, 3} (t 5-10),
    # leaf 2 (t 8), leaf 3 (t 5): 7 boxes, 4 spheres
    ((15.0, 0.0, 0.0), (-1.0, 0.0, 0.0), 7, 4, 3),
    # above every box: the root's box alone
    ((-5.0, 5.0, 0.0), (1.0, 0.0, 0.0), 1, 0, -1),
    # down onto sphere 2 (x 6): root, {0, 1} missed, {2, 3}, leaf 2 hit,
    # leaf 3 missed: 5 boxes, 1 sphere
    ((6.0, 5.0, 0.0), (0.0, -1.0, 0.0), 5, 1, 2),
])
def test_the_walk_counts_one_ray_by_hand(origin, direction, boxes, spheres,
                                         win):
    tab = in_a_row()
    o = torch.tensor([origin])
    d = torch.tensor([direction])
    got = bvh.walk(bvh.build(tab), tab, o, d, torch.zeros(1), 1e-3)
    assert [int(x) for x in got] == [boxes, spheres, win]


@pytest.mark.parametrize("size,axis", [
    ((3, 1, 1), 0), ((1, 3, 1), 1), ((1, 1, 3), 2),
    ((2, 2, 1), 1), ((2, 1, 2), 2), ((1, 2, 2), 2), ((2, 2, 2), 2)])
def test_longest_axis_ties_go_to_the_later_axis(size, axis):
    assert bvh.longest_axis(size) == axis


def test_k1_roofline_reads_the_walk_s_counts():
    counts = {"frames": 2, "spheres": 4, "ref_bvh_nodes": 7, "pixels": 10,
              "lane_bounces_per_frame": 67e9,
              "ref_box_tests_per_lane_bounce": 5,
              "ref_sphere_tests_per_lane_bounce": 1}
    # a frame's bound: 67e9 lane-bounces x 266 ops / 67e12 = 0.266 s; K1
    # takes 5.32 s for the two frames: 10%
    win = Window(6.0, [("mega2_render_kernel", 0.0, 5.32),
                       ("copy", 5.4, 5.5)], [], counts)
    cell = spec.load_cell("book1_final.final_render")
    read = spec.metric_reader(cell, "k1_roofline").read
    assert read(win) == pytest.approx(10.0)
    assert read(Window(6.0, [], [], counts)) is None
