"""The frozen roofline functions against hand counts at small shapes."""

import pytest

from rtbench.roofline import k1, peaks


def test_peaks_bound_takes_the_larger_time():
    s, by = peaks.bound_s(3.35e12, 1.0)
    assert s == pytest.approx(1.0) and by == "bytes"
    s, by = peaks.bound_s(1.0, 67e12 * 2)
    assert s == pytest.approx(2.0) and by == "operations"


def test_k1_ops_a_lane_bounce_by_hand():
    # 3 spheres (26 each) + the bounce's own 100
    assert k1.ops_per_lane_bounce(3) == 3 * 26 + 100
    assert k1.ops_per_lane_bounce(2, quads=1, boxes=1, media=1) \
        == 2 * 26 + 16 + 36 + 40 + 100


def test_k1_bound_by_hand():
    # 4 spheres, 10 pixel ids, 1000 lane-bounces
    ops = 1000 * (4 * 26 + 100)
    by = 4 * 56 * 4 + 10 * 16
    s, what = k1.bound(4, 10, 1000)
    assert s == pytest.approx(max(ops / 67e12, by / 3.35e12))
    assert what == "operations"
    assert k1.launch_bytes(4, 10) == by
