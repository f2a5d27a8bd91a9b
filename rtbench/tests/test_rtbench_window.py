"""The window's arithmetic (`rtbench.window`)."""

import pytest

from rtbench import window


def test_rate_counts_every_completed_frame_up_to_the_last_end():
    t0 = 100.0
    ends = [100.5, 101.0, 102.5]
    assert window.rate([10, 10, 10], ends, t0) == pytest.approx(30 / 2.5)


def test_window_closes_at_the_end_of_the_frame_that_crosses():
    t0 = 0.0
    assert not window.closes(t0, 2.0, 1.99)
    assert window.closes(t0, 2.0, 2.0)
    assert window.closes(t0, 2.0, 3.7)


def test_p95_is_over_all_frames_nearest_rank():
    vals = list(range(1, 101))            # 1 .. 100
    assert window.percentile(vals, 95.0) == 95
    assert window.percentile([3.0], 95.0) == 3.0
    assert window.percentile([5, 1, 4, 2, 3], 95.0) == 5
    assert window.percentile(list(range(1, 21)), 95.0) == 19


def test_steps_over_the_window():
    assert window.per_item([1.0, 2.0, 3.0, 4.0], 0.0) == pytest.approx(1.0)
    assert window.per_item([0.5, 2.5], 0.5) == pytest.approx(1.0)


def test_an_empty_window_raises():
    with pytest.raises(ValueError):
        window.rate([], [], 0.0)
    with pytest.raises(ValueError):
        window.percentile([], 95.0)
