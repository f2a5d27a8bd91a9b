"""The measured window's arithmetic, on host-clock times in seconds.

A closed loop runs items (frames, steps) back to back from the window's
start ``t0``; the window closes at the end of the first item that ends at
or after ``t0 + seconds``, so no item is cut in half, and every item
completed up to then counts.
"""

from __future__ import annotations

import math


def closes(t0: float, seconds: float, end: float) -> bool:
    """Does an item ending at ``end`` close the window?"""
    return end - t0 >= seconds


def rate(units: list, ends: list, t0: float) -> float:
    """Units completed per second: the units of every item, over the time
    from the window's start to the end of the last item."""
    if not ends:
        raise ValueError("no item completed in the window")
    return sum(units) / (ends[-1] - t0)


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)), 1) - 1]


def per_item(ends: list, t0: float) -> float:
    """The window's length divided by the items completed in it."""
    if not ends:
        raise ValueError("no item completed in the window")
    return (ends[-1] - t0) / len(ends)
