"""The card's idle time in a traced window, split by what the host was
inside: the port's own spans (``rt.*``, `raytracinginoneweekendincuda_torch
/utils/tracing.py`), on the profiler's clock, which the device records
share.

Idle time is the window less the union of the device intervals (as
`Window.busy_s` takes it).  It is intersected interval by interval with
the spans, and each idle instant goes to exactly one part:

- ``pack``: inside ``rt.pack``;
- ``readback``: inside ``rt.readback`` (and not ``rt.pack``);
- ``enqueue``: inside ``rt.render`` but in neither of those;
- ``caller``: in no ``rt.render`` span: the caller's own time between
  frames.

So the four parts sum to ``device_idle_share.render``.
"""

from __future__ import annotations

from rtbench.trace import union

PREFIX = "rt."


def intersect(a: list, b: list) -> list:
    """The intersection of two sorted lists of disjoint (start, end)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(iv: list, t0: float, t1: float) -> list:
    """[t0, t1] less the sorted, disjoint intervals ``iv``."""
    out, cur = [], t0
    for s, e in iv:
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        out.append((cur, t1))
    return out


def length(iv: list) -> float:
    return sum(e - s for s, e in iv)


def spans(win, *names: str) -> list:
    """The union of the window's host spans named ``rt.<name>``."""
    want = {PREFIX + n for n in names}
    return union([(s, e) for n, s, e in win.host if n in want])


def shares(win) -> dict | None:
    """The four parts of the idle share (%), or None where the window has
    no device record or no ``rt.`` span (a program without them)."""
    if not win.device or not any(n.startswith(PREFIX) for n, _, _ in
                                 win.host):
        return None
    T = win.window_s
    idle = complement(union([(s, e) for _, s, e in win.device]), 0.0, T)
    pack = spans(win, "pack")
    read = spans(win, "readback")
    frame = spans(win, "render", "pack", "readback")
    parts = {
        "pack": intersect(idle, pack),
        "readback": intersect(idle, intersect(read, complement(pack, 0.0,
                                                               T))),
        "enqueue": intersect(idle, intersect(
            frame, complement(spans(win, "pack", "readback"), 0.0, T))),
        "caller": intersect(idle, complement(frame, 0.0, T)),
    }
    return {k: 100.0 * length(v) / T for k, v in parts.items()}
