"""One traced window: a ``torch.profiler`` timeline of the device and the
host, reduced to what the per-layer readers take.

Device operations are the profiler's CUDA-side records (kernels, copies,
sets), host events its CPU-side records (aten ops and the spans that
`span` and `wrapped` open, named ``rtbench.*``); both on the profiler's
clock, in seconds from the window's start.  Busy time is the union of
the device intervals.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN = "rtbench."


@dataclass
class Window:
    """A traced window: ``device`` and ``host`` [(name, start, end)] in s
    from its start, its length, and the driver's counts."""
    window_s: float
    device: list
    host: list
    counts: dict = field(default_factory=dict)

    def seconds(self, match=None) -> float:
        """Summed device seconds of the operations whose name contains
        ``match`` (all with None)."""
        return sum(e - s for n, s, e in self.device
                   if match is None or match in n)

    def busy_s(self) -> float:
        return sum(e - s for s, e in union(
            [(s, e) for _, s, e in self.device]))

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest device-idle gaps of the window, each named by
        the host activity open at its middle: the outermost span and the
        innermost event."""
        iv = union([(s, e) for _, s, e in self.device])
        edges = [(0.0, 0.0)] + iv + [(self.window_s, self.window_s)]
        gaps = [(a[1], b[0]) for a, b in zip(edges, edges[1:])
                if b[0] > a[1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:n]:
            mid = 0.5 * (g0 + g1)
            open_ = [(s, e, name) for name, s, e in self.host if s <= mid <= e]
            if open_:
                outer = min(open_)[2]
                inner = max(open_)[2]
                what = outer if outer == inner else f"{outer} > {inner}"
            else:
                what = "no host event"
            out.append([what, g1 - g0])
        return out


def union(intervals: list) -> list:
    """Sorted, merged [(start, end)]."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Tracer:
    """Profiles the block under `window()`; ``result()`` gives the Window.
    With ``enabled=False`` nothing is profiled and ``result()`` is None."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        with self._prof:
            with record_function("rtbench.window"):
                yield

    def result(self, counts: dict) -> Window | None:
        if self._prof is None:
            return None
        evs = self._prof.profiler.kineto_results.events()
        win = [e for e in evs if e.name() == "rtbench.window"]
        if not win:
            raise RuntimeError("the traced window left no record")
        t0 = win[0].start_ns()
        t1 = t0 + win[0].duration_ns()
        dev, host = [], []
        for e in evs:
            s = max(e.start_ns(), t0)
            end = min(e.start_ns() + e.duration_ns(), t1)
            if end <= s or e.name() == "rtbench.window":
                continue
            rec = (e.name(), (s - t0) * 1e-9, (end - t0) * 1e-9)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a span's device-side shadow is no device operation
                if not e.name().startswith(SPAN):
                    dev.append(rec)
            else:
                host.append(rec)
        return Window((t1 - t0) * 1e-9, dev, host, counts)


@contextlib.contextmanager
def span(name: str, on: bool = True):
    """A host span in the traced run (a no-op otherwise)."""
    if not on:
        yield
        return
    with record_function(SPAN + name):
        yield


@contextlib.contextmanager
def wrapped(module, attr: str, name: str, on: bool = True):
    """Within the block, calls of ``module.attr`` run inside a span
    ``name`` (in a traced run; the attribute is restored after)."""
    if not on:
        yield
        return
    orig = getattr(module, attr)

    def call(*a, **kw):
        with record_function(SPAN + name):
            return orig(*a, **kw)
    setattr(module, attr, call)
    try:
        yield
    finally:
        setattr(module, attr, orig)
