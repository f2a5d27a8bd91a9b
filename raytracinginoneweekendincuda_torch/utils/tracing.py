"""The port's spans and counters, recorded only while a ``torch.profiler``
is recording.

``span(name)`` opens a host span ``rt.<name>``; parent and child are given
by nesting on the calling thread, and one ``rt.render`` span is one
frame.  The spans live in the profiler's own memory and are written out
with its trace (``utils/cli.py --profile``, or any caller's
``torch.profiler.profile`` window), on the profiler's clock, which its
device records share.  With no profiler running a span is one attribute
read and a shared no-op context.

A span is a function-scope record (``_RecordFunctionFast``), not a
``record_function`` user annotation: on a CUDA trace kineto gives a user
annotation a device-side shadow over the kernels launched inside it, which
a reader of the device records would take for device work; a
function-scope record casts none.

``count(name, n)`` adds ``n`` to an in-memory counter, again only while a
profiler records, so a profiled window counts its own frames and nothing
else; ``counters()`` gives a copy, ``reset()`` clears them.

Spans on the render path (``ops/render.py``, ``ops/mega2.py``):
``rt.render`` (all of ``render()``), ``rt.pack`` (``pack_mega2_tables``)
and within it ``rt.pack.textures`` (the Perlin and texel tables) and
``rt.pack.upload`` (the tables' host-to-device copies), ``rt.params``
(``frame_params``), ``rt.k1.enqueue`` (``render_mega2``: pixel ids,
queue, launch), ``rt.finalize`` and ``rt.readback`` (the frame's copy to
the host and its flip).  Counters, each added once a pack or a launch:
``upload_bytes`` (the bytes of the packer's table copies),
``texture_bytes`` (of them, the Perlin and texel tables'),
``k1_tree_nodes`` (the sphere tree's nodes), the rows K1 runs outside the
sphere tree on every lane-bounce, padded as it runs them:
``k1_tree_prefix_rows`` (sphere rows before the tree; every sphere row
where there is no tree), ``k1_loose_quad_rows``, ``k1_slab_rows`` (box
slabs) and ``k1_media``; and ``k1_tree_launches`` (K1 launches that
walked the tree, ``render_radiance_cuda``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "rt."

_OFF = contextlib.nullcontext()
_counts: dict = {}


def span(name: str):
    """A context manager: the host span ``rt.<name>`` while a profiler
    records, a no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def count(name: str, n: int) -> None:
    """Adds ``n`` to counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A copy of the counters."""
    return dict(_counts)


def reset() -> None:
    _counts.clear()
