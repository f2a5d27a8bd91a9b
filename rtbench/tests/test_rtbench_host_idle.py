"""The readers of the port's own spans and counter, on hand-built traced
windows: the four idle shares partition ``device_idle_share.render``, an
idle gap is split between spans by length, and a window without the
port's spans gives None."""

import pytest
from torch.profiler import ProfilerActivity, profile

from rtbench import spec
from rtbench.trace import Window

from raytracinginoneweekendincuda_torch.utils import tracing

PARTS = ("pack", "enqueue", "readback", "caller")
NEW = ("frame_pack_ms", "frame_upload_kb",
       *(f"device_idle_share.{p}" for p in PARTS))
CELLS = ("book1_final.final_render", "bouncing_spheres.preview")


def reader(name):
    return spec.metric_reader(spec.load_cell(CELLS[1]), name)


def read(name, win):
    return reader(name).read(win)


def two_frames():
    """10 s; the card busy over [1, 3] and [5, 6]; two frames, each a
    packer span, the second without a readback; the harness's own spans
    beside them."""
    host = [("rtbench.frame", 0.4, 4.6), ("rt.render", 0.5, 4.5),
            ("rt.pack", 0.5, 1.5), ("rt.pack.upload", 1.2, 1.5),
            ("rt.readback", 4.0, 4.5), ("rtbench.frame", 6.4, 9.1),
            ("rt.render", 6.5, 9.0), ("rt.pack", 6.5, 8.0),
            ("aten::empty_strided", 8.5, 8.6)]
    return Window(10.0, [("k", 1.0, 3.0), ("k", 5.0, 6.0)], host,
                  {"frames": 2})


def test_every_cell_lists_and_finds_the_new_readers():
    for cell in CELLS:
        names = [m["name"] for m in spec.load_cell(cell).per_layer]
        assert set(NEW) <= set(names)
    for name in NEW:
        assert callable(reader(name).read)


def test_the_four_idle_shares_partition_the_idle_share():
    win = two_frames()
    got = {p: read(f"device_idle_share.{p}", win) for p in PARTS}
    # idle [0, 1], [3, 5], [6, 10]: pack [0.5, 1] + [6.5, 8]; readback
    # [4, 4.5]; enqueue [3, 4] + [8, 9]; caller [0, 0.5], [4.5, 5],
    # [6, 6.5], [9, 10]
    assert got == pytest.approx({"pack": 20.0, "readback": 5.0,
                                 "enqueue": 20.0, "caller": 25.0})
    assert sum(got.values()) == pytest.approx(
        read("device_idle_share.render", win), abs=1e-9)


def test_a_gap_across_spans_is_split_by_length():
    """One idle gap [2, 5]; its middle (3.5) lies in the enqueue part, but
    each span takes the part of the gap it covers."""
    host = [("rt.render", 1.0, 4.5), ("rt.pack", 1.0, 3.0),
            ("rt.readback", 4.0, 4.5)]
    win = Window(10.0, [("k", 0.0, 2.0), ("k", 5.0, 10.0)], host,
                 {"frames": 1})
    got = {p: read(f"device_idle_share.{p}", win) for p in PARTS}
    assert got == pytest.approx({"pack": 10.0, "enqueue": 10.0,
                                 "readback": 5.0, "caller": 5.0})


def test_frame_pack_ms_sums_the_pack_spans_over_the_frames():
    assert read("frame_pack_ms", two_frames()) == pytest.approx(1250.0)


def test_frame_upload_kb_reads_the_counter_over_the_frames():
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            tracing.count("upload_bytes", 3 * 1024)
        assert read("frame_upload_kb", two_frames()) == pytest.approx(1.5)
    finally:
        tracing.reset()
    assert read("frame_upload_kb", two_frames()) is None


def test_without_the_ports_spans_every_reader_gives_none():
    """The parent's window: the harness's spans and aten ops only; and a
    window off the card, with spans but no device record."""
    parent = Window(10.0, [("k", 1.0, 3.0)],
                    [("rtbench.frame", 0.5, 4.5), ("rtbench.pack", 0.5, 1.5),
                     ("aten::copy_", 4.0, 4.4)], {"frames": 1})
    off_card = Window(10.0, [], two_frames().host, {"frames": 2})
    tracing.reset()
    for name in NEW:
        assert read(name, parent) is None, name
        assert read(name, off_card) is None, name
