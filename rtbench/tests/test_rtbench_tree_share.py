"""The reader of K1's sphere-tree counter, ``k1_tree_share``: the share of
the traced window's frames whose K1 launch walked the tree; None where the
port has no tree (the parent of the change that brought it) or off the
card."""

import pytest
from torch.profiler import ProfilerActivity, profile

from rtbench import spec
from rtbench.trace import Window

from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.utils import tracing

CELLS = ("book1_final.final_render", "bouncing_spheres.preview")


def read(win, cell=CELLS[1]):
    return spec.metric_reader(spec.load_cell(cell), "k1_tree_share").read(win)


def frames(n, device=True):
    dev = [("mega2_render_kernel", 1.0, 3.0)] if device else []
    return Window(10.0, dev, [("rt.render", 0.5, 4.5)], {"frames": n})


def test_both_cells_list_the_reader():
    for cell in CELLS:
        names = [m["name"] for m in spec.load_cell(cell).per_layer]
        assert "k1_tree_share" in names


@pytest.mark.parametrize("launches,share", [(4, 100.0), (1, 25.0), (0, 0.0)])
def test_the_share_is_the_counted_launches_over_the_frames(launches, share):
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(launches):
                tracing.count("k1_tree_launches", 1)
        for cell in CELLS:
            assert read(frames(4), cell) == pytest.approx(share)
    finally:
        tracing.reset()


def test_none_without_the_tree_or_off_the_card(monkeypatch):
    tracing.reset()
    assert read(frames(2, device=False)) is None
    assert read(frames(0)) is None
    monkeypatch.delattr(mega2.render_radiance_cuda, "tree_launches")
    assert read(frames(2)) is None
