"""The port's spans and counters (`utils/tracing.py`) on the render path:
recorded inside a profiler window, nested as the frame runs, no user
annotations (which cast device shadows), and nothing recorded or changed
without a profiler.  CPU, plain versions, 32x18 at 1 spp."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops import render as port_render
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils import cli, tracing
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401

W, H = 32, 18
# each span and the span it lies in
PARENT = {"rt.render": None, "rt.pack": "rt.render",
          "rt.pack.upload": "rt.pack", "rt.params": "rt.render",
          "rt.k1.enqueue": "rt.render", "rt.finalize": "rt.render",
          "rt.readback": "rt.render"}


def _scene(w=W, h=H):
    return compile_scene(scenes.build_scene(0), w, h, dtype=np.float32)


def _spans(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)]


@pytest.fixture(scope="module")
def frames():
    """One frame profiled, one not; the counters of the profiled one."""
    scene, meta = _scene()
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=1,
                       engine="mega2")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = port_render.render(scene, meta, cfg, device="cpu",
                                    out_u8=True)
    counted = tracing.counters()
    tracing.reset()
    plain = port_render.render(scene, meta, cfg, device="cpu", out_u8=True)
    return dict(scene=scene, meta=meta, traced=traced, plain=plain,
                spans=_spans(prof), counted=counted,
                after=tracing.counters())


def test_each_span_once_nested_and_no_user_annotation(frames):
    ev = {e.name(): e for e in frames["spans"]}
    assert sorted(e.name() for e in frames["spans"]) == sorted(PARENT)
    for name, parent in PARENT.items():
        assert not ev[name].is_user_annotation(), name
        if parent is None:
            continue
        s, p = ev[name], ev[parent]
        assert p.start_ns() <= s.start_ns(), name
        assert s.start_ns() + s.duration_ns() \
            <= p.start_ns() + p.duration_ns(), name
    order = ["rt.pack", "rt.params", "rt.k1.enqueue", "rt.finalize",
             "rt.readback"]
    for a, b in zip(order, order[1:]):
        assert ev[a].start_ns() + ev[a].duration_ns() <= ev[b].start_ns()


def test_upload_bytes_are_the_tables_bytes(frames):
    """The packer's counters: the bytes of its tables (the sphere tree's
    among them) and the tree's nodes."""
    tab = mega2.pack_mega2_tables(frames["scene"], frames["meta"], "cpu")
    nbytes = sum(t.nbytes for t in tab if isinstance(t, torch.Tensor))
    assert tab.tree_n > 0
    assert frames["counted"] == {"upload_bytes": nbytes,
                                 "k1_tree_nodes": 2 * tab.tree_n - 1}


def test_without_a_profiler_nothing_counted_and_the_frame_equal(frames):
    assert frames["after"] == {}
    assert frames["plain"].dtype == np.uint8
    assert frames["plain"].shape == (H, W, 3)
    assert np.array_equal(frames["plain"], frames["traced"])
    assert tracing.span("x") is tracing.span("y")    # the shared no-op
    tracing.count("upload_bytes", 5)
    assert tracing.counters() == {}


@pytest.mark.parametrize("engine", ["bruteforce", "wavefront"])
def test_other_engines_record_one_render_span(engine):
    scene, meta = _scene(8, 4)
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=1,
                       max_bounces=2, engine=engine)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_render.render(scene, meta, cfg, device="cpu", out_u8=True)
    names = [e.name() for e in _spans(prof)]
    assert names.count("rt.render") == 1 and "rt.pack" not in names


def test_wrappers_of_the_module_attributes_still_take_effect(monkeypatch):
    """`render()` looks up the packer, K1's launch and `finalize` at call
    time, so a caller that wraps those attributes sees every call."""
    calls = []

    def wrap(module, attr):
        real = getattr(module, attr)

        def call(*a, **kw):
            calls.append(attr)
            return real(*a, **kw)
        monkeypatch.setattr(module, attr, call)
    wrap(mega2, "pack_mega2_tables")
    wrap(mega2, "render_mega2")
    wrap(port_render, "finalize")
    scene, meta = _scene(8, 4)
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=1,
                       max_bounces=2, engine="mega2")
    port_render.render(scene, meta, cfg, device="cpu", out_u8=True)
    assert calls == ["pack_mega2_tables", "render_mega2", "finalize"]


def test_cli_profile_prints_the_counters(tmp_path, capsys):
    assert cli.main(["--scene", "0", "--width", "8", "--height", "4",
                     "--spp", "1", "--max-bounces", "2", "--device", "cpu",
                     "--profile", str(tmp_path / "trace"),
                     "--out", str(tmp_path / "p.ppm")]) == 0
    err = capsys.readouterr().err
    line = [x for x in err.splitlines() if x.startswith("counters: ")]
    assert len(line) == 1 and "'upload_bytes': " in line[0]
    assert '"rt.render"' in (tmp_path / "trace" /
                             "render.trace.json").read_text()
