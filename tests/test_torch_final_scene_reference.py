"""The port on Book 2's final scene (scene 9) against the benchmark's
plain Book 2 reference (`rtbench/reference/book2/`), on the CPU: the plain
K1 version's radiance sums and u8 frame bit for bit at 20x12@2, depth
50; seeded random rays on a quad, the box slabs, the media, the image
texture and the Perlin texture against the port's plain functions; and
the packer's counters of the rows K1 runs outside its sphere tree and of
the texture tables' bytes."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops.render import finalize
from raytracinginoneweekendincuda_torch.scene.compiler import (
    TEX_IMAGE, compile_scene,
)
from raytracinginoneweekendincuda_torch.utils import tracing
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from rtbench.reference.book2 import tracer
from rtbench.reference.scenes import final_scene
from rtbench.reference.tracer import to_u8
from torch_threads import one_torch_thread  # noqa: F401

W, H, SPP, SEED = 20, 12, 2, 2**32 - 7
T_MIN = float(np.float32(1e-3))


@pytest.fixture(scope="module")
def both():
    """The port's packed tables and the reference's frame, scene 9."""
    sc, meta = compile_scene(scenes.final_scene(), W, H, dtype=np.float32)
    tab = mega2.pack_mega2_tables(sc, meta, "cpu")
    fr = tracer.Frame(final_scene.world(), W, H, 50, "cpu")
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP, seed=SEED)
    return dict(scene=sc, meta=meta, tab=tab, fr=fr,
                fp=mega2.frame_params(sc, cfg))


def test_the_plain_k1_version_equals_the_reference(both):
    pix = torch.arange(W * H, dtype=torch.int32)
    port = mega2.render_radiance_plain(both["tab"], pix, both["fp"])
    ref, bounces = tracer.radiance(both["fr"], pix, [SEED], SPP)
    assert torch.equal(port, ref[0])
    assert torch.equal(finalize(port, SPP, True, True), to_u8(ref[0], SPP))
    assert int(bounces.min()) >= SPP and int(bounces.max()) > 4 * SPP


def _rays(gen, n, lo, hi, target_lo, target_hi):
    """``n`` rays from uniform points of the box [lo, hi] towards uniform
    points of the box [target_lo, target_hi], f32."""
    u = lambda a, b: torch.tensor(a) + torch.rand(n, 3, generator=gen) \
        * (torch.tensor(b) - torch.tensor(a))
    o = u(lo, hi)
    return o, u(target_lo, target_hi) - o


def _start(n):
    return (torch.full((n,), mega2.BIG),
            torch.full((n,), -1, dtype=torch.int64))


def test_a_quad(both):
    """The light, from below and above, rays aimed around its edges."""
    gen = torch.Generator().manual_seed(11)
    o, d = _rays(gen, 4096, (0.0, 100.0, 0.0), (600.0, 1000.0, 500.0),
                 (100.0, 554.0, 120.0), (450.0, 554.0, 440.0))
    tab, rtab = both["tab"], both["fr"].tab
    best, win = mega2._closest_quads(tab, o, d, T_MIN, *_start(4096), 256,
                                     None, None)
    rbest, rwin = tracer.closest_quads(rtab, o, d, T_MIN, *_start(4096))
    assert torch.equal(best, rbest)
    assert torch.equal(win >= 0, rwin >= 0)
    assert 1000 < int((win >= 0).sum()) < 4000


def test_the_box_slabs(both):
    """Rays from above the ground down onto its boxes' tops and sides: the
    same t and the same face's normal.  (Two neighbouring boxes share a
    face's plane, so a ray inside one ties the two where it leaves it, and
    the order of the rows decides; no path starts inside a box.)"""
    gen = torch.Generator().manual_seed(12)
    o, d = _rays(gen, 4096, (-1000.0, 102.0, -1000.0),
                 (1000.0, 400.0, 1000.0), (-1000.0, 0.0, -1000.0),
                 (1000.0, 60.0, 1000.0))
    tab, rtab = both["tab"], both["fr"].tab
    best, win = mega2._closest_boxes(tab, o, d, T_MIN, *_start(4096), 256,
                                     None, None)
    rbest, rwin = tracer.closest_boxes(rtab, o, d, T_MIN, *_start(4096))
    assert torch.equal(best, rbest)
    hit = win >= 0
    assert torch.equal(hit, rwin >= 0) and int(hit.sum()) > 3000
    n = tab.attr[win[hit], 0:3]
    assert torch.equal(n, rtab.pos[rwin[hit]])
    assert int((n[:, 1] == 0.0).sum()) > 300         # sides as well as tops


def test_the_media(both):
    """Rays through the blue ball and the mist, with and without a nearer
    geometry hit: the same sampled t, medium and albedo."""
    gen = torch.Generator().manual_seed(13)
    n = 8192
    o, d = _rays(gen, n, (0.0, 0.0, -600.0), (700.0, 500.0, 600.0),
                 (290.0, 80.0, 75.0), (430.0, 220.0, 215.0))
    pix_ctr = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                            dtype=torch.int32)
    samp = torch.randint(0, 100, (n,), generator=gen, dtype=torch.int32)
    start = torch.where(torch.rand(n, generator=gen) < 0.5, mega2.BIG,
                        torch.rand(n, generator=gen) * 400.0)
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    tab, fr = both["tab"], both["fr"]
    best, win, is_med, alb = mega2._media(
        tab, both["fp"], o, d, a, 1.0 / a, pix_ctr, samp, 3, start.clone(),
        torch.full((n,), -1, dtype=torch.int64))
    rbest, rwin, ris_med, ralb = tracer.media(
        fr.tab, fr, o, d, a, 1.0 / a, pix_ctr, samp, 3, start.clone(),
        torch.full((n,), -1, dtype=torch.int64))
    assert torch.equal(best, rbest) and torch.equal(is_med, ris_med)
    assert torch.equal(alb, ralb)
    assert torch.equal(torch.where(is_med, win - tab.np_rows, -1),
                       torch.where(ris_med, rwin - fr.tab.rows, -1))
    for m in (0, 1):
        assert int((is_med & (win == tab.np_rows + m)).sum()) > 50


def test_the_image_texture(both):
    """The earth's texels at random outward normals."""
    gen = torch.Generator().manual_seed(14)
    tab, rtab = both["tab"], both["fr"].tab
    row = int((tab.attr[:, 13] == float(TEX_IMAGE)).nonzero()[0, 0])
    rrow = int((rtab.tex == tracer.IMAGE).nonzero()[0, 0])
    n = 4096
    ns = torch.randn(n, 3, generator=gen)
    ns = ns / ns.norm(dim=1, keepdim=True)
    aw = tab.attr[row].expand(n, -1)
    got = mega2._image_tex(tab, aw, torch.zeros(n, 3), ns,
                           torch.zeros(n, dtype=torch.bool))
    ref = tracer.image_value(rtab, torch.full((n,), rrow), ns)
    assert torch.equal(got, ref)
    assert int(torch.unique(got, dim=0).shape[0]) > 500


def test_the_perlin_texture(both):
    """The marble's turbulence at random points of the scene (negative
    coordinates among them)."""
    gen = torch.Generator().manual_seed(15)
    p = (torch.rand(4096, 3, generator=gen) - 0.5) * 1200.0
    got = mega2._perlin_turb(both["tab"], 0, p[:, 0], p[:, 1], p[:, 2])
    ref = tracer.perlin_turb(both["fr"].tab.perlin[0], p[:, 0], p[:, 1],
                             p[:, 2])
    assert torch.equal(got, ref)
    assert float(got.std()) > 0.05


def test_the_packer_s_rows_and_texture_counters(both):
    """K1 runs 448 padded box-slab rows, 64 loose-quad rows and 2 media
    outside its sphere tree, and no sphere row before it; the texture
    tables' bytes, in their span inside the pack."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tab = mega2.pack_mega2_tables(both["scene"], both["meta"], "cpu")
    counted = tracing.counters()
    tracing.reset()
    assert tab.tree_n == 1006 and tab.tree_p0 == 0
    assert {k: counted[k] for k in ("k1_slab_rows", "k1_loose_quad_rows",
                                    "k1_media", "k1_tree_prefix_rows")} \
        == {"k1_slab_rows": 448, "k1_loose_quad_rows": 64, "k1_media": 2,
            "k1_tree_prefix_rows": 0}
    assert counted["texture_bytes"] == (tab.perm.nbytes + tab.vec.nbytes
                                        + tab.texels.nbytes)
    assert counted["texture_bytes"] > 512 * 1024 * 4
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("rt.")]
    assert names.count("rt.pack.textures") == 1
