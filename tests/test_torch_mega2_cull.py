"""PyTorch port: the chunk cull of the mega2 closest hit (the JAX kernel's
``chunk_visible`` gating of 64-row chunks) in the plain version, on the CPU.

The skip is conservative for every hit that f32 arithmetic places inside
its chunk's box, so culling does not change those winners: renders and
tapes with the cull forced on, or forced off, are array-equal to the
default ones.  A hit that the f32 sphere test reports on a sphere its ray
misses in exact arithmetic can lie outside the box; the port's cull,
which gates each ray by its own test, skips it, and so does the JAX
kernel's for a ray alone in its tile (the last test; in a full tile JAX
runs the chunk if any ray of the tile may meet its box).  The
3,200-sphere world, the smallest ``sphere_field`` that engages the cull
by the JAX package's rule (51 chunks), is also held against the JAX
package's ``mega2`` engine with its cull engaged, within scene 0's bounds
scaled to its 32 pixels (``tests/torch_render_cases.py``: a lens camera
and small moving spheres, as scene 0).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_render_cases as cases
from raytracinginoneweekendincuda_torch.core.camera import Camera
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops.render import render
from raytracinginoneweekendincuda_torch.scene import api
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from torch_field_scene import (
    ROUNDING_RAY, ROUNDING_SPHERE, compiled_fields, jax_rounding_winner,
    rounding_world,
)
from torch_threads import one_torch_thread  # noqa: F401

FORCED = dict(dense_max=0, cull_min_chunks=0)   # cull every chunk
OFF = dict(cull_min_chunks=10 ** 9)             # cull no chunk
FIELD = (3200, 8, 4, 1, 4)    # spheres, width, height, spp, max_bounces


def _sums(scene, meta, cfg, **pack):
    tab = mega2.pack_mega2_tables(scene, meta, "cpu", **pack)
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int32)
    return tab, mega2.render_radiance_plain(tab, pix,
                                            mega2.frame_params(scene, cfg))


@pytest.mark.parametrize("sid", (0, 9))
def test_forced_cull_equals_default_render(sid):
    """Scenes 0 and 9 at 16x8@2 with every chunk culled are array-equal to
    the default (unculled) render, as the JAX package's
    ``test_forced_cull_path_bit_identical``."""
    scene, meta, cfg = cases.small_case(sid)
    tab, want = _sums(scene, meta, cfg)
    forced, got = _sums(scene, meta, cfg, **FORCED)
    assert not (tab.cull_pairs or tab.cull_boxes)
    assert forced.cull_pairs and forced.cull_boxes == (sid == 9)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.fixture(scope="module")
def field():
    n, w, h, spp, mb = FIELD
    js, jm, ts, tm = compiled_fields(n, w, h)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_bounces=mb, engine="mega2")
    return js, jm, ts, tm, cfg


def test_culled_world_matches_jax_mega2(field):
    """``render()`` on the CPU (cull engaged) against JAX ``mega2`` (cull
    engaged, Pallas interpret mode)."""
    js, jm, ts, tm, cfg = field
    assert mega2.pack_mega2_tables(ts, tm, "cpu").cull_pairs
    ref = np.asarray(jrender(js, jm, JConfig(
        width=cfg.width, height=cfg.height,
        samples_per_pixel=cfg.samples_per_pixel,
        max_bounces=cfg.max_bounces, engine="mega2")))
    cases.check_bounds(0, render(ts, tm, cfg, device="cpu"), ref)


def test_culled_world_equals_unculled(field):
    """The cull engaged and forced off give array-equal sums; the cull
    lets through a small share of the (ray, chunk) pairs."""
    _, _, ts, tm, cfg = field
    tab = mega2.pack_mega2_tables(ts, tm, "cpu")
    stats = mega2.cull_stats()
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int32)
    got = mega2.render_radiance_plain(tab, pix,
                                      mega2.frame_params(ts, cfg),
                                      stats=stats)
    off, want = _sums(ts, tm, cfg, **OFF)
    assert tab.cull_pairs and not off.cull_pairs
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    n_chunks = tab.s_pad // mega2.CULL_C
    assert stats["tests"] == stats["bounces"] * n_chunks
    assert 0 < stats["chunks"] < 0.5 * stats["tests"]
    assert stats["sphere_rows"] == mega2.CULL_C * stats["chunks"]


def test_culled_world_tapes_equal_unculled(field):
    """``trace_tapes_plain`` records the same winners with the cull and
    without it."""
    _, _, ts, tm, cfg = field
    fp = mega2.frame_params(ts, cfg)
    pix, samp = mega2.tape_lanes(
        torch.arange(cfg.width * cfg.height, dtype=torch.int32), 2)
    tapes = [mega2.trace_tapes_plain(
        mega2.pack_mega2_tables(ts, tm, "cpu", **pack), pix, samp, fp)
        for pack in ({}, OFF)]
    assert (tapes[0][0] >= 0).any()
    np.testing.assert_array_equal(tapes[0].numpy(), tapes[1].numpy())


def test_cull_skips_a_rounding_hit_as_jax_does():
    """A ray from 1,700 units away whose f32 sphere test reports a hit on a
    sphere it misses in f64 (``torch_field_scene.ROUNDING_RAY``): without
    the cull that sphere wins, with every chunk culled the ground does, in
    the port's plain version and in the JAX package's mega2 trace kernel
    alike when the ray is the only live one of its tile (JAX's forced cull
    in a fresh process: its thresholds are read at import)."""
    o, d = ROUNDING_RAY[0:3].astype(np.float64), \
        ROUNDING_RAY[3:6].astype(np.float64)
    oc = o - np.asarray(ROUNDING_SPHERE)
    assert np.sqrt(oc @ oc - (oc @ d) ** 2 / (d @ d)) > 0.2    # a miss
    scene, meta = compile_scene(rounding_world(api, Camera), 8, 4,
                                dtype=np.float32)
    fp = mega2.frame_params(scene, RenderConfig(
        width=8, height=4, samples_per_pixel=1, max_bounces=1))
    zero = torch.zeros(1, dtype=torch.int32)
    ray = torch.as_tensor(ROUNDING_RAY[None, :])
    port = []
    for pack in ({}, FORCED):
        tab = mega2.pack_mega2_tables(scene, meta, "cpu", **pack)
        row = mega2.trace_tapes_plain(tab, zero, zero, fp, ray)[0, 0]
        port.append(int(tab.remap[row]))
    assert port == [64, 0]           # the rounding hit, then the ground
    code = ("import jax; jax.config.update('jax_platforms', 'cpu')\n"
            f"import sys; sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
            "import torch_field_scene as f\n"
            "print('winner', f.jax_rounding_winner())\n")
    env = dict(os.environ, MEGA2_DENSE_MAX="0", MEGA2_CULL_MIN_CHUNKS="0")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert "winner 0" in r.stdout, r.stderr[-500:]
    assert jax_rounding_winner() == 64
