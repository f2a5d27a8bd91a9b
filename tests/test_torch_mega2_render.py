"""PyTorch port: the plain mega2 render against the JAX package, part 1 --
scenes whose pixels are bit-comparable (spheres, quads, boxes, media).
Bounds and reasons: ``tests/torch_render_cases.py``."""

import numpy as np
import pytest
import torch

import torch_render_cases as cases
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

SCENES = (0, 1, 4, 6, 7, 8)


def jax_reference(sid: int) -> np.ndarray:
    """The JAX package's frame at `cases.small_case`'s config: ``mega2``,
    or ``bruteforce`` for scene 9 (same golden hash, ~100x faster in
    interpret mode)."""
    _, _, cfg = cases.small_case(sid)
    scene, meta = jcompile(jscenes.build_scene(sid), cfg.width, cfg.height,
                           dtype=np.float32)
    jcfg = JConfig(width=cfg.width, height=cfg.height,
                   samples_per_pixel=cfg.samples_per_pixel,
                   rays_per_batch=cfg.rays_per_batch,
                   engine="bruteforce" if sid == 9 else "mega2")
    return np.asarray(jrender(scene, meta, jcfg))


@pytest.fixture(scope="module")
def jax_ref():
    cache = {}

    def get(sid):
        if sid not in cache:
            cache[sid] = jax_reference(sid)
        return cache[sid]
    return get


@pytest.mark.parametrize("sid", SCENES)
def test_plain_render_matches_jax_mega2(sid, jax_ref):
    cases.check_bounds(sid, cases.port_render(sid), jax_ref(sid))


@pytest.mark.parametrize("sid", [s for s in SCENES if s in cases.GOLDEN_MEGA2])
def test_u8_hash_equals_jax_mega2_golden(sid):
    assert cases.golden_hash(sid) == cases.GOLDEN_MEGA2[sid]


@pytest.mark.parametrize("sid", (0, 7))
def test_pixel_subset_equals_full_frame(sid):
    """render_radiance keys every draw on (pixel, sample), so a strided
    subset of pixel ids renders exactly the full frame's rows."""
    scene, meta, cfg = cases.small_case(sid)
    tab = mega2.pack_mega2_tables(scene, meta, "cpu")
    fp = mega2.frame_params(scene, cfg)
    full = mega2.render_mega2(tab, fp)
    sub = torch.arange(3, cfg.width * cfg.height, 5, dtype=torch.int32)
    pad = torch.cat([sub, torch.tensor([-1], dtype=torch.int32)])
    part = mega2.render_radiance(tab, pad, fp)
    np.testing.assert_array_equal(part[:-1].numpy(), full[sub.long()].numpy())
    np.testing.assert_array_equal(part[-1].numpy(), np.zeros(3, np.float32))
