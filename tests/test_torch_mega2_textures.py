"""PyTorch port: the texture-gate scenes of ``tests/test_mega2_textures.py``
-- several images, images on a quad and on box faces, two Perlin tables --
rendered by the plain version against JAX ``mega2`` (interpret mode) at
16x8@2, with that file's bounds; and the box detection pinned."""

import numpy as np
import pytest

import torch_texture_scenes as tex
from raytracinginoneweekendincuda_torch.core import camera as tcam
from raytracinginoneweekendincuda_torch.ops import mega2 as tmega2
from raytracinginoneweekendincuda_torch.ops.render import render as trender
from raytracinginoneweekendincuda_torch.scene import api as tapi
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile_scene,
)
from raytracinginoneweekendincuda_tpu.core import camera as jcam
from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.scene import api as japi
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(tex.SCENES))
def test_texture_gate_scene_matches_jax_mega2(name):
    W, H = 16, 8
    # each side builds and compiles the scene with its own package
    jscene, jmeta = compile_scene(tex.SCENES[name](japi, jcam), W, H,
                                  dtype=np.float32)
    scene, meta = tcompile_scene(tex.SCENES[name](tapi, tcam), W, H,
                                 dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2,
                       rays_per_batch=512, engine="mega2")
    ref = np.asarray(jrender(jscene, jmeta, cfg))
    img = trender(scene, meta, cfg, device="cpu")
    diff = np.abs(img.astype(np.float64) - ref)
    if name == "two_noise_tables":
        # marble is ulp-sensitive on the r=1000 ground: statistical bound
        assert meta.n_noise == 2
        assert (diff.max(-1) < 1e-2).mean() > 0.9
        assert diff.mean() < 2e-2
    else:
        assert int((diff.max(-1) > 1e-5).sum()) == 0, diff.max()
        assert diff.mean() < 5e-3
    if name == "two_images_and_image_on_quad":
        assert meta.n_images == 3 and meta.image_on_quad
    if name == "image_on_box_face":
        assert tmega2.pack_mega2_tables(scene, meta, "cpu").b_pad > 0


@pytest.mark.parametrize("sid,boxes", [(9, 400), (7, 0), (8, 0)])
def test_box_detection_pinned(sid, boxes):
    """Scene 9's 400 ground boxes ride the slab path; the rotated boxes of
    scenes 7 and 8 stay loose quads."""
    scene, meta = compile_scene(scenes.build_scene(sid), 16, 8,
                                dtype=np.float32)
    tab = tmega2.pack_mega2_tables(scene, meta, "cpu")
    assert tab.b_pad == -(-boxes // tmega2.CULL_C) * tmega2.CULL_C
    assert int((tab.quad[tab.q_pad:, 7] > 0.5).sum()) == boxes
