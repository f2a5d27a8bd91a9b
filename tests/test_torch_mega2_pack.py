"""PyTorch port: the mega2 table packer against the JAX package's packer.

The port stores the attribute table row-major [NP, 40] instead of the
TPU's transposed, 128-lane-padded [40, NP128], and drops the TPU-only
tables (coef, cull AABBs, the bf16 image plane); every table it keeps must
equal the JAX packer's exactly, row order and f32 rounding included (ties
go to the lowest row, so the order decides winners).
"""

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.ops import mega2 as tmega2
from raytracinginoneweekendincuda_torch.ops.render import render
from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.ops import mega2 as jmega2
from raytracinginoneweekendincuda_tpu.scene import api
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("sid", range(10))
def test_tables_equal_jax_packer(sid):
    scene, meta = compile_scene(scenes.build_scene(sid), 16, 8,
                                dtype=np.float32)
    (sph, quad, attr_t, _coef, _cs, _cq, perm, vec, img_i32, img_dims, mu,
     med, remap) = jmega2.pack_mega2_tables(scene, meta)
    tab = tmega2.pack_mega2_tables(scene, meta, "cpu")
    n = lambda t: t.numpy()
    np.testing.assert_array_equal(n(tab.sph), np.asarray(sph))
    np.testing.assert_array_equal(n(tab.quad), np.asarray(quad))
    NP = tab.np_rows
    attr_t = np.asarray(attr_t)
    np.testing.assert_array_equal(n(tab.attr), attr_t[:, :NP].T)
    assert not attr_t[:, NP:].any()
    # media: the JAX packer's f64 rows hold f32 values; column 14 (unused
    # there) carries radius^2 squared in f64 for the kernel
    cols = [c for c in range(med.shape[1]) if c != 14]
    np.testing.assert_array_equal(n(tab.med)[:, cols].astype(np.float64),
                                  med[:, cols])
    np.testing.assert_array_equal(
        n(tab.med)[:, 14], (med[:, 4] * med[:, 4]).astype(np.float32))
    np.testing.assert_array_equal(n(tab.perm), np.asarray(perm))
    np.testing.assert_array_equal(n(tab.vec), np.asarray(vec))
    np.testing.assert_array_equal(n(tab.texels), np.asarray(img_i32))
    np.testing.assert_array_equal(n(tab.remap), np.asarray(remap))
    if meta.n_images:
        np.testing.assert_array_equal(
            n(tab.img_dims), [(d[0], d[1], d[4]) for d in img_dims])
    else:
        assert tab.n_images == 0
    assert (tab.nl_pad, tab.b_pad) == (int(mu[4]), int(mu[5]))
    assert tab.q_pad == quad.shape[0] - tab.b_pad
    assert tab.s_pad == sph.shape[0]


def test_undecoded_image_renders_debug_cyan():
    """An image texture with no image data (the file could not be decoded)
    reads debug cyan (Texture.h:112-114)."""
    desc = api.SceneDesc()
    desc.add(api.Sphere((0, 0, 0), 2.0,
                        api.Lambertian(api.ImageTexture(None))))
    desc.camera = scenes.earth().camera
    scene, meta = compile_scene(desc, 16, 8, dtype=np.float32)
    assert meta.has_image and meta.n_images == 0
    tab = tmega2.pack_mega2_tables(scene, meta, "cpu")
    assert tab.n_images == 0
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=2,
                       max_bounces=1, engine="mega2")
    img = render(scene, meta, cfg, device="cpu", gamma=False)
    centre = img[4, 8]
    # one bounce: the camera ray hits the sphere and the cap ends the path
    # before its scattered ray can reach the sky
    np.testing.assert_array_equal(centre, np.zeros(3, np.float32))
    # two bounces: sky radiance times the cyan albedo (0, 1, 1)
    cfg = cfg.with_(max_bounces=2)
    centre = render(scene, meta, cfg, device="cpu", gamma=False)[4, 8]
    assert centre[0] == 0.0 and centre[1] > 0.0 and centre[2] > 0.0


def test_packer_places_tables_on_the_device():
    scene, meta = compile_scene(scenes.build_scene(4), 16, 8,
                                dtype=np.float32)
    tab = tmega2.pack_mega2_tables(scene, meta, torch.device("cpu"))
    for name in ("sph", "quad", "attr", "med", "perm", "vec", "texels",
                 "img_dims", "remap"):
        t = getattr(tab, name)
        assert t.device.type == "cpu" and t.is_contiguous(), name
    assert tab.sph.dtype == tab.attr.dtype == torch.float32
    assert tab.texels.dtype == tab.remap.dtype == torch.int32
