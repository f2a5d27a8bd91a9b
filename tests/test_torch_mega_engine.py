"""PyTorch port, the slice at f32: the ``mega`` engine (kernel K5's plain
version on the CPU and the pool-refill frame loop) against the JAX
package's ``mega`` engine (its Pallas kernel in interpret mode), and the
fallback of Perlin / image scenes to ``wavefront_pallas``.

Contract (tests/test_mega.py): the same RNG counters and bounce-loop
rules, so the frames agree except for ulp-level f32 winner flips;
``max_bad`` is tests/test_mega.py's table of pixels allowed to differ by
more than 1e-5.
"""

import numpy as np
import pytest

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops.mega import mega_supported
from raytracinginoneweekendincuda_torch.ops.render import render as trender
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_torch.utils.config import (
    RenderConfig as TConfig,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

W, H, SPP, RPB = 16, 8, 2, 512


@pytest.mark.parametrize("sid,max_bad", [
    (0, 4),   # moving spheres: f32 ulp-tie flips
    (1, 0),   # checker spheres
    (4, 0),   # quads
    (6, 0),   # cornell (emissive, black background)
    (7, 0),   # cornell + rotated boxes
    (8, 0),   # cornell smoke (sphere + box media)
])
def test_mega_matches_jax(sid, max_bad):
    jscene, jmeta = jcompile(jscenes.build_scene(sid), W, H,
                             dtype=np.float32)
    want = np.asarray(jrender(jscene, jmeta, JConfig(
        width=W, height=H, samples_per_pixel=SPP, rays_per_batch=RPB,
        engine="mega")))
    scene, meta = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float32)
    assert mega_supported(meta)
    img = trender(scene, meta, TConfig(
        width=W, height=H, samples_per_pixel=SPP, rays_per_batch=RPB,
        engine="mega"), device="cpu")
    assert img.dtype == np.float32 and img.shape == (H, W, 3)
    nbad = int((np.abs(img - want).max(-1) > 1e-5).sum())
    assert nbad <= max_bad, f"{nbad} pixels flipped"


def test_mega_fallback_for_noise_scene():
    """Scene 3 (Perlin) is not in K5: ``mega`` renders it through
    ``wavefront_pallas``, array-equal."""
    scene, meta = tcompile(tscenes.build_scene(3), W, H, dtype=np.float32)
    assert not mega_supported(meta)
    cfg = TConfig(width=W, height=H, samples_per_pixel=SPP,
                  rays_per_batch=RPB)
    np.testing.assert_array_equal(
        trender(scene, meta, cfg.with_(engine="mega"), device="cpu"),
        trender(scene, meta, cfg.with_(engine="wavefront_pallas"),
                device="cpu"))
