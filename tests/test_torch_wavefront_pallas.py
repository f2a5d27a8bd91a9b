"""PyTorch port, the slice at f32: the ``wavefront_pallas`` engine (kernel
K6's plain version on the CPU, plain PyTorch around it) against the JAX
package's ``wavefront_pallas`` engine (its Pallas kernel in interpret
mode), and the ``wavefront`` pool refill.

Contract (tests/test_pallas.py): the same RNG counters, so the frames
agree except where an ulp-level f32 difference flips a winner, which
changes that pixel's whole path.  ``max_bad`` is tests/test_pallas.py's
table of pixels allowed to differ by more than 1e-5.
"""

import numpy as np
import pytest

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
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

W, H, SPP, RPB = 24, 16, 2, 512


@pytest.mark.parametrize("sid,max_bad", [
    (0, 12),   # moving spheres: f32 tie flips
    (2, 2),    # earth: image texture through the record path
    (4, 0),    # quads only
    (5, 24),   # marble on the r=1000 ground sphere amplifies ulp-level t
    (6, 0),    # cornell: quads + emissive
    (8, 2),    # cornell smoke: the media merge
])
def test_wavefront_pallas_matches_jax(sid, max_bad):
    jscene, jmeta = jcompile(jscenes.build_scene(sid), W, H,
                             dtype=np.float32)
    want = np.asarray(jrender(jscene, jmeta, JConfig(
        width=W, height=H, samples_per_pixel=SPP, rays_per_batch=RPB,
        engine="wavefront_pallas")))
    scene, meta = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float32)
    img = trender(scene, meta, TConfig(
        width=W, height=H, samples_per_pixel=SPP, rays_per_batch=RPB,
        engine="wavefront_pallas"), device="cpu")
    assert img.dtype == np.float32 and img.shape == (H, W, 3)
    nbad = int((np.abs(img - want).max(-1) > 1e-5).sum())
    assert nbad <= max_bad, f"{nbad} pixels flipped"


def test_wavefront_small_pool_and_f32():
    """Mirror of tests/test_wavefront.py::test_wavefront_small_pool_and_f32:
    a pool much smaller than the work list; refill must cover everything."""
    w, h, spp = 16, 8, 4
    scene, meta = tcompile(tscenes.quads(), w, h, dtype=np.float32)
    cfg = TConfig(width=w, height=h, samples_per_pixel=spp,
                  rays_per_batch=32)
    ref = trender(scene, meta, cfg.with_(rays_per_batch=1 << 17),
                  device="cpu")
    img = trender(scene, meta, cfg.with_(engine="wavefront"), device="cpu")
    np.testing.assert_allclose(img, ref, atol=3e-6, rtol=3e-6)
