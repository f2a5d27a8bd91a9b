"""PyTorch port: the ``bruteforce`` engine's quantized frames against the
JAX package's golden hashes (``tests/test_golden.py`` GOLDEN, column 0:
the XLA ``bruteforce`` engine; 24x12@2, scene 9 16x8, max_bounces 8).

The port's hit, shade and integrator run on the CPU in f32 and give the
JAX engine's u8 frame exactly on nine scenes.  Scene 3 (Perlin spheres)
cannot: its f32 frame rounds differently in the Perlin noise (XLA's CPU
backend contracts products into FMAs, PyTorch's CPU kernels do not; the
JAX package names the same cause for its own scene-3 split between
engines), and the marble's ``sin(scale*z + 10*turb)`` turns that into one
quantization step on 2 of its 288 pixels.  At f64 the two frames are
equal; ``test_scene3_against_jax`` holds both.
"""

import hashlib

import numpy as np
import pytest

from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.ops.render import render
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from test_golden import GOLDEN
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("sid", (0, 1, 2, 4, 5, 6, 7, 8, 9))
def test_golden_bruteforce(sid):
    W, H = (16, 8) if sid == 9 else (24, 12)
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2,
                       max_bounces=8, engine="bruteforce")
    img = render(scene, meta, cfg, device="cpu", out_u8=True)
    assert img.dtype == np.uint8 and img.shape == (H, W, 3)
    digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
    assert digest[:16] == GOLDEN[sid][0]


@pytest.mark.parametrize("dtype,max_px", [(np.float32, 2), (np.float64, 0)])
def test_scene3_against_jax(dtype, max_px):
    """Scene 3 at the golden config against JAX ``bruteforce``: at most
    ``max_px`` pixels off, by one u8 step."""
    W, H = 24, 12
    kw = dict(width=W, height=H, samples_per_pixel=2, max_bounces=8,
              dtype=np.dtype(dtype).name)
    jscene, jmeta = jcompile(jscenes.build_scene(3), W, H, dtype=dtype)
    want = np.asarray(jrender(jscene, jmeta, JConfig(**kw), out_u8=True))
    scene, meta = compile_scene(scenes.build_scene(3), W, H, dtype=dtype)
    img = render(scene, meta, RenderConfig(engine="bruteforce", **kw),
                 device="cpu", out_u8=True)
    step = np.abs(img.astype(int) - want.astype(int)).max(-1)
    assert (step > 0).sum() <= max_px and step.max() <= 1
