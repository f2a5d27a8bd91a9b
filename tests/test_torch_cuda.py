"""PyTorch port on the card: K1 (csrc/mega2_render.cu) against its plain
PyTorch version.  Marked ``cuda``; skipped where there is no CUDA device
(the kernel has no CPU build).  Run on a card with
``python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist``."""

import numpy as np
import pytest
import torch

import torch_texture_scenes as tex
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops.render import finalize
from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU build")
    return torch.device("cuda", 0)


def _case(sid, dev, W=32, H=16, spp=2):
    desc = tex.SCENES[sid]() if sid in tex.SCENES else scenes.build_scene(sid)
    scene, meta = compile_scene(desc, W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       engine="mega2")
    return mega2.pack_mega2_tables(scene, meta, dev), \
        mega2.frame_params(scene, cfg)


@pytest.mark.parametrize("sid", [*range(10), *sorted(tex.SCENES)])
def test_k1_matches_plain_on_card(sid, dev):
    """Same libdevice math, IEEE division and sqrt, no FMA contraction on
    either side: at most 1% of pixels may move by more than 1e-4, and the
    mean difference stays below 2e-3 (the bounds chip_smoke.py holds)."""
    tab, fp = _case(sid, dev)
    pix = torch.arange(fp.width * fp.height, dtype=torch.int32, device=dev)
    before = mega2.render_radiance_cuda.launches
    k1 = finalize(mega2.render_radiance(tab, pix, fp), fp.spp, True, False)
    plain = finalize(mega2.render_radiance_plain(tab, pix, fp), fp.spp,
                     True, False)
    torch.cuda.synchronize()
    assert mega2.render_radiance_cuda.launches == before + 1
    diff = (k1 - plain).abs().double().cpu().numpy()
    assert np.isfinite(k1.cpu().numpy()).all()
    assert (diff.max(-1) > 1e-4).mean() <= 0.01
    assert diff.mean() < 2e-3


def test_k1_rejects_bad_pixel_ids(dev):
    tab, fp = _case(4, dev)
    with pytest.raises(ValueError, match="int32"):
        mega2.render_radiance_cuda(
            tab, torch.zeros((2, 2), dtype=torch.int32, device=dev), fp)
