"""Full-frame rendering: pack -> radiance sums -> average, gamma, quantize.

Port of ``raytracinginoneweekendincuda_tpu/ops/render.py::render`` for the
default engine, ``mega2``.  Pixel ids are ``j*W + i`` with ``j`` counting
up from the bottom scanline (kernel.cu:131); the returned image is flipped
to top-down rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.compiler import SceneArrays, SceneMeta
from ..utils.config import RenderConfig
from .mega2 import frame_params, pack_mega2_tables, render_mega2


def finalize(fb: torch.Tensor, spp: int, gamma: bool,
             out_u8: bool) -> torch.Tensor:
    """Average over samples, gamma-2 sqrt (kernel.cu:150-152) and the
    reference's clamp/quantize ``256 * clip(c, 0, 0.999)``
    (kernel.cu:709-718)."""
    fb = fb / torch.tensor(float(spp), dtype=fb.dtype, device=fb.device)
    if gamma:
        fb = torch.sqrt(torch.clamp_min(fb, 0.0).double()).to(fb.dtype)
    if out_u8:
        fb = (256.0 * torch.clamp(fb, 0.0, 0.999)).to(torch.uint8)
    return fb


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    return dev


def render(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig, *,
           device, gamma: bool = True, out_u8: bool = False) -> np.ndarray:
    """Render a full frame on ``device`` -> numpy [H, W, 3], top row first
    (float, or uint8 when ``out_u8``).  Only the ``mega2`` engine exists in
    the port so far."""
    if cfg.engine != "mega2":
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not ported yet; only 'mega2' is "
            "(see ROADMAP.md, queue 1)")
    dev = resolve_device(device)
    tab = pack_mega2_tables(scene, meta, dev)
    fb = render_mega2(tab, frame_params(scene, cfg))
    img = finalize(fb, cfg.samples_per_pixel, gamma, out_u8)
    return img.cpu().numpy().reshape(cfg.height, cfg.width, 3)[::-1]
