"""Full-frame rendering: the engines' radiance sums -> average, gamma,
quantize.

Port of ``raytracinginoneweekendincuda_tpu/ops/render.py``.  Engines:
``mega2`` (the default; kernel K1), ``mega`` (kernel K5; Perlin and image
scenes go to ``wavefront_pallas``, as in the JAX package),
``wavefront_pallas`` (kernel K6), and in plain PyTorch ``wavefront``,
``wavefront_bvh`` and the chunked ``bruteforce`` and ``bvh`` (the
threaded BVH of `ops/bvh_engine.py`).  Pixel ids are ``j*W + i`` with ``j``
counting up from the bottom scanline (kernel.cu:131); the returned image
is flipped to top-down rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.compiler import SceneArrays, SceneMeta
from ..utils.config import RenderConfig

ENGINES = ("mega2", "mega", "wavefront_pallas", "wavefront", "wavefront_bvh",
           "bruteforce", "bvh")


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


def chunk_sums(scene, meta, pix: torch.Tensor, samples, *, width: int,
               height: int, seed: int, max_bounces: int, t_min: float,
               differentiable: bool = False, engine: str = "bruteforce",
               bvh=None) -> torch.Tensor:
    """Radiance sums [P, 3] over the sample ids ``samples`` (in order) for
    one pixel chunk ``pix`` [P] of a tensor scene (`hit.scene_tensors`);
    ``differentiable`` runs the integrator's scan form; ``bvh`` the BVH
    arrays of engine ``bvh`` (`scene/bvh.py`)."""
    from .dispatch import trace_dispatch
    from .raygen import generate_rays

    acc = torch.zeros((pix.shape[0], 3), dtype=scene.camera.origin.dtype,
                      device=pix.device)
    for s in samples:
        o, d, time, pix_ctr = generate_rays(scene.camera, pix, s, width,
                                            height, seed)
        acc = acc + trace_dispatch(scene, meta, o, d, time, pix_ctr, s,
                                   engine=engine, max_bounces=max_bounces,
                                   t_min=t_min,
                                   differentiable=differentiable, bvh=bvh)
    return acc


def render_chunk(scene, meta, pix: torch.Tensor, *, width: int, height: int,
                 spp: int, seed: int, max_bounces: int, t_min: float,
                 differentiable: bool = False, gamma: bool = True,
                 engine: str = "bruteforce", bvh=None):
    """Average radiance [P, 3] over ``spp`` samples for one pixel chunk
    ``pix`` [P] (`chunk_sums` over samples 0 .. spp - 1), gamma applied
    when ``gamma``."""
    acc = chunk_sums(scene, meta, pix, range(spp), width=width,
                     height=height, seed=seed, max_bounces=max_bounces,
                     t_min=t_min, differentiable=differentiable,
                     engine=engine, bvh=bvh)
    return average_chunk(acc, spp, gamma)


def average_chunk(acc: torch.Tensor, spp: int, gamma: bool) -> torch.Tensor:
    """The chunked engines' epilogue: the sample average of the radiance
    sums ``acc``, gamma-2 sqrt (in f64) when ``gamma``."""
    col = acc / float(spp)
    if gamma:
        col = torch.sqrt(torch.clamp_min(col, 0.0).double()).to(col.dtype)
    return col


def _render_chunked(scene, meta, cfg: RenderConfig, dev, gamma: bool,
                    out_u8: bool) -> np.ndarray:
    """The chunked engines (``bruteforce``, ``bvh``): pixel chunks of
    ``cfg.rays_per_batch``, samples summed inside each chunk; the BVH is
    built once a render."""
    from .hit import scene_tensors

    W, H = cfg.width, cfg.height
    npix = W * H
    P = min(cfg.rays_per_batch, npix)
    st = scene_tensors(scene, dev)
    t_min = float(np.asarray(cfg.t_min, np.asarray(scene.sph_rad).dtype))
    bvh = None
    if cfg.engine == "bvh":
        from ..scene.bvh import build_scene_bvh

        bvh = build_scene_bvh(scene)
    out = np.zeros((npix, 3), np.float64)
    for start in range(0, npix, P):
        ids = torch.arange(start, min(start + P, npix), device=dev)
        col = render_chunk(st, meta, ids, width=W, height=H,
                           spp=cfg.samples_per_pixel, seed=cfg.seed,
                           max_bounces=cfg.max_bounces, t_min=t_min,
                           differentiable=cfg.differentiable, gamma=gamma,
                           engine=cfg.engine, bvh=bvh)
        out[start:start + P] = col.cpu().numpy()
    fb = out.reshape(H, W, 3)                  # row 0 = bottom scanline
    if out_u8:  # the quantized-uint8 contract (kernel.cu:709-718), in f64
        fb = (256.0 * np.clip(fb, 0.0, 0.999)).astype(np.uint8)
    return fb[::-1]


def render(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig, *,
           device, gamma: bool = True, out_u8: bool = False) -> np.ndarray:
    """Render a full frame on ``device`` with engine ``cfg.engine`` ->
    numpy [H, W, 3], top row first (float, or uint8 when ``out_u8``).
    ``cfg.differentiable`` selects the integrator's scan form on the
    chunked engines (``bruteforce``, ``bvh``); the other engines have one
    loop each and ignore it, as in the JAX package."""
    if cfg.engine not in ENGINES:
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not ported; the port has "
            f"{', '.join(ENGINES)} (see ROADMAP.md, queue 1)")
    dev = resolve_device(device)
    engine = cfg.engine
    if engine == "mega2":
        from .mega2 import frame_params, pack_mega2_tables, render_mega2

        tab = pack_mega2_tables(scene, meta, dev)
        fb = render_mega2(tab, frame_params(scene, cfg))
    elif engine in ("bruteforce", "bvh"):
        return _render_chunked(scene, meta, cfg, dev, gamma, out_u8)
    else:
        from .mega import mega_supported, render_mega
        from .wavefront import render_wavefront

        if engine == "mega" and not mega_supported(meta):
            # Perlin / image textures: the JAX package's fallback
            engine = "wavefront_pallas"
        if engine == "mega":
            fb = render_mega(scene, meta, cfg, device=dev)
        else:
            fb = render_wavefront(scene, meta, cfg.with_(engine=engine),
                                  device=dev)
    img = finalize(fb, cfg.samples_per_pixel, gamma, out_u8)
    return img.cpu().numpy().reshape(cfg.height, cfg.width, 3)[::-1]
