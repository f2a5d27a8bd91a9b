"""Batched texture evaluation: the reference's virtual Texture::Value
(Texture.h:24-176) as tag-dispatched selects.

Port of ``raytracinginoneweekendincuda_tpu/ops/textures.py``.  The scene's
``SceneMeta.has_*`` flags leave out the texture families a scene does not
use.
"""

from __future__ import annotations

import torch

from ..scene.compiler import TEX_CHECKER, TEX_IMAGE, TEX_NOISE
from . import perlin

DEBUG_CYAN = (0.0, 1.0, 1.0)  # missing image fallback, Texture.h:112-114


def texture_value_rows(scene, meta, mrow, u, v, p):
    """Color [B, 3] from the winner's material rows ``mrow`` [B, 14]
    (`hit.Derived` layout: 3 tex_kind, 4:7 c0, 7:10 c1, 10 inv_scale,
    11 scale, 12 noise_id, 13 image_id) at hit point ``p`` [B, 3] with
    surface coordinates ``u``, ``v`` [B].  ``scene`` holds tensors
    (`hit.scene_tensors`)."""
    kind = mrow[:, 3].to(torch.int64)
    c0 = mrow[:, 4:7]
    val = c0  # TEX_SOLID (Texture.h:48-51)

    if meta.has_checker:
        inv_scale = mrow[:, 10]
        cell = torch.floor(inv_scale[:, None] * p).to(torch.int32)
        # floor-mod parity, as Python's and jnp's ``%`` (Texture.h:74-78)
        is_even = ((cell[:, 0] + cell[:, 1] + cell[:, 2]) % 2) == 0
        checker = torch.where(is_even[:, None], c0, mrow[:, 7:10])
        val = torch.where((kind == TEX_CHECKER)[:, None], checker, val)

    if meta.has_noise:
        nid = torch.clamp(mrow[:, 12].to(torch.int64), 0,
                          scene.perlin_vec.shape[0] - 1)
        turb = perlin.turbulence(scene.perlin_vec, scene.perlin_px,
                                 scene.perlin_py, scene.perlin_pz, nid, p)
        # marble: 0.5*(1 + sin(scale*z + 10*turb)) (Texture.h:163-164)
        marble = 0.5 * (1.0 + torch.sin(mrow[:, 11] * p[..., 2]
                                        + 10.0 * turb))
        val = torch.where((kind == TEX_NOISE)[:, None], marble[:, None], val)

    if meta.has_image:
        img_id = mrow[:, 13].to(torch.int64)
        iid = torch.clamp(img_id, 0, scene.img_data.shape[0] - 1)
        w = scene.img_w[iid]
        h = scene.img_h[iid]
        uu = torch.clamp(u, 0.0, 1.0)                     # Texture.h:117-118
        vv = 1.0 - torch.clamp(v, 0.0, 1.0)
        ix = torch.minimum((uu * w.to(u.dtype)).to(torch.int64), w - 1)
        iy = torch.minimum((vv * h.to(u.dtype)).to(torch.int64), h - 1)
        texel = scene.img_data[iid, iy, ix]
        cyan = torch.tensor(DEBUG_CYAN, dtype=p.dtype, device=p.device)
        texel = torch.where((img_id >= 0)[:, None], texel, cyan)
        val = torch.where((kind == TEX_IMAGE)[:, None], texel, val)

    return val
