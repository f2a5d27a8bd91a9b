"""Device times of the render kernels K1, K2 and K5 at fixed shapes, and
the hash of the main path's u8 frame, on one card:

    python -m raytracinginoneweekendincuda_torch.tools.kernel_times

- K1 (``render_radiance_cuda``): scene 0 at 1440x720@10 (the main path's
  frame) and 360x180@10, best of 3; scenes 1-9 at 1440x720 at the
  reference's sample counts (10 for 1-4, 200 for 5-8, 100 for 9), one run
  after a warm-up; 50 bounces;
- K2 (``trace_tapes_cuda``): scene 0 at the training step's shape,
  640x360, spp 8, K 8 (1.84 M lanes), best of 5;
- K5 (``mega_bounces_cuda``): scene 0's 8192-ray pool (the first refill of
  a 64x32@4 frame), K 2, best of 5 batches of 20 launches;
- K1 on the large world, ``models/scenes.sphere_field()`` (10,000
  spheres) at 1440x720@10, 50 bounces, best of 3: as packed by default
  (the chunk cull engaged, where the package has it) and, where the
  packer takes the cull's thresholds, with the cull forced off; with the
  frame's u8 hash, which the cull must not change.

Times are CUDA events by ``tools/common.best_ms`` (each batch behind a
sleep kernel, so they are device times).  The frame hash is the SHA-256
of scene 0's 1440x720@10 u8 frame (`ops/render.finalize`), which must not
change when K1 changes.  The script uses only wrappers that every version
of the port has, so it also times an older checkout of the package: run
this file by path with that checkout first on ``PYTHONPATH``.  Prints the
card and one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import sys

import numpy as np
import torch

from raytracinginoneweekendincuda_torch.models.scenes import (
    build_scene, sphere_field,
)
from raytracinginoneweekendincuda_torch.ops import mega, mega2
from raytracinginoneweekendincuda_torch.ops.raygen import (
    camera_tuple, generate_rays,
)
from raytracinginoneweekendincuda_torch.ops.render import (
    finalize, resolve_device,
)
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.tools.common import best_ms
from raytracinginoneweekendincuda_torch.utils.benchmark import card_line
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig

K1_FRAMES = ((0, 1440, 720, 10, 3), (0, 360, 180, 10, 3),
             *((sid, 1440, 720, spp, 1) for sid, spp in (
                 (1, 10), (2, 10), (3, 10), (4, 10), (5, 200), (6, 200),
                 (7, 200), (8, 200), (9, 100))))   # scene, w, h, spp, repeats
K2_SHAPE = (0, 640, 360, 8, 8)          # scene, w, h, spp, K
K5_POOL = (0, 64, 32, 4)                # scene, w, h, spp
FIELD_FRAME = (1440, 720, 10)           # the large world: w, h, spp


def _frame(sid: int, w: int, h: int, spp: int, max_bounces: int, dev):
    scene, meta = compile_scene(build_scene(sid), w, h, dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_bounces=max_bounces)
    return mega2.pack_mega2_tables(scene, meta, dev), \
        mega2.frame_params(scene, cfg)


def k1_times(dev) -> dict:
    out = {}
    for sid, w, h, spp, repeats in K1_FRAMES:
        tab, fp = _frame(sid, w, h, spp, 50, dev)
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        key = f"scene{sid}_{w}x{h}@{spp}"
        out[key + "_ms"] = best_ms(
            lambda: mega2.render_radiance_cuda(tab, pix, fp), dev, repeats)
        if sid == 0 and w == 1440:
            u8 = finalize(mega2.render_radiance_cuda(tab, pix, fp), spp,
                          gamma=True, out_u8=True)
            out[key + "_u8_sha256"] = hashlib.sha256(
                u8.cpu().numpy().tobytes()).hexdigest()
        print(f"  K1 {key}: {out[key + '_ms']:.3f} ms", flush=True)
    return out


def k2_ms(dev) -> float:
    sid, w, h, spp, K = K2_SHAPE
    tab, fp = _frame(sid, w, h, 1, K, dev)
    pix, samp = mega2.tape_lanes(
        torch.arange(w * h, dtype=torch.int32, device=dev), spp)
    return best_ms(lambda: mega2.trace_tapes_cuda(tab, pix, samp, fp), dev)


def k5_ms(dev) -> float:
    sid, w, h, spp = K5_POOL
    scene, meta = compile_scene(build_scene(sid), w, h, dtype=np.float32)
    tabs = mega.pack_mega_tables(scene, meta, dev)
    k = torch.arange(w * h * spp, device=dev)
    o, d, tm, pc = generate_rays(camera_tuple(scene.camera), k % (w * h),
                                 k // (w * h), w, h, 1984)
    rf = torch.cat([o, d, tm[:, None], torch.ones_like(o),
                    torch.zeros_like(o)], dim=1).contiguous()
    zero = torch.zeros_like(pc)
    ri = torch.stack([pc, (k // (w * h)).to(torch.int32), zero, zero + 1],
                     dim=1).contiguous()
    kw = dict(k_bounces=mega.MEGA_K, t_min=1e-3, max_bounces=50,
              background=tuple(float(x) for x in
                               np.asarray(scene.camera.background)))
    return best_ms(lambda: mega.mega_bounces_cuda(rf, ri, tabs, **kw), dev,
                   launches=20)


def field_times(dev) -> dict:
    """K1 on the large world, packed by default and (where the packer has
    the cull's thresholds) with the cull off; the default frame's hash."""
    w, h, spp = FIELD_FRAME
    scene, meta = compile_scene(sphere_field(), w, h, dtype=np.float32)
    fp = mega2.frame_params(scene, RenderConfig(
        width=w, height=h, samples_per_pixel=spp, max_bounces=50))
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    key = f"field10k_{w}x{h}@{spp}"
    packs = {key: {}}
    if "cull_min_chunks" in inspect.signature(
            mega2.pack_mega2_tables).parameters:
        packs[key + "_nocull"] = {"cull_min_chunks": 10 ** 9}
    out = {}
    for name, pack in packs.items():
        tab = mega2.pack_mega2_tables(scene, meta, dev, **pack)
        out[name + "_ms"] = best_ms(
            lambda: mega2.render_radiance_cuda(tab, pix, fp), dev, 3)
        print(f"  K1 {name}: {out[name + '_ms']:.3f} ms", flush=True)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    u8 = finalize(mega2.render_radiance_cuda(tab, pix, fp), spp,
                  gamma=True, out_u8=True)
    out[key + "_u8_sha256"] = hashlib.sha256(
        u8.cpu().numpy().tobytes()).hexdigest()
    return out


def main(argv=None) -> dict:
    if argv:
        raise SystemExit(f"kernel_times takes no arguments, got {argv}")
    dev = resolve_device("cuda")
    card = card_line()
    print(f"card: {card}; package {mega2.__file__}", flush=True)
    res = {"card": card, "package": mega2.__file__, **k1_times(dev)}
    res["k2_train_shape_ms"] = k2_ms(dev)
    res["k5_scene0_pool_ms"] = k5_ms(dev)
    res.update(field_times(dev))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
