"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel K1 (``csrc/mega2_render.cu``) from the
sources in this checkout and drives the port's main path -- the CLI's
``ops/render.render`` with engine ``mega2`` -- at the reference's headline
config, holding K1 against its plain PyTorch version throughout.  Phases:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. K1's build time;
3. pcg4d draws and ``generate_rays`` on the card, bit-exact against the
   numpy uint32 reference / the CPU port;
4. K1 against ``render_radiance_plain`` on the card for all ten scenes at
   64x32@4, max_bounces 50 (at most 1% of pixels above 1e-4, mean < 2e-3);
5. the main path: scene 0 at 1440x720@10 through ``render``, best of 3,
   with K1's launch count over that run; the PPM is written and checked,
   and K1 is compared with the plain version on every 97th pixel id;
6. scene 9 at 360x180@10 through K1 against the plain version on every
   97th pixel id, and K1 and the plain version timed at scene 0 360x180@10.

Prints the kernel record and the card on lines of their own, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, before that
line, if any phase fails or there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from raytracinginoneweekendincuda_torch import host
from raytracinginoneweekendincuda_torch.core import rng
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops.raygen import generate_rays
from raytracinginoneweekendincuda_torch.ops.render import finalize, render
from raytracinginoneweekendincuda_torch.utils.benchmark import card_line

TOL_ABOVE = 1e-4          # a pixel "differs" when a channel moves more
MAX_FRAC_ABOVE = 0.01     # at most 1% of pixels may differ
MAX_MEAN = 2e-3           # mean absolute difference over all channels
STRIDE = 97               # pixel-id stride of the main-path check subset
MAIN = (1440, 720, 10)    # the main path's frame: width, height, spp
SMALL = (64, 32, 4)       # every scene, K1 against the plain version
SIDE = (360, 180, 10)     # scene 9, and the K1 / plain timing of scene 0


def synthetic_texture() -> np.ndarray:
    """[256, 512, 3] byte-valued texture from seed 1984 (stands in for the
    earth JPEG where PIL cannot decode it)."""
    rs = np.random.default_rng(1984)
    return rs.integers(0, 256, (256, 512, 3)).astype(np.float32) / 255.0


def scene_desc(sid: int):
    """Scene ``sid``; image textures that could not be decoded get the
    synthetic texture, so the texel path really runs.  Returns (desc,
    texture label or None)."""
    desc = host.build_scene(sid)
    label = None
    for i, obj in enumerate(desc.objects):
        mat = getattr(obj, "material", None)
        tex = getattr(mat, "texture", None)
        if isinstance(tex, host.api.ImageTexture):
            if tex.image is None:
                img = synthetic_texture()
                desc.objects[i] = dataclasses.replace(
                    obj, material=host.api.Lambertian(
                        host.api.ImageTexture(img)))
                label = "synthetic 256x512 (seed 1984): earthmap.jpg " \
                        "not decoded"
            else:
                label = f"earthmap.jpg decoded {tex.image.shape[1]}x" \
                        f"{tex.image.shape[0]}"
    return desc, label


def compile_cfg(sid: int, w: int, h: int, spp: int):
    desc, label = scene_desc(sid)
    scene, meta = host.compile_scene(desc, w, h, dtype=np.float32)
    cfg = host.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                            engine="mega2")
    return scene, meta, cfg, label


def image_of(fb: torch.Tensor, spp: int) -> np.ndarray:
    return finalize(fb, spp, gamma=True, out_u8=False).cpu().numpy()


def compare(k1: np.ndarray, plain: np.ndarray, what: str) -> dict:
    """Per-pixel comparison of two [P, 3] images, checked against the
    bounds above."""
    diff = np.abs(k1.astype(np.float64) - plain.astype(np.float64))
    px = diff.max(axis=1)
    stats = {"pixels": int(px.shape[0]),
             "identical": int((px == 0).sum()),
             "above_1e-4": int((px > TOL_ABOVE).sum()),
             "mean_abs": float(diff.mean()), "max_abs": float(diff.max())}
    print(f"  {what}: {stats['identical']}/{stats['pixels']} pixels "
          f"bit-identical, {stats['above_1e-4']} above 1e-4, mean |diff| "
          f"{stats['mean_abs']:.3e}, max {stats['max_abs']:.3e}", flush=True)
    if not np.isfinite(k1).all():
        raise AssertionError(f"{what}: K1 produced non-finite values")
    if stats["above_1e-4"] > MAX_FRAC_ABOVE * stats["pixels"] \
            or stats["mean_abs"] >= MAX_MEAN:
        raise AssertionError(f"{what}: K1 disagrees with the plain version")
    return stats


def timed(fn, repeats: int = 3):
    """(best seconds, last result) of ``fn`` after one warm-up, each run
    ending in torch.cuda.synchronize()."""
    fn()
    torch.cuda.synchronize()
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def phase_rng(dev) -> None:
    n = 1 << 17
    rs = np.random.default_rng(0)
    words = [rs.integers(0, 2 ** 32, n, dtype=np.uint32) for _ in range(4)]
    with np.errstate(over="ignore"):
        want = host.pcg4d_numpy(*words)
    got = rng.pcg4d(*[torch.from_numpy(w.view(np.int32)).to(dev)
                      for w in words])
    for a, b in zip(got, want):
        if not np.array_equal(rng.as_uint32(a), b):
            raise AssertionError("pcg4d on the card differs from numpy")
    u = rng.unit(got[0]).cpu().numpy()
    if not np.array_equal(u, (want[0] >> 8).astype(np.float32)
                          * np.float32(rng.INV_2POW24)):
        raise AssertionError("unit() on the card differs from numpy")
    w, h, _ = SMALL
    for sid in (4, 0):
        scene, meta, cfg, _ = compile_cfg(sid, w, h, 1)
        fp = mega2.frame_params(scene, cfg)
        pix = torch.arange(w * h, dtype=torch.int32)
        for s in (0, 3):
            cpu = generate_rays(fp.cam, pix, s, w, h, fp.seed)
            gpu = generate_rays(fp.cam, pix.to(dev), s, w, h, fp.seed)
            for a, b in zip(cpu[:3], gpu[:3]):
                a, b = a.numpy(), b.cpu().numpy()
                if sid == 0:
                    # lens disk: sin/cos differ between the CPU and CUDA
                    # math libraries by an ulp or two, which moves the
                    # origin and direction by ~lens radius * 1e-7
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
                elif not np.array_equal(a, b):
                    raise AssertionError(f"scene {sid} rays differ")
    print("  pcg4d: 4 x 131072 words bit-exact vs numpy uint32; rays: "
          "scene 4 bit-exact vs the CPU port, scene 0 within 1e-6",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)

    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)

    _, build = mega2.load_kernel()
    regs = [ln.strip() for ln in build["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[2] K1 build: {build['seconds']:.2f} s ({build['path']})",
          flush=True)
    for ln in regs:
        print(f"  ptxas: {ln}", flush=True)

    print("[3] RNG and raygen on the card", flush=True)
    phase_rng(dev)

    w, h, spp = SMALL
    print(f"[4] K1 vs plain, all scenes at {w}x{h}@{spp}, max_bounces 50",
          flush=True)
    launches0 = mega2.render_radiance_cuda.launches
    for sid in range(10):
        scene, meta, cfg, label = compile_cfg(sid, w, h, spp)
        if label:
            print(f"  scene {sid} texture: {label}", flush=True)
        tab = mega2.pack_mega2_tables(scene, meta, dev)
        fp = mega2.frame_params(scene, cfg)
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        k1 = image_of(mega2.render_radiance_cuda(tab, pix, fp), spp)
        plain = image_of(mega2.render_radiance_plain(tab, pix, fp), spp)
        compare(k1, plain, f"scene {sid} ({host.SCENE_NAMES[sid]})")
    if mega2.render_radiance_cuda.launches <= launches0:
        raise AssertionError("K1 launch counter did not rise")

    w, h, spp = MAIN
    print(f"[5] main path: ops/render.render, scene 0 at {w}x{h}@{spp}",
          flush=True)
    scene, meta, cfg, _ = compile_cfg(0, w, h, spp)
    mega2.render_radiance_cuda.launches = 0
    sec, img = timed(lambda: render(scene, meta, cfg, device=dev,
                                    out_u8=True))
    launches = mega2.render_radiance_cuda.launches
    if launches < 1:
        raise AssertionError("the main path did not launch K1")
    print(f"  best of 3: {sec:.4f} s, {w * h * spp / sec / 1e6:.2f} M "
          f"rays/s on {card} (render(): packing, K1, epilogue, readback); "
          f"K1 launches {launches}", flush=True)
    if img.shape != (h, w, 3) or not img.any():
        raise AssertionError("main-path image is empty or misshapen")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene0.ppm")
        host.write_ppm(path, img)
        with open(path) as f:
            head = [f.readline().strip() for _ in range(3)]
    if head != ["P3", f"{w} {h}", "255"]:
        raise AssertionError(f"bad PPM header {head}")
    print(f"  PPM header {head}", flush=True)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    k1_frame, fb = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    u8 = finalize(fb, spp, gamma=True, out_u8=True).cpu().numpy()
    if not np.array_equal(u8.reshape(h, w, 3)[::-1], img):
        raise AssertionError("main-path frame differs from K1's frame")
    print(f"  K1 alone: {k1_frame:.4f} s for the frame on {card}",
          flush=True)
    sub = pix[::STRIDE]
    main_st = compare(
        image_of(fb[sub.long()], spp),
        image_of(mega2.render_radiance_plain(tab, sub, fp), spp),
        f"scene 0 every {STRIDE}th pixel")

    w, h, spp = SIDE
    print(f"[6] scene 9 at {w}x{h}@{spp}; K1 and plain timed on scene 0",
          flush=True)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    scene, meta, cfg, label = compile_cfg(9, w, h, spp)
    print(f"  scene 9 texture: {label}", flush=True)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg)
    s9, fb = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    print(f"  scene 9 K1: {s9:.4f} s on {card}", flush=True)
    sub = pix[::STRIDE]
    compare(image_of(fb[sub.long()], spp),
            image_of(mega2.render_radiance_plain(tab, sub, fp), spp),
            f"scene 9 every {STRIDE}th pixel")
    scene, meta, cfg, _ = compile_cfg(0, w, h, spp)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg)
    k1_s, _ = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    plain_s, _ = timed(lambda: mega2.render_radiance_plain(tab, pix, fp),
                       repeats=1)
    k1_s2, _ = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    print(f"  scene 0 K1: {k1_s:.4f} s, then {k1_s2:.4f} s; plain "
          f"{plain_s:.4f} s; on {card}", flush=True)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "mega2_render",
        "route": "cuda",
        "source": "raytracinginoneweekendincuda_torch/csrc/mega2_render.cu",
        "replaces": "raytracinginoneweekendincuda_tpu/ops/mega2.py:797",
        "launches": launches,
        "max_abs_err": main_st["max_abs"],
        "ms": min(k1_s, k1_s2) * 1e3,
        "plain_ms": plain_s * 1e3,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
