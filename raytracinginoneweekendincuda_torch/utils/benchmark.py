"""Headline benchmark of the port: scene 0 (bouncing spheres) at the
reference's measured config, 1440x720 at 10 spp (BASELINE.md).

One warm-up frame, then the best of ``--repeats`` frames.  The timed region
is the frame's kernel launch, the average/gamma/quantize epilogue and
``torch.cuda.synchronize()`` -- device completion, the same boundary as
the reference's clock (kernel.cu:675-693).  Table packing is set-up and
stays outside it.  Prints ONE JSON line with rays/s and the card's name.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    may run below its 700 W maximum, and then slower under load)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", type=int, default=0)
    p.add_argument("--width", type=int, default=1440)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..models.scenes import build_scene
    from ..scene.compiler import compile_scene
    from ..utils.config import RenderConfig
    from ..ops.mega2 import frame_params, pack_mega2_tables, render_mega2
    from ..ops.render import finalize, resolve_device

    dev = resolve_device("cuda")
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, engine="mega2")
    scene, meta = compile_scene(build_scene(args.scene), cfg.width,
                                cfg.height, dtype=np.float32)
    tab = pack_mega2_tables(scene, meta, dev)
    fp = frame_params(scene, cfg)

    def frame():
        fb = finalize(render_mega2(tab, fp), cfg.samples_per_pixel,
                      gamma=True, out_u8=True)
        torch.cuda.synchronize(dev)
        return fb

    frame()                                           # warm-up (and build)
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        img = frame()
        best = min(best, time.perf_counter() - t0)
    if not bool(img.any()):
        raise RuntimeError("benchmark frame is all zero")
    rays = cfg.width * cfg.height * cfg.samples_per_pixel
    print(json.dumps({
        "metric": f"primary rays/s, scene {args.scene} "
                  f"{cfg.width}x{cfg.height}@{cfg.samples_per_pixel}spp "
                  f"(mega2, CUDA kernel)",
        "value": rays / best,
        "unit": "rays/s",
        "seconds": best,
        "device": torch.cuda.get_device_name(dev),
        "card": card_line(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
