"""Command-line renderer of the PyTorch / CUDA port.

Same flags as ``raytracinginoneweekendincuda_tpu.utils.cli`` (defaults
follow the reference: 1440x720, scene 9, per-scene spp, seed 1984), except
that ``--device {cuda,cpu}`` replaces ``--cpu``, ``--sharded`` and
``--profile``.  ``--device cuda`` (the default) renders with the CUDA
kernel and raises when there is no CUDA device; ``--device cpu`` renders
with the plain PyTorch version.

Usage:
    python -m raytracinginoneweekendincuda_torch.utils.cli \
        --scene 4 --width 240 --height 135 --spp 10 --out out.ppm
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtow-torch", description=__doc__)
    p.add_argument("--scene", type=int, default=9,
                   help="scene id 0-9 (kernel.cu:578-589)")
    p.add_argument("--width", type=int, default=1440)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=None,
                   help="samples per pixel (default: reference per-scene "
                        "choice)")
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--seed", type=int, default=1984)
    p.add_argument("--out", type=str, default="output.ppm")
    p.add_argument("--png", type=str, default=None,
                   help="also write a PNG here")
    p.add_argument("--engine", default="mega2", choices=("mega2",),
                   help="render engine (only mega2 is ported so far)")
    p.add_argument("--dtype", choices=("float32",), default="float32")
    p.add_argument("--rays-per-batch", type=int, default=None,
                   help="accepted for compatibility; mega2 renders the "
                        "whole frame in one launch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the CUDA kernel (raises without a card); "
                        "cpu: the plain PyTorch version")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..core.image import write_png, write_ppm
    from ..models.scenes import SCENE_NAMES, build_scene
    from ..scene.compiler import compile_scene
    from ..utils.config import RenderConfig, reference_samples_for_scene
    from ..ops.render import render, resolve_device

    dev = resolve_device(args.device)
    spp = args.spp if args.spp is not None \
        else reference_samples_for_scene(args.scene)
    cfg = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=spp,
        max_bounces=args.max_bounces, seed=args.seed, engine=args.engine,
        dtype=args.dtype)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"Rendering scene {args.scene} ({SCENE_NAMES[args.scene]}): "
          f"{cfg.width}x{cfg.height}, {spp} spp, engine={args.engine}, "
          f"device={dev} ({name})", file=sys.stderr)

    scene, meta = compile_scene(build_scene(args.scene), cfg.width,
                                cfg.height, dtype=np.float32)
    t0 = time.perf_counter()
    img = render(scene, meta, cfg, device=dev, out_u8=True)
    dt = time.perf_counter() - t0
    rays = cfg.width * cfg.height * spp
    print(f"took {dt:.3f} s  ({rays / dt / 1e6:.2f} M primary rays/s, "
          f"including table packing and the first-use kernel build)",
          file=sys.stderr)
    write_ppm(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)
    if args.png:
        write_png(args.png, img)
        print(f"wrote {args.png}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
