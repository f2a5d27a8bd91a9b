"""Build and render your own world with the declarative scene API.

Port of the JAX package's ``examples/custom_scene.py``: the same world --
spheres, a moving sphere, quads, a rotated and translated box, a constant
medium, all five materials and three texture kinds -- compiled to the same
arrays and rendered with the default engine (``bruteforce``), on the card
unless ``--device cpu`` asks for the CPU.

Run:  python -m raytracinginoneweekendincuda_torch.examples.custom_scene \\
          [--out out/custom.ppm] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time


def build_desc():
    """The example's world (the JAX example's, object for object)."""
    from ..core.camera import Camera
    from ..scene.api import (
        Box, CheckerTexture, ConstantMedium, Dielectric, DiffuseLight,
        Lambertian, Metal, NoiseTexture, Quad, RotateY, SceneDesc,
        SolidColor, Sphere, Translate,
    )

    desc = SceneDesc()
    desc.add(
        # checkered ground (Texture.h:60-87 semantics)
        Sphere((0, -1000, 0), 1000.0,
               Lambertian(CheckerTexture(0.32, SolidColor((0.1, 0.2, 0.1)),
                                         SolidColor((0.9, 0.9, 0.9))))),
        # marble sphere (Perlin turbulence)
        Sphere((-2.5, 1, 0.5), 1.0, Lambertian(NoiseTexture(4.0))),
        # glass sphere over a brushed-metal one
        Sphere((0, 1, 0), 1.0, Dielectric(1.5)),
        Sphere((2.5, 1, -0.5), 1.0, Metal((0.8, 0.6, 0.2), fuzz=0.05)),
        # a motion-blurred bouncing ball (center2 => MovingSphere.h)
        Sphere((-1.2, 0.4, 2.2), 0.4, Lambertian((0.7, 0.3, 0.3)),
               center2=(-1.2, 0.8, 2.2)),
        # a rotated, translated box wrapped in thin fog
        Translate(RotateY(Box((-0.6, 0, -0.6), (0.6, 1.2, 0.6),
                              Lambertian((0.6, 0.6, 0.8))), 30.0),
                  (1.2, 0, 2.4)),
        ConstantMedium(Sphere((0, 1, 0), 5.0, Lambertian((1, 1, 1))),
                       0.02, (0.9, 0.9, 0.9)),
        # an area light overhead
        Quad((-1, 4.5, -1), (2, 0, 0), (0, 0, 2),
             DiffuseLight((6.0, 6.0, 6.0))),
    )
    desc.camera = Camera(
        lookfrom=(6, 2.5, 7), lookat=(0, 1, 0), vfov=35.0,
        aperture=0.05, focus_dist=9.0, time0=0.0, time1=1.0,
        background=(0.55, 0.65, 0.85),
    )
    return desc


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="out/custom.ppm")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--spp", type=int, default=25)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the card (raises without one); cpu: the CPU")
    args = p.parse_args(argv)

    import os

    import numpy as np

    from ..core.image import write_ppm
    from ..ops.render import render, resolve_device
    from ..scene.compiler import compile_scene
    from ..utils.config import RenderConfig

    dev = resolve_device(args.device)
    scene, meta = compile_scene(build_desc(), args.width, args.height,
                                dtype=np.float32)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp)
    t0 = time.perf_counter()
    img = render(scene, meta, cfg, device=dev)
    print(f"rendered {args.width}x{args.height}@{args.spp}spp on {dev} "
          f"in {time.perf_counter() - t0:.2f}s")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_ppm(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
