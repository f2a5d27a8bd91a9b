"""Inverse rendering: recover material parameters from a target image.

Port of the JAX package's ``examples/inverse_render.py``: the same scene
(a diffuse and a metal sphere over a marble ground), the same target (the
``bruteforce`` engine's linear radiance), the same general train step
(``parallel/train.make_train_step``, engine ``auto``: the taped replay of
the XLA path) and the same freeze of every parameter but the albedos
(``tex_c0``, ``tex_c1``).  The JAX example runs its step over a device
mesh; the port's step runs on one device.

Pathwise gradients capture channels that vary continuously along light
paths (albedos, emission, material scalars, camera, geometry through
continuous textures); visibility changes have zero pathwise gradient, so
the demo recovers materials with geometry frozen.

Run:  python -m raytracinginoneweekendincuda_torch.examples.inverse_render \\
          [--steps 80] [--out out/inverse_render] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--out", type=str, default="out/inverse_render")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card (raises without one); cpu: the "
                         "CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..core.camera import Camera
    from ..core.image import write_png
    from ..ops.render import render, resolve_device
    from ..parallel import train
    from ..scene.api import Lambertian, Metal, NoiseTexture, SceneDesc, Sphere
    from ..scene.compiler import compile_scene
    from ..utils.config import RenderConfig

    dev = resolve_device(args.device)
    W, H, SPP = 48, 27, 8

    def make_desc(albedo, metal_albedo):
        desc = SceneDesc()
        desc.add(
            Sphere((-0.55, 0.0, -1.0), 0.5, Lambertian(tuple(albedo))),
            Sphere((0.55, 0.0, -1.0), 0.5, Metal(tuple(metal_albedo), 0.15)),
            # marble ground gives the metal reflections something
            # continuously varying to see
            Sphere((0.0, -100.5, -1.0), 100.0,
                   Lambertian(NoiseTexture(2.0, table_seed=3))),
        )
        desc.camera = Camera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=90.0,
                             focus_dist=1.0, background=(0.70, 0.80, 1.00))
        return desc

    true_albedo = np.array([0.70, 0.25, 0.20])
    true_metal = np.array([0.90, 0.75, 0.35])   # gold-ish
    init_albedo = np.array([0.40, 0.40, 0.45])
    init_metal = np.array([0.60, 0.60, 0.60])

    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_bounces=8)
    true_scene, meta = compile_scene(make_desc(true_albedo, true_metal), W, H,
                                     dtype=np.float32)
    target_img = render(true_scene, meta, cfg, device=dev, gamma=False)
    npix = W * H
    target = torch.as_tensor(
        np.ascontiguousarray(target_img[::-1]).reshape(npix, 3), device=dev)
    pix = np.arange(npix, dtype=np.int32)

    scene, _ = compile_scene(make_desc(init_albedo, init_metal), W, H,
                             dtype=np.float32)
    # optimize the albedos only: every other leaf is left out of the
    # optimizer, so it stays as it is
    params = train.split_params(scene, dev)
    state = train.init_state(
        scene, lambda _ps: torch.optim.Adam(
            [params["tex_c0"], params["tex_c1"]], lr=2e-2),
        params=params)
    step = train.make_train_step(scene, meta, cfg)

    print(f"device {dev}; optimizing {args.steps} steps ({W}x{H}, {SPP} spp)",
          file=sys.stderr)
    for i in range(args.steps):
        state, loss = step(state, scene, pix, target)
        if i % 10 == 0 or i == args.steps - 1:
            tc = state.params["tex_c0"].detach().cpu().numpy()
            a, m = tc[0], tc[1]
            print(f"step {i:3d}  loss {float(loss):.6f}  "
                  f"albedo ({a[0]:.3f},{a[1]:.3f},{a[2]:.3f})  "
                  f"metal ({m[0]:.3f},{m[1]:.3f},{m[2]:.3f})",
                  file=sys.stderr)

    tc = state.params["tex_c0"].detach().cpu().numpy()
    err_a = float(np.abs(tc[0] - true_albedo).max())
    err_f = float(np.abs(tc[1] - true_metal).max())
    print(f"\nrecovered diffuse-albedo error {err_a:.3f}, "
          f"metal-albedo error {err_f:.3f}", file=sys.stderr)

    os.makedirs(args.out, exist_ok=True)
    final = train.merge_params(scene, train.params_to_numpy(state.params))
    for name, sc in (("target", true_scene), ("init", scene),
                     ("recovered", final)):
        write_png(os.path.join(args.out, f"{name}.png"),
                  render(sc, meta, cfg, device=dev))
    print(f"wrote {args.out}/{{target,init,recovered}}.png", file=sys.stderr)
    return 0 if (err_a < 0.08 and err_f < 0.08) else 1


if __name__ == "__main__":
    raise SystemExit(main())
