"""Inverse rendering of GEOMETRY: recover a sphere center from pixels.

Port of the JAX package's ``examples/recover_geometry.py``: a marble
(Perlin-turbulence) sphere's CENTER is displaced and recovered by Adam on
the pathwise gradient of the general train step
(``parallel/train.make_train_step``, engine ``taped``: the winner tapes of
the XLA search, then the differentiable replay).

Why marble: pathwise gradients see geometry only through continuously
varying shading -- for a solid-color sphere, moving the center only moves
its silhouette, which has zero pathwise gradient a.e. A marble sphere's
radiance depends on the hit point through turbulence -> sin
(Texture.h:163-164), so a center displacement misaligns the observed
pattern and the MSE gradient pulls it back.  The displacement must stay
within the texture's coherence length; silhouette error remains
invisible to the estimator, so recovery is to pattern alignment, not
contour fit.

Run:  python -m raytracinginoneweekendincuda_torch.examples.recover_geometry \\
          [--steps 80] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card (raises without one); cpu: the "
                         "CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models import scenes
    from ..ops.render import render, resolve_device
    from ..parallel import train
    from ..scene.compiler import compile_scene
    from ..utils.config import RenderConfig

    dev = resolve_device(args.device)
    W, H, spp = 48, 27, 16
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_bounces=3)

    # scene 3 (perlin_spheres): marble ground + a marble sphere at (0,2,0)
    scene, meta = compile_scene(scenes.perlin_spheres(), W, H,
                                dtype=np.float32)
    true_c0 = np.asarray(scene.sph_c0, np.float64).copy()
    # the small ACTIVE sphere (padding rows carry radius 0)
    rad = np.asarray(scene.sph_rad, np.float64)
    act = np.asarray(scene.sph_active) > 0
    sphere_row = int(np.argmin(np.where(act, rad, np.inf)))

    # target image (linear radiance) from the TRUE geometry
    target_img = render(scene, meta, cfg, device=dev, gamma=False)
    target = torch.as_tensor(
        np.ascontiguousarray(target_img[::-1]).reshape(W * H, 3), device=dev)
    pix = np.arange(W * H, dtype=np.int32)

    # displace the center within the marble's coherence length (the finest
    # turbulence octave has wavelength ~0.1)
    c0_init = true_c0.copy()
    c0_init[sphere_row] += np.array([0.03, 0.0, -0.04])
    scene0 = scene._replace(sph_c0=c0_init.astype(np.float32))

    # Adam on the centers alone, every other leaf left as it is; after each
    # step the center's y and the other rows are put back (the JAX
    # example's per-row projection): measured on this scene, the pathwise
    # estimator carries a spurious y pull ~8x the true x slope
    # (silhouette-adjacent bias), while the x / z gradients match the loss
    # landscape's slope
    params = train.split_params(scene0, dev)
    c0 = params["sph_c0"]
    state = train.init_state(
        scene0, lambda _ps: torch.optim.Adam([c0], lr=4e-3), params=params)
    step = train.make_train_step(scene0, meta, cfg, engine="taped")
    keep = c0.detach().clone()
    free = torch.zeros_like(keep, dtype=torch.bool)
    free[sphere_row, 0] = free[sphere_row, 2] = True

    def center_err() -> float:
        c = c0.detach().cpu().numpy().astype(np.float64)[sphere_row]
        return float(np.linalg.norm(c - true_c0[sphere_row]))

    err0 = center_err()
    print(f"initial center error: {err0:.4f}")
    # on the card the gradient's row sums (index_add_) use atomics, whose
    # order varies from run to run, and 80 steps of Adam amplify that
    # into a different trajectory each run; deterministic sums make the
    # run repeatable, as the JAX example's is
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for it in range(args.steps):
            state, loss = step(state, scene0, pix, target)
            with torch.no_grad():
                c0.copy_(torch.where(free, c0, keep))
            if it % 10 == 0 or it == args.steps - 1:
                print(f"step {it:3d}: loss {float(loss):.3e}  "
                      f"center err {center_err():.4f}")
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])

    err1 = center_err()
    print(f"center error {err0:.4f} -> {err1:.4f} "
          f"({err0 / max(err1, 1e-9):.1f}x reduction)")
    assert err1 < 0.5 * err0, "geometry recovery failed to converge"
    print("recovered (pattern-aligned) -- silhouette error is invisible to "
          "pathwise gradients, so sub-pixel contour mismatch may remain")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
