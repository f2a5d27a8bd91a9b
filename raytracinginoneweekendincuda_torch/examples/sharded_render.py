"""Render one frame over every rank of a ``torch.distributed`` world.

Port of the JAX package's ``examples/sharded_render.py``.  The (px, sp)
mesh of `parallel/render.py` shards interleaved pixel sets and sample
windows over the ranks, K1 runs per shard (engine mega2), one all-reduce
merges the sample axis and one all-gather the pixels.  The counter RNG
keys on global pixel and sample ids, so the frame is the one-device
render's (bit-identical when the sample axis is not split, equal to f32
reassociation when it is), which this script checks when the world has
more than one rank.

One process (the one-rank mesh):
    python -m raytracinginoneweekendincuda_torch.examples.sharded_render
One card a rank (NCCL), or ranks on the CPU (gloo) with --device cpu:
    python -m torch.distributed.run --nproc_per_node N \\
        -m raytracinginoneweekendincuda_torch.examples.sharded_render
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", type=int, default=4)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--out", default="sharded.ppm")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch.distributed as dist

    from ..core.image import write_ppm
    from ..models import scenes
    from ..ops.render import render, resolve_device
    from ..parallel import distributed
    from ..parallel.render import AXIS_PX, AXIS_SP, make_mesh, render_sharded
    from ..scene.compiler import compile_scene
    from ..utils.config import RenderConfig

    distributed.initialize(device=args.device)
    dev = resolve_device(distributed.rank_device(args.device))
    mesh = make_mesh(device=dev)
    world = mesh.shape[AXIS_PX] * mesh.shape[AXIS_SP]
    primary = distributed.is_primary()
    if primary:
        print(f"ranks: {world} on {dev.type}, mesh px={mesh.shape[AXIS_PX]} "
              f"sp={mesh.shape[AXIS_SP]}")

    scene, meta = compile_scene(scenes.build_scene(args.scene), args.width,
                                args.height, dtype=np.float32)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, engine="mega2")
    t0 = time.perf_counter()
    img = render_sharded(scene, meta, cfg, mesh, device=dev)
    if primary:
        print(f"sharded render: {time.perf_counter() - t0:.2f}s")
    if dist.is_initialized():
        dist.destroy_process_group()
    if not primary:
        return 0
    if world > 1:
        ref = render(scene, meta, cfg, device=dev)
        if mesh.shape[AXIS_SP] == 1:
            same = bool(np.array_equal(img, ref))
            kind = "bit-identical"
        else:
            same = bool(np.allclose(img, ref, atol=5e-7, rtol=5e-7))
            kind = "equal to f32 reassociation"
        print(f"vs one device: {kind}: {same}")
        if not same:
            raise AssertionError("the sharded frame differs from the "
                                 "one-device render")
    write_ppm(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
