"""Command-line renderer of the PyTorch / CUDA port.

Same flags as ``raytracinginoneweekendincuda_tpu.utils.cli`` (defaults
follow the reference: 1440x720, scene 9, per-scene spp, seed 1984), except
that ``--device {cuda,cpu}`` replaces ``--cpu``, and ``--profile DIR``
writes a ``torch.profiler`` Chrome trace of the render (host and, on the
card, device activity) into DIR, where the JAX CLI writes a
``jax.profiler`` trace, and then prints the port's counters
(`utils/tracing.py`: ``upload_bytes``, the bytes of the tables' copies to
the device, and the others listed there).  Beside torch's own events the
trace holds the port's host spans: ``rt.render`` (the frame), and inside
it, on engine ``mega2``, ``rt.pack`` (the host packer) with
``rt.pack.textures`` (the texture tables) and ``rt.pack.upload`` (the
tables' copies), ``rt.params``, ``rt.k1.enqueue`` (K1's pixel ids, queue
and launch), and on every engine but the chunked ones ``rt.finalize``
(the epilogue) and ``rt.readback`` (the frame's copy to the host); a
sharded render records only ``rt.pack``, ``rt.pack.textures``,
``rt.pack.upload`` and ``rt.finalize``.  ``--device cuda`` (the default)
renders on the card -- the engines' CUDA kernels (K1 for ``mega2``, K5 for ``mega``,
K6 for ``wavefront_pallas``) and plain PyTorch around them and for the
other engines (``wavefront``, ``bruteforce`` and the BVH engines ``bvh``
and ``wavefront_bvh``) -- and raises when there is no CUDA device;
``--device cpu`` renders with the plain PyTorch versions.

``--sharded`` renders over the ranks of ``torch.distributed.run``
(`parallel/render.render_sharded`: a (px, sp) mesh of the world, NCCL
and one card a rank on ``cuda``, gloo on ``cpu``); every rank renders its
shard and gets the frame, the first writes the files.  Without the
launcher's environment it is the one-rank mesh.

Usage:
    python -m raytracinginoneweekendincuda_torch.utils.cli \
        --scene 4 --width 240 --height 135 --spp 10 --out out.ppm
    python -m torch.distributed.run --nproc_per_node 2 \
        -m raytracinginoneweekendincuda_torch.utils.cli --sharded \
        --scene 4 --width 240 --height 135 --spp 10 --out out.ppm
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from ..ops.render import ENGINES

F64_ENGINES = ("bruteforce", "bvh", "wavefront", "wavefront_bvh")


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
    p.add_argument("--engine", default="mega2", choices=ENGINES,
                   help="render engine: mega2 (kernel K1), mega (K5; noise "
                        "and image scenes fall back to wavefront_pallas), "
                        "wavefront_pallas (K6), wavefront, wavefront_bvh, "
                        "bruteforce and bvh (plain PyTorch)")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32",
                   help="scene / engine dtype; float64 for the plain "
                        "PyTorch engines (bruteforce, bvh, wavefront, "
                        "wavefront_bvh; the kernels are f32)")
    p.add_argument("--rays-per-batch", type=int, default=None,
                   help="pixel chunk (bruteforce, bvh) or ray-pool size "
                        "(the wavefront engines; mega caps it at 8192); "
                        "mega2 renders the whole frame in one launch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the CUDA kernel (raises without a card); "
                        "cpu: the plain PyTorch version")
    p.add_argument("--sharded", action="store_true",
                   help="render over the ranks of torch.distributed.run "
                        "(parallel/render.render_sharded; not engine mega)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render "
                        "into DIR (render.trace.json; a rank's own file "
                        "under --sharded)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..core.image import write_png, write_ppm
    from ..models.scenes import SCENE_NAMES, build_scene
    from ..scene.compiler import compile_scene
    from ..utils import tracing
    from ..utils.config import RenderConfig, reference_samples_for_scene
    from ..ops.render import render, resolve_device

    if args.sharded:
        from ..parallel import distributed

        distributed.initialize(device=args.device)
        dev = resolve_device(distributed.rank_device(args.device))
    else:
        dev = resolve_device(args.device)
    spp = args.spp if args.spp is not None \
        else reference_samples_for_scene(args.scene)
    cfg = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=spp,
        max_bounces=args.max_bounces, seed=args.seed, engine=args.engine,
        dtype=args.dtype)
    if args.rays_per_batch is not None:
        cfg = cfg.with_(rays_per_batch=args.rays_per_batch)
    if args.dtype == "float64" and args.engine not in F64_ENGINES:
        raise SystemExit(f"--dtype float64 needs engine "
                         f"{', '.join(F64_ENGINES)}, not {args.engine}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"Rendering scene {args.scene} ({SCENE_NAMES[args.scene]}): "
          f"{cfg.width}x{cfg.height}, {spp} spp, engine={args.engine}, "
          f"device={dev} ({name})", file=sys.stderr)

    scene, meta = compile_scene(build_scene(args.scene), cfg.width,
                                cfg.height, dtype=np.dtype(args.dtype))
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
        tracing.reset()
    t0 = time.perf_counter()
    with prof:
        if args.sharded:
            from ..parallel.render import make_mesh, render_sharded

            mesh = make_mesh(device=dev)
            print(f"sharded: {mesh}", file=sys.stderr)
            img = render_sharded(scene, meta, cfg, mesh, device=dev,
                                 out_u8=True)
        else:
            img = render(scene, meta, cfg, device=dev, out_u8=True)
    dt = time.perf_counter() - t0
    if args.profile:
        import torch.distributed as dist

        os.makedirs(args.profile, exist_ok=True)
        name = (f"render.rank{dist.get_rank()}.trace.json"
                if dist.is_initialized() else "render.trace.json")
        path = os.path.join(args.profile, name)
        prof.export_chrome_trace(path)
        print(f"profile trace written to {path}", file=sys.stderr)
        print(f"counters: {tracing.counters()}", file=sys.stderr)
    rays = cfg.width * cfg.height * spp
    print(f"took {dt:.3f} s  ({rays / dt / 1e6:.2f} M primary rays/s, "
          f"including table packing and the first-use kernel build)",
          file=sys.stderr)
    if args.sharded:
        import torch.distributed as dist

        primary = distributed.is_primary()
        if dist.is_initialized():
            dist.destroy_process_group()
        if not primary:
            return 0
    write_ppm(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)
    if args.png:
        write_png(args.png, img)
        print(f"wrote {args.png}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
