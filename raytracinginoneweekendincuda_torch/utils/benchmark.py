"""Headline benchmark of the port: scene 0 (bouncing spheres) at the
reference's measured config, 1440x720 at 10 spp (BASELINE.md); with
``--all``, every configuration the reference measured (`REFERENCE_TABLE`).

One warm-up frame, then the best of ``--repeats`` frames, each ending in
``torch.cuda.synchronize()`` -- device completion, the same boundary as
the reference's clock (kernel.cu:675-693).  ``--engine mega2`` (the
default) times the frame's kernel launch and the average/gamma/quantize
epilogue, with table packing outside the clock; the other engines
(``mega``, ``wavefront_pallas``, ``wavefront``, ``wavefront_bvh``,
``bruteforce``, ``bvh``) time the whole ``ops/render.render`` call: packing, the frame loop with its host
syncs, the epilogue and the readback.  Prints ONE JSON line with rays/s,
the ratio to the reference's 22 M rays/s (``vs_baseline``) and the card's
name.  ``--all`` runs the table's rows in this process, prints a line a
row and writes a Markdown table (``--out``, default ``BENCHMARKS_TORCH.md``
at the repository's root), which it also prints.  Needs a CUDA device.

    python -m raytracinginoneweekendincuda_torch.utils.benchmark \
        [--all [--out PATH]] [--engine mega2] [--repeats 3]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..ops.render import ENGINES

BASELINE_RAYS_PER_S = 22.0e6  # RTX 5070 Ti anchor, BASELINE.md

# (scene, spp, reference seconds on RTX 5070 Ti at 1440x720) -- BASELINE.md
REFERENCE_TABLE = [
    (0, 10, 0.47),    # bouncing spheres, with BVH
    (4, 10, 0.27),    # quads
    (7, 200, 33.0),   # cornell box with boxes
    (9, 100, 256.0),  # final scene (Debug build)
]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TABLE_OUT = os.path.join(ROOT, "BENCHMARKS_TORCH.md")


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


def device_line(dev) -> str:
    """``card_line()`` on the card; on the CPU, what ran there."""
    if dev.type == "cuda":
        return card_line()
    return "cpu (plain PyTorch versions; host times)"


def frame_seconds(scene_id: int, width: int, height: int, spp: int,
                  engine: str, repeats: int, dev) -> float:
    """Best of ``repeats`` frames after one warm-up frame (which builds
    the kernels), as the module says."""
    import numpy as np
    import torch

    from ..models.scenes import build_scene
    from ..scene.compiler import compile_scene
    from ..utils.config import RenderConfig
    from ..ops.mega2 import frame_params, pack_mega2_tables, render_mega2
    from ..ops.render import finalize, render

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       engine=engine)
    scene, meta = compile_scene(build_scene(scene_id), cfg.width,
                                cfg.height, dtype=np.float32)
    if engine == "mega2":
        tab = pack_mega2_tables(scene, meta, dev)
        fp = frame_params(scene, cfg)

        def frame():
            fb = finalize(render_mega2(tab, fp), cfg.samples_per_pixel,
                          gamma=True, out_u8=True)
            sync()
            return fb
    else:
        def frame():
            img = render(scene, meta, cfg, device=dev, out_u8=True)
            sync()
            return img

    frame()                                           # warm-up (and build)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        img = frame()
        best = min(best, time.perf_counter() - t0)
    if not bool(img.any()):
        raise RuntimeError(f"scene {scene_id}: benchmark frame is all zero")
    return best


def run_all(engine: str = "mega2", repeats: int = 3, out: str = TABLE_OUT,
            device="cuda", *, width: int = 1440, height: int = 720,
            rows=REFERENCE_TABLE) -> list:
    """Times every row of ``rows`` (default `REFERENCE_TABLE`) at
    width x height in this process, prints a line a row, writes the
    Markdown table to ``out`` and prints it.  Returns [(scene, name, spp,
    seconds, reference seconds)]."""
    from ..models.scenes import SCENE_NAMES
    from ..ops.render import resolve_device

    dev = resolve_device(device)
    card = device_line(dev)
    res = []
    for sid, spp, ref_s in rows:
        best = frame_seconds(sid, width, height, spp, engine, repeats, dev)
        res.append((sid, SCENE_NAMES[sid], spp, best, ref_s))
        print(f"scene {sid} ({SCENE_NAMES[sid]}) {width}x{height}@{spp}: "
              f"{best:.4f} s vs reference {ref_s:.2f} s "
              f"({ref_s / best:.1f}x) on {card}", flush=True)
    lines = [
        "# Measured benchmarks of the PyTorch / CUDA port", "",
        f"Engine `{engine}`, {width}x{height}, best of {repeats} after a "
        f"warm-up frame, on {card} "
        f"(`python -m raytracinginoneweekendincuda_torch.utils.benchmark "
        f"--all`). Reference: the RTX 5070 Ti's published seconds "
        f"(`BASELINE.md`; mostly Debug builds).", "",
        "| Scene | spp | this port (s) | reference (s) | ratio |",
        "|---|---|---|---|---|",
        *(f"| {sid} {name} | {spp} | {best:.4f} | {ref_s:.2f} | "
          f"{ref_s / best:.1f}x |" for sid, name, spp, best, ref_s in res)]
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    print(f"wrote {out}", file=sys.stderr)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", type=int, default=0)
    p.add_argument("--width", type=int, default=1440)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--engine", default="mega2", choices=ENGINES)
    p.add_argument("--all", action="store_true",
                   help="time every row of REFERENCE_TABLE -> --out")
    p.add_argument("--out", default=TABLE_OUT,
                   help="the --all table (default BENCHMARKS_TORCH.md at "
                        "the repository's root)")
    args = p.parse_args(argv)

    import torch

    from ..ops.render import resolve_device

    dev = resolve_device("cuda")
    if args.all:
        run_all(args.engine, args.repeats, args.out, dev,
                width=args.width, height=args.height)
        return 0
    best = frame_seconds(args.scene, args.width, args.height, args.spp,
                         args.engine, args.repeats, dev)
    rays = args.width * args.height * args.spp
    print(json.dumps({
        "metric": f"primary rays/s, scene {args.scene} "
                  f"{args.width}x{args.height}@{args.spp}spp "
                  f"({args.engine})",
        "value": rays / best,
        "unit": "rays/s",
        "vs_baseline": rays / best / BASELINE_RAYS_PER_S,
        "seconds": best,
        "device": torch.cuda.get_device_name(dev),
        "card": card_line(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
