"""North-star benchmark of the port (BASELINE.json): the Book-1 final
scene (``models/scenes.book1_final``) at 1200x675, 500 spp, one card.

The frame goes through ``ops/render.render`` (engine ``mega2``, kernel
K1): one warm-up frame, then the best of ``--repeats``, each ending in
``torch.cuda.synchronize()`` (the readback of the u8 frame).  Prints the
seconds and M primary rays/s beside the card's name and power limit, and
K1's bound for the frame (`tools/lane_share.k1_bound`): its lane-bounces
counted from K2's tapes of every pixel at the first `BOUND_SPP` (10)
samples and scaled to the frame's spp, each testing the node boxes and
spheres of K1's sphere-tree walk (`tools/tree_walk.walk_tests`, on the
CPU, every `WALK_STRIDE`-th pixel at 2 samples), over the H100's FP32
and memory rates.  Then one JSON line.  Needs a CUDA device.

    python -m raytracinginoneweekendincuda_torch.tools.bench_northstar \
        [--spp 500] [--repeats 2]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.scenes import book1_final
from ..ops import mega2
from ..ops.render import render, resolve_device
from ..scene.compiler import compile_scene
from ..utils.benchmark import BASELINE_RAYS_PER_S, device_line
from ..utils.config import RenderConfig
from .lane_share import k1_bound, path_counts
from .tree_walk import walk_tests

NORTH_STAR = (1200, 675, 500)   # width, height, spp (BASELINE.json)
BOUND_SPP = 10
WALK_STRIDE = 211


def north_star(device="cuda", *, spp: int = NORTH_STAR[2],
               repeats: int = 2, bound_spp: int = BOUND_SPP,
               width: int = NORTH_STAR[0],
               height: int = NORTH_STAR[1]) -> dict:
    """Times the north-star frame and reckons K1's bound for it, as the
    module says; returns the record it prints."""
    dev = resolve_device(device)
    card = device_line(dev)
    scene, meta = compile_scene(book1_final(), width, height,
                                dtype=np.float32)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       engine="mega2")

    def frame():
        img = render(scene, meta, cfg, device=dev, out_u8=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return img

    t0 = time.perf_counter()
    frame()                                           # warm-up (and build)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        img = frame()
        best = min(best, time.perf_counter() - t0)
    if img.shape != (height, width, 3) or not img.any():
        raise RuntimeError("north-star frame is empty or misshapen")
    rays = width * height * spp

    n_sub = min(bound_spp, spp)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg.with_(samples_per_pixel=n_sub))
    pix = torch.arange(width * height, dtype=torch.int32, device=dev)
    sub_lb = int(path_counts(tab, fp, pix).sum())
    lane_bounces = sub_lb * spp / n_sub
    walk = None
    if tab.tree_n:
        w = walk_tests(mega2.pack_mega2_tables(scene, meta, "cpu"),
                       fp._replace(spp=min(2, spp)),
                       torch.arange(0, width * height, WALK_STRIDE,
                                    dtype=torch.int32))
        walk = (w["box_tests"], w["sphere_tests"])
    b_ms, b_by = k1_bound(tab, width * height, lane_bounces, walk)
    rec = {
        "metric": f"primary rays/s, book1_final {width}x{height}@{spp}spp "
                  f"(mega2, render())",
        "value": rays / best, "unit": "rays/s",
        "vs_baseline": rays / best / BASELINE_RAYS_PER_S,
        "seconds": best, "repeats": repeats, "first_seconds": first,
        "lane_bounces": lane_bounces,
        "lane_bounces_counted_at_spp": n_sub,
        "walk_tests_per_lane_bounce": walk,
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_share": b_ms / (best * 1e3),
        "device": str(dev), "card": card,
    }
    print(f"book1_final {width}x{height}@{spp}: best of {repeats} "
          f"{best:.4f} s (first {first:.2f} s) = {rays / best / 1e6:.2f} M "
          f"primary rays/s on {card}", flush=True)
    print(f"K1 bound: {b_ms:.2f} ms ({b_by}), {b_ms / (best * 1e3):.4f} of "
          f"the frame; {lane_bounces:.4g} lane-bounces, counted from K2's "
          f"tapes at samples 0-{n_sub - 1} ({sub_lb}) and scaled by "
          f"{spp}/{n_sub}", flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=NORTH_STAR[2])
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    rec = north_star("cuda", spp=args.spp, repeats=args.repeats)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
