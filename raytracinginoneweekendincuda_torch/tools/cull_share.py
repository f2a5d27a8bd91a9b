"""How much of the closest hit the chunk cull leaves, counted by the plain
version:

    python -m raytracinginoneweekendincuda_torch.tools.cull_share \
        [--spheres N] [--stride S] [--device cpu]

Renders every S-th pixel id (default 3600: 288 ids) of the large world
``models/scenes.sphere_field(N)`` (default 10,000 spheres) at the main
path's frame, 1440x720@10 with 50 bounces, through
``ops/mega2.render_radiance_plain`` with the cull engaged, and prints one
JSON line: per lane-bounce, the chunk slab tests, the chunks they let
through and those chunks' rows, beside the rows a bounce without the cull
tests.  These are counts, not times, and the same on any device; the run
takes the card unless given ``--device cpu``.  ``chip_smoke.py``'s
large-world phase takes its counts, and the plain sums it holds K1
against, from `count`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.scenes import sphere_field
from ..ops import mega2
from ..ops.render import resolve_device
from ..scene.compiler import compile_scene
from ..utils.config import RenderConfig

FRAME = (1440, 720, 10, 50)      # width, height, spp, max_bounces


def per_bounce(stats: dict, tab: mega2.Mega2Tables) -> dict:
    """`mega2.cull_stats` counts per lane-bounce: slab tests, visited
    chunks, visited rows by kind; beside them the rows of an unculled
    bounce and the share of the slab tests that let a chunk through."""
    lb = max(stats["bounces"], 1)
    out = {k: stats[k] / lb for k in ("tests", "chunks", "sphere_rows",
                                      "quad_rows", "box_rows")}
    out["rows_unculled"] = tab.s_pad + tab.nl_pad + tab.b_pad
    out["chunk_share"] = stats["chunks"] / max(stats["tests"], 1)
    return out


def count(tab: mega2.Mega2Tables, fp: mega2.FrameParams,
          ids: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The plain version's radiance sums of pixel ids ``ids`` and the
    cull's counts of that run (`mega2.cull_stats`), with ``per_bounce``."""
    stats = mega2.cull_stats()
    sums = mega2.render_radiance_plain(tab, ids, fp, stats=stats)
    return sums, {**stats, "per_bounce": per_bounce(stats, tab)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spheres", type=int, default=10_000)
    ap.add_argument("--stride", type=int, default=3600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h, spp, mb = FRAME
    scene, meta = compile_scene(sphere_field(args.spheres), w, h,
                                dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_bounces=mb)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    if not (tab.cull_pairs or tab.cull_boxes):
        raise SystemExit(f"sphere_field({args.spheres}) does not engage the "
                         f"cull")
    pix = torch.arange(0, w * h, args.stride, dtype=torch.int32, device=dev)
    _, counts = count(tab, mega2.frame_params(scene, cfg), pix)
    res = {"spheres": args.spheres, "ids": int(pix.shape[0]),
           "device": str(dev), **counts}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
