"""How much of K1's lane time does useful work, from winner tapes.

A K2 lane-bounce (and a K1 one where the world has no sphere tree) tests
every sphere, loose quad and box row whether it hits or not, so a
lane-bounce costs about the same on every lane and a warp takes as many
iterations as its busiest lane.  ``path_bounces``
counts the bounces each (pixel, sample) path ran from its winner tape
(``ops/mega2.trace_tapes``); ``lane_shares`` turns those counts into the
share of lane slots that do useful work under two loop shapes, a warp
being 32 consecutive pixel ids:

- ``nested``: a sample loop around a bounce loop (K1 before its flat
  loop): for each sample the warp runs its longest path of that sample;
- ``flat``: one loop over a lane's whole pixel (all samples), no refill:
  the warp runs its longest pixel.

A lane refilled from a pixel queue idles only in the frame's tail, so its
share is close to 1 on any frame that fills the card several times.

The same counts give K1's bound for a frame (`k1_bound`): its
lane-bounces (`path_counts`, from K2's tapes of the frame's lanes) times
the FP32 operations a lane-bounce does over the scene's rows; in a world
with a sphere tree, over the node boxes and spheres its walk tests
(`tools/tree_walk.walk_tests`) in place of every sphere row.

K2's tapes are sample-major (``ops/mega2.tape_lanes``: lane ``s*P + p``),
so one thread a lane -- K2 without a lane queue -- keeps the ``nested``
share of its thread slots busy (`trace_shares`).  From the command line,
the shares of the tapes of a trace at the training step's shape
(``STEP``: scene 0, 640x360, spp 8, K 8), on the card unless given
``--device cpu`` (the plain version; ``--row-stride R`` traces every R-th
row of pixels, whole rows, to keep a CPU run small):

    python -m raytracinginoneweekendincuda_torch.tools.lane_share \
        [--row-stride 1] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.scenes import build_scene
from ..ops import mega2
from ..ops.render import resolve_device
from ..scene.compiler import compile_scene
from ..utils.config import RenderConfig
from .common import bound, nbytes

WARP = 32
STEP = (0, 640, 360, 8, 8)   # the training step: scene, w, h, spp, K
_LIGHT = 3.0       # MAT_DIFFUSE_LIGHT, attr column 10
TAPE_CHUNK = 1440 * 72    # pixels a K2 trace when counting a frame's paths
# FP32 operations (each add, multiply, compare, divide, sqrt one op) per
# row test, counted from csrc/mega2_bounce.cuh: a sphere row (moving
# centre, quadratic, discriminant) 26, a loose quad row 16, a box slab row
# 36, a medium 40, and the rest of a bounce (record, emission, scatter,
# RNG) 100.
OPS_SPHERE, OPS_QUAD, OPS_BOX, OPS_MEDIUM, OPS_BOUNCE = 26, 16, 36, 40, 100
OPS_NODE = 28       # the slab test of a sphere-tree node's box


def path_bounces(tape: torch.Tensor, attr: torch.Tensor,
                 np_rows: int) -> torch.Tensor:
    """Bounces each lane's path ran [L] int64, from a winner tape [K, L]
    (kernel rows; -1 for a miss and after the path ended; medium m is
    ``np_rows + m``) and the attribute table: every hit, plus the miss
    that ended a path before K (a path's first -1 that does not follow a
    light).  A metal ray absorbed by its own surface ends the same way and
    is counted one bounce too many."""
    K = tape.shape[0]
    hit = tape >= 0
    first = torch.where(hit.all(0), K, (~hit).to(torch.int32).argmax(0))
    prev = tape.gather(0, (first - 1).clamp_min(0)[None].long())[0]
    geo = (prev >= 0) & (prev < np_rows)
    light = geo & (attr[prev.clamp(0, np_rows - 1).long(), 10] == _LIGHT)
    ended_by_miss = (first < K) & ((first == 0) | ~light)
    return hit.sum(0) + ended_by_miss.long()


def lane_shares(counts: torch.Tensor, warp: int = WARP) -> dict:
    """Useful share of lane slots for bounce counts [spp, P] (sample s of
    pixel p, pixels in launch order): ``nested`` and ``flat`` as the
    module says, and the mean path length.  A partial last warp has its
    missing lanes idle."""
    spp, P = counts.shape
    c = counts.to(torch.int64)
    pad = -P % warp
    if pad:
        c = torch.cat([c, c.new_zeros((spp, pad))], dim=1)
    w = c.reshape(spp, -1, warp)
    useful = int(c.sum())
    nested = warp * int(w.max(-1).values.sum())
    flat = warp * int(w.sum(0).max(-1).values.sum())
    return {"mean_path": useful / max(spp * P, 1),
            "nested": useful / max(nested, 1),
            "flat": useful / max(flat, 1)}


def trace_shares(tape: torch.Tensor, attr: torch.Tensor, np_rows: int,
                 spp: int, warp: int = WARP) -> dict:
    """`lane_shares` of a sample-major trace tape [K, spp * P] (lane
    ``s*P + p`` is pixel p's sample s)."""
    counts = path_bounces(tape, attr, np_rows).reshape(spp, -1)
    return lane_shares(counts, warp)


def table_bytes(tab) -> int:
    """Bytes of K1's / K2's scene tables."""
    return nbytes(tab.sph, tab.quad, tab.attr, tab.med, tab.perm, tab.vec,
                  tab.texels, tab.img_dims)


def pair_ops(tab) -> int:
    """FP32 ops of one K1 / K2 bounce over this scene's rows."""
    n_sph = int((tab.sph[:, 9] > 0.5).sum())
    n_quad = int((tab.quad[:tab.nl_pad, 12] > 0.5).sum())
    n_box = int((tab.quad[tab.q_pad:, 7] > 0.5).sum()) if tab.b_pad else 0
    return (n_sph * OPS_SPHERE + n_quad * OPS_QUAD + n_box * OPS_BOX
            + tab.n_media * OPS_MEDIUM + OPS_BOUNCE)


def path_counts(tab, fp, pix: torch.Tensor,
                chunk: int = TAPE_CHUNK) -> torch.Tensor:
    """Bounces each (sample, pixel) path of the frame ran [spp, P], from
    K2's tapes (the plain version on the CPU) of the same lanes at the
    same depth, ``chunk`` pixels (all their samples) a trace."""
    counts = torch.empty((fp.spp, pix.shape[0]), dtype=torch.int32,
                         device=pix.device)
    for a in range(0, pix.shape[0], chunk):
        part = pix[a:a + chunk]
        lane_pix, lane_samp = mega2.tape_lanes(part, fp.spp)
        tape = mega2.trace_tapes(tab, lane_pix, lane_samp, fp)
        counts[:, a:a + part.shape[0]] = path_bounces(
            tape, tab.attr, tab.np_rows).reshape(fp.spp, -1)
    return counts


def k1_bound(tab, n_ids: int, lane_bounces: float, walk=None):
    """(bound_ms, bound_by) of a K1 launch over ``n_ids`` pixel ids that
    runs ``lane_bounces`` lane-bounces: the tables and ids read, the sums
    written, each lane-bounce's tests of every row.  ``walk`` (box tests,
    sphere tests) a lane-bounce of the sphere tree's walk replaces the
    tests of every sphere row (a world whose tables have a tree)."""
    ops = pair_ops(tab)
    if walk is not None:
        ops += walk[0] * OPS_NODE + (walk[1] - int(
            (tab.sph[:, 9] > 0.5).sum())) * OPS_SPHERE
    return bound(table_bytes(tab) + nbytes(tab.tree) + n_ids * (4 + 12),
                 lane_bounces * ops)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--row-stride", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sid, w, h, spp, K = STEP
    scene, meta = compile_scene(build_scene(sid), w, h, dtype=np.float32)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, RenderConfig(
        width=w, height=h, samples_per_pixel=1, max_bounces=K))
    rows = torch.arange(0, h, args.row_stride, device=dev)
    pix = (rows[:, None] * w + torch.arange(w, device=dev)).reshape(-1)
    lane_pix, lane_samp = mega2.tape_lanes(pix, spp)
    tape = mega2.trace_tapes(tab, lane_pix, lane_samp, fp)
    res = {"scene": sid, "frame": [w, h, spp, K],
           "rows": int(rows.shape[0]), "lanes": int(lane_pix.shape[0]),
           "device": str(dev),
           **trace_shares(tape, tab.attr, tab.np_rows, spp)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
