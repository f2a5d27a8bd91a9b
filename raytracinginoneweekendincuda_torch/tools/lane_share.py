"""How much of K1's lane time does useful work, from winner tapes.

Every K1 lane-bounce tests every sphere, loose quad and box row whether it
hits or not, so a lane-bounce costs about the same on every lane and a
warp takes as many iterations as its busiest lane.  ``path_bounces``
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
"""

from __future__ import annotations

import torch

WARP = 32
_LIGHT = 3.0       # MAT_DIFFUSE_LIGHT, attr column 10


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
