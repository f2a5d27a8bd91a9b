"""K1's walk of the sphere tree, emulated in numpy, and its counts:

    python -m raytracinginoneweekendincuda_torch.tools.tree_walk \
        [--stride S] [--samples N] [--leaf L]

`walk` runs ``sphere_walk`` (``csrc/mega2_bounce.cuh``) for a batch of rays
in f32, op for op: the oversized prefix rows in row order, then the tree
depth first, each ray alone, with the kernel's skip rule (a child whose box
its ray cannot meet within (t_min, best], best in key space), its order
(the nearer of two children first) and its tie rule (an equal key goes to
the lower row).  The rays advance in lockstep, one node a step, as a
warp's lanes do.  It gives each ray's closest sphere (key, row) and its box
and sphere tests.

`main` counts those tests on the benchmark cells' worlds (``book1_final``
at 1200x675 and scene 0 at 1440x720): every S-th pixel id (default 211) at
samples 0 .. N-1 (default 2), every bounce of those paths (the plain
version's rays, 50 bounces), and prints one JSON line a world: box and
sphere tests a lane-bounce, their sum, the worst sum of 32 consecutive
rays (a warp pays about its worst lane) averaged over the groups, and the
rays whose winner differs from the loop over every row
(``ops/mega2._closest_spheres``).  Counts, not times: the same on any
machine.  ``--leaf`` builds the tree with L rows a leaf instead of the
packer's ``TREE_LEAF``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import scenes
from ..ops import mega2
from ..ops.raygen import generate_rays
from ..scene.compiler import compile_scene
from ..utils.config import RenderConfig

F32 = np.float32
WORLDS = {"book1_final": (scenes.book1_final, 1200, 675),
          "bouncing_spheres": (lambda: scenes.build_scene(0), 1440, 720)}


def _sphere_rows(sph, rows, o, d, tm, a, akey, best, win, tied: bool):
    """``sphere_row`` of rows ``rows`` [M] against rays [M]: updates
    ``best`` / ``win`` [M] in place."""
    r = sph[rows]
    frac = (tm - r[:, 6]) * r[:, 7]
    cx = r[:, 0] + frac * r[:, 3]
    cy = r[:, 1] + frac * r[:, 4]
    cz = r[:, 2] + frac * r[:, 5]
    ocx, ocy, ocz = o[:, 0] - cx, o[:, 1] - cy, o[:, 2] - cz
    b = ocx * d[:, 0] + ocy * d[:, 1] + ocz * d[:, 2]
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r[:, 10]
    disc = b * b - a * cc
    with np.errstate(invalid="ignore"):
        sq = np.sqrt(disc)
    k1 = -b - sq
    key = np.where(k1 > akey, k1, -b + sq)
    take = key < best
    if tied:
        take |= (key == best) & (rows < win)
    take &= (r[:, 9] > 0.5) & (disc > 0.0) & (key > akey)
    best[take] = key[take]
    win[take] = rows[take]


def _entry(nodes, o, inv, t_min, a):
    """``node_entry`` of one node a ray (nodes [M, 8], rays [M]): the key
    where the ray enters the box, inf where it cannot meet it."""
    ta = (nodes[:, 0:3] - o) * inv
    tb = (nodes[:, 3:6] - o) * inv
    lo = np.minimum(ta, tb)
    hi = np.maximum(ta, tb)
    near = np.maximum(np.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    far = np.minimum(np.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return np.where(far >= np.maximum(near, t_min), near * a, F32(np.inf))


def walk(tab: mega2.Mega2Tables, o, d, tm, t_min: float) -> dict:
    """The kernel's closest sphere for rays o, d [N, 3], tm [N] (f32) over
    the tables' tree: key [N] (BIG: none), row [N] (-1: none), and the box
    and sphere tests of each ray (the oversized prefix's rows counted)."""
    sph = tab.sph.cpu().numpy()
    tree = tab.tree.cpu().numpy()
    o, d, tm = (np.asarray(x, F32) for x in (o, d, tm))
    t_min = F32(t_min)
    N = o.shape[0]
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    akey = t_min * a
    best = np.full(N, F32(mega2.BIG), F32)
    win = np.full(N, -1, np.int64)
    for k in range(tab.tree_p0):
        _sphere_rows(sph, np.full(N, k), o, d, tm, a, akey, best, win, False)
    tiny = F32(mega2.TINY)
    inv = F32(1.0) / np.where(d >= 0.0, np.maximum(d, tiny),
                              np.minimum(d, -tiny))
    n = tab.tree_n
    node = np.ones(N, np.int64)
    trail = np.zeros(N, np.int64)
    boxes = np.zeros(N, np.int64)
    spheres = np.full(N, tab.tree_p0, np.int64)
    live = np.arange(N) if n else np.arange(0)
    if live.size:
        boxes += 1
        live = live[_entry(tree[node], o, inv, t_min, a) <= best]
    while live.size:
        nd = node[live]
        inner = live[nd < n]
        c = 2 * node[inner]
        oi, ii, ai = o[inner], inv[inner], a[inner]
        ea = _entry(tree[c], oi, ii, t_min, ai)
        eb = _entry(tree[c + 1], oi, ii, t_min, ai)
        boxes[inner] += 2
        ha, hb = ea <= best[inner], eb <= best[inner]
        both = ha & hb
        node[inner[both]] = np.where(eb < ea, c + 1, c)[both]
        trail[inner[both]] = trail[inner[both]] << 1 | 1
        one = ha ^ hb
        node[inner[one]] = np.where(ha, c, c + 1)[one]
        trail[inner[one]] <<= 1
        lf = live[nd >= n]
        first = tree[node[lf], 6].astype(np.int64)
        cnt = tree[node[lf], 7].astype(np.int64)
        spheres[lf] += cnt
        for j in range(int(cnt.max()) if lf.size else 0):
            s = j < cnt
            i = lf[s]
            bi, wi = best[i], win[i]
            _sphere_rows(sph, first[s] + j, o[i], d[i], tm[i], a[i], akey[i],
                         bi, wi, True)
            best[i], win[i] = bi, wi
        # back up to the nearest sibling still to visit
        up = np.concatenate([inner[~(ha | hb)], lf])
        go = up[trail[up] != 0]
        t = trail[go]
        s = np.log2(t & -t).astype(np.int64)
        node[go] = (node[go] >> s) ^ 1
        trail[go] = (t >> s) ^ 1
        live = np.sort(np.concatenate([inner[ha | hb], go]))
    return {"key": best, "row": win, "boxes": boxes, "spheres": spheres}


def brute_force(tab: mega2.Mega2Tables, o, d, tm, t_min: float):
    """The loop over every sphere row (the plain version's
    ``_closest_spheres``): (key [N], row [N]) as numpy."""
    o, d, tm = (torch.as_tensor(np.asarray(x, F32)) for x in (o, d, tm))
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    best, win = mega2._closest_spheres(tab, o, d, tm, a, t_min * a, t_min,
                                       256, None, None)
    return best.numpy(), win.numpy()


def path_rays(tab, fp, pix: torch.Tensor) -> list:
    """The rays of every bounce of the plain version's paths from pixel ids
    ``pix`` at samples ``fp.samp0 .. + fp.spp``: [(o, d, tm)] a bounce,
    live rays only, each bounce's in (sample, pixel) order."""
    out = []
    for s in range(fp.samp0, fp.samp0 + fp.spp):
        o, d, tm, pc = generate_rays(fp.cam, pix, s, fp.width, fp.height,
                                     fp.seed)
        samp = torch.full_like(pc, s)
        thr, acc = torch.ones_like(o), torch.zeros_like(o)
        for b in range(fp.max_bounces):
            while len(out) <= b:
                out.append([])
            out[b].append((o, d, tm))
            o, d, thr, acc, alive, _ = mega2._bounce(
                tab, fp, o, d, tm, thr, acc, pc, samp, b, 256)
            keep = alive.nonzero()[:, 0]
            if keep.numel() == 0 or b + 1 >= fp.max_bounces:
                break
            o, d, tm, thr, acc = o[keep], d[keep], tm[keep], thr[keep], \
                acc[keep]
            pc, samp = pc[keep], samp[keep]
    return [tuple(torch.cat(x).numpy() for x in zip(*bnc)) for bnc in out]


def with_leaf(tab: mega2.Mega2Tables, leaf: int) -> mega2.Mega2Tables:
    """The tables with their tree rebuilt at ``leaf`` rows a leaf."""
    ns = int((tab.sph[:, 9] > 0.5).sum())
    nodes, n = mega2.sphere_tree(tab.sph.double().cpu().numpy(),
                                 tab.tree_p0, ns, leaf)
    return tab._replace(tree=torch.as_tensor(nodes, device=tab.sph.device),
                        tree_n=n)


def walk_tests(tab: mega2.Mega2Tables, fp: mega2.FrameParams,
               pix: torch.Tensor) -> dict:
    """The walk's tests on every bounce of the paths from pixel ids ``pix``
    (CPU tables and ids): box and sphere tests a lane-bounce, their sum,
    the worst sum of 32 consecutive rays averaged over the groups, and the
    rays whose winner differs from the loop over every row."""
    tot = {"boxes": 0, "spheres": 0, "worst32": 0.0, "groups": 0,
           "rays": 0, "differ": 0}
    for o, d, tm in path_rays(tab, fp, pix):
        w = walk(tab, o, d, tm, fp.t_min)
        _, row = brute_force(tab, o, d, tm, fp.t_min)
        lane = w["boxes"] + w["spheres"]
        g = -(-lane.size // 32)
        pad = np.concatenate([lane, np.zeros(32 * g - lane.size, lane.dtype)])
        tot["boxes"] += int(w["boxes"].sum())
        tot["spheres"] += int(w["spheres"].sum())
        tot["worst32"] += float(pad.reshape(g, 32).max(1).sum())
        tot["groups"] += g
        tot["rays"] += lane.size
        tot["differ"] += int((w["row"] != row).sum())
    n = max(tot["rays"], 1)
    return {"lane_bounces": tot["rays"], "box_tests": tot["boxes"] / n,
            "sphere_tests": tot["spheres"] / n,
            "lane_tests": (tot["boxes"] + tot["spheres"]) / n,
            "worst_of_32": tot["worst32"] / max(tot["groups"], 1),
            "winners_differing": tot["differ"]}


def counts(world: str, stride: int, samples: int, leaf=None) -> dict:
    """`walk_tests` on a benchmark cell's world (`WORLDS`): every
    ``stride``-th pixel id at samples 0 .. ``samples`` - 1, 50 bounces;
    ``leaf`` rebuilds the tree with that many rows a leaf."""
    make, W, H = WORLDS[world]
    scene, meta = compile_scene(make(), W, H, dtype=np.float32)
    tab = mega2.pack_mega2_tables(scene, meta, "cpu")
    if leaf is not None:
        tab = with_leaf(tab, leaf)
    fp = mega2.frame_params(scene, RenderConfig(
        width=W, height=H, samples_per_pixel=samples, max_bounces=50))
    pix = torch.arange(0, W * H, stride, dtype=torch.int32)
    return {"world": world, "leaf": leaf or mega2.TREE_LEAF,
            "tree_leaves": tab.tree_n, "sphere_rows": tab.s_pad,
            **walk_tests(tab, fp, pix)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stride", type=int, default=211)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--leaf", type=int, default=None)
    args = ap.parse_args(argv)
    out = []
    for world in WORLDS:
        rec = counts(world, args.stride, args.samples, args.leaf)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
