"""Closed-loop frames of a Book 2 world: `render_loop`'s client (its
set-up, window and end-to-end metrics), held to the Book 2 reference
(`reference/book2/`) and counted on the reference's BVH over the world's
hittables (`reference/book2/bvh.py`).

Traffic keys as `render_loop`'s.  A frame counts as failed where the
port's compiled scene has an image texture without image data (its file
could not be decoded, so the port renders its debug colour in its
place): such a run is not correct.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from rtbench.check import Reading
from rtbench.drivers import render_loop
from rtbench.drivers.render_loop import WALK_CHUNK, frame_seed, ratio
from rtbench.reference.book2 import bvh, tracer
from rtbench.reference.tracer import to_u8

NOISE_TABLE_BYTES = 256 * (3 + 3) * 4   # three permutations, gradients f32


class Driver(render_loop.Driver):
    def __init__(self, cell, seed: int, device, traced: bool):
        super().__init__(cell, seed, device, traced)
        self.sample = Sample(cell, seed, self.dev)
        self.image_missing = self.meta.has_image and self.meta.n_images == 0

    def window(self, seconds: float) -> float:
        t0 = super().window(seconds)
        q = np.percentile(self.lat, [0, 25, 50, 75, 100])
        print("rtbench: frame latency min / quartiles / max (s): "
              + " ".join(f"{x:.4f}" for x in q), file=sys.stderr)
        if self.image_missing:
            print("rtbench: the scene's image texture has no image data "
                  "(its file could not be decoded): every frame failed",
                  file=sys.stderr)
            self.failed = self.attempted
        return t0

    def count(self, ref_world) -> dict:
        """The traced run's counts: frames; K1's lane-bounces a frame by
        the reference's own path counter, scaled to the frame; the tests a
        lane-bounce of the reference's BVH walk (box, sphere, quad and
        medium tests, instance entries) on every lane-bounce of those
        paths, each mean with its standard error over it; and the world's
        sizes that the roofline's bytes take."""
        lc = self.cell.traffic["lane_count"]
        n_s = min(lc["samples"], self.spp)
        fr = tracer.Frame(ref_world, self.W, self.H,
                          self.cell.config["max_bounces"], self.dev)
        ids = torch.arange(0, self.W * self.H, lc["stride"], device=self.dev)
        rays = []

        def visit(lanes, o, d, tm, pix_ctr, samp, bounce):
            rays.append((lanes, o, d, tm, pix_ctr, samp,
                         torch.full_like(pix_ctr, bounce)))
        _, nb = tracer.radiance(fr, ids, [frame_seed(self.seed, 1)], n_s,
                                visit=visit)
        lb = float(nb.sum()) * (self.W * self.H / ids.shape[0]) \
            * (self.spp / n_s)
        t = time.perf_counter()
        tree = bvh.build(ref_world, self.dev)
        lane, o, d, tm, pix_ctr, samp, bounce = (torch.cat(x)
                                                 for x in zip(*rays))
        # per lane: its lane-bounces, then its tests by bvh.COUNTS
        per = torch.zeros((6, ids.shape[0] * n_s), dtype=torch.float64,
                          device=self.dev)
        for c in range(0, lane.shape[0], WALK_CHUNK):
            s = slice(c, c + WALK_CHUNK)
            tests, _, _ = bvh.walk(tree, fr, o[s], d[s], tm[s], pix_ctr[s],
                                   samp[s], bounce[s])
            per[0].index_add_(0, lane[s], torch.ones_like(
                lane[s], dtype=torch.float64))
            per[1:].index_add_(1, lane[s], tests.double())
        tab = fr.tab
        out = {"frames": len(self.ends), "lane_bounces_per_frame": lb,
               "pixels": self.W * self.H, "spheres": tab.s_c0.shape[0],
               "quads": tab.rows - tab.s_c0.shape[0],
               "media": len(tab.media), "ref_bvh_nodes": tree.kind.shape[0],
               "texture_bytes": sum(im.numel() for im in tab.images)
               + NOISE_TABLE_BYTES * len(tab.perlin)}
        for k, what in enumerate(bvh.COUNTS, 1):
            mean, rel_se = ratio(per[k], per[0])
            out[f"ref_{what}_per_lane_bounce"] = mean
            out[f"ref_{what}_rel_se"] = rel_se
        out["ref_walk_s"] = time.perf_counter() - t
        return out


class Sample(render_loop.Sample):
    """`render_loop.Sample`'s pixels and frames, compared with the Book 2
    reference."""

    def readings(self, kept: list, ref_world, low=None) -> list:
        """The reference renders the checked pixels of the sampled frames
        of ``kept`` (frame i + 1's sampled u8 values, or None for a frame
        that came back misshapen) and compares.  With ``low`` (a lower
        dtype) the control is compared instead of the program: the
        reference computed in ``low``."""
        n = len(kept)
        k = min(self.cell.traffic["check"]["frames"], n)
        pick = sorted({n - 1, *self.rng.choice(n - 1, k - 1, replace=False)
                       .tolist()})
        K = self.cell.config["max_bounces"]
        pix = torch.as_tensor(self.pix, device=self.dev)
        seeds = [frame_seed(self.seed, i + 1) for i in pick]

        def u8(dtype):
            fr = tracer.Frame(ref_world, self.W, self.H, K, self.dev, dtype)
            sums = tracer.radiance(fr, pix, seeds, self.spp)[0]
            return to_u8(sums, self.spp).cpu().numpy().astype(np.int32)
        ref = u8(torch.float32)
        got = u8(low) if low is not None else [kept[i] for i in pick]
        diffs = [np.abs(g.astype(np.int32) - r) for g, r in zip(got, ref)
                 if g is not None]
        missing = len(pick) - len(diffs)
        d = np.concatenate(diffs) if diffs else np.full((1, 3), 255)
        return [Reading("u8_mean_abs", float(d.mean())),
                Reading("pixels_off_pct",
                        100.0 * float((d.max(1) >= 2).mean())),
                Reading("frames_missing", float(missing))]
