"""Closed-loop frames: one client renders whole frames back to back
through the port's ``ops/render.render`` and reads each u8 frame back.

Traffic keys: ``spp`` (samples a pixel), ``check`` (``frames``: frames
compared with the reference, the last one always among them; ``pixels``:
pixels compared in each, drawn from the seed), ``lane_count``
(``stride``, ``samples``: the traced run's count of K1's lane-bounces
and of the reference BVH's tests on them, every ``stride``-th pixel id
at the first ``samples`` samples).
Frame i of a run (i >= 1; 0 is the warm-up) renders with its own sample
stream, seed `frame_seed(seed, i)`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import trace, window
from rtbench.check import Reading
from rtbench.reference import bvh, tracer

WALK_CHUNK = 1 << 21    # rays a BVH walk takes at once


def frame_seed(seed: int, i: int) -> int:
    """The 32-bit sample-stream seed of frame ``i`` of run ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 63), i])
    return int(ss.generate_state(1, np.uint32)[0])


class Driver:
    def __init__(self, cell, seed: int, device, traced: bool):
        from raytracinginoneweekendincuda_torch.models import scenes
        from raytracinginoneweekendincuda_torch.ops import render
        from raytracinginoneweekendincuda_torch.scene.compiler import (
            compile_scene,
        )
        from raytracinginoneweekendincuda_torch.utils.config import (
            RenderConfig,
        )
        c, tr = cell.config, cell.traffic
        self.cell, self.seed, self.traced = cell, seed, traced
        self.dev = torch.device(device)
        self.W, self.H, self.spp = c["width"], c["height"], tr["spp"]
        self.render = render
        self.scene, self.meta = compile_scene(
            getattr(scenes, c["scene"])(), self.W, self.H,
            dtype=np.dtype(c["dtype"]))
        self.cfg = RenderConfig(width=self.W, height=self.H,
                                samples_per_pixel=self.spp,
                                max_bounces=c["max_bounces"],
                                engine=c["engine"])
        self.sample = Sample(cell, seed, self.dev)
        self.lat, self.ends, self.kept = [], [], []
        self.failed = 0

    def _frame(self, i: int, spp: int | None = None):
        cfg = self.cfg.with_(seed=frame_seed(self.seed, i))
        if spp is not None:
            cfg = cfg.with_(samples_per_pixel=spp)
        return self.render.render(self.scene, self.meta, cfg,
                                  device=self.dev, out_u8=True)

    def setup(self) -> None:
        """One frame at the cell's size, one sample a pixel: loads K1 and
        warms the path (the sample count is an argument of the kernel,
        not a shape: every buffer and launch is the window's)."""
        self._frame(0, spp=1)

    def window(self, seconds: float) -> float:
        """Frames back to back until one ends past ``seconds``; returns the
        window's start."""
        from raytracinginoneweekendincuda_torch.ops import mega2
        tr = self.traced
        with trace.wrapped(mega2, "pack_mega2_tables", "pack", tr), \
                trace.wrapped(mega2, "render_mega2", "k1_launch", tr), \
                trace.wrapped(self.render, "finalize", "finalize", tr):
            t0 = time.perf_counter()
            i = 1
            while True:
                s = time.perf_counter()
                with trace.span("frame", tr):
                    img = self._frame(i)
                e = time.perf_counter()
                self.lat.append(e - s)
                self.ends.append(e)
                if img.shape == (self.H, self.W, 3) and img.dtype == np.uint8:
                    self.kept.append(img[self.sample.row, self.sample.col])
                else:
                    self.failed += 1
                    self.kept.append(None)
                if window.closes(t0, seconds, e):
                    return t0
                i += 1

    @property
    def attempted(self) -> int:
        return len(self.ends)

    def end_to_end(self, t0: float) -> dict:
        rays = self.W * self.H * self.spp
        return {"rays_per_s": window.rate([rays] * len(self.ends), self.ends,
                                          t0),
                "frame_s": window.per_item(self.ends, t0),
                "frame_p95_ms": window.percentile(self.lat, 95.0) * 1e3}

    def release(self) -> None:
        self.scene = self.meta = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def count(self, ref_world) -> dict:
        """The traced run's counts: frames; K1's lane-bounces a frame by
        the reference's own path counter, scaled to the frame; and the box
        and sphere tests a lane-bounce of the reference's BVH walk
        (`reference/bvh.py`) on every lane-bounce of those paths, with
        each mean's standard error over the mean."""
        lc = self.cell.traffic["lane_count"]
        n_s = min(lc["samples"], self.spp)
        fr = tracer.Frame(ref_world, self.W, self.H,
                          self.cell.config["max_bounces"], self.dev)
        ids = torch.arange(0, self.W * self.H, lc["stride"], device=self.dev)
        rays = []
        _, nb = tracer.radiance(fr, ids, [frame_seed(self.seed, 1)], n_s,
                                visit=lambda *r: rays.append(r))
        lb = float(nb.sum()) * (self.W * self.H / ids.shape[0]) \
            * (self.spp / n_s)
        t = time.perf_counter()
        tree = bvh.build(fr.tab)
        lane, o, d, tm = (torch.cat(x) for x in zip(*rays))
        # per lane: its lane-bounces, box tests and sphere tests
        per = torch.zeros((3, ids.shape[0] * n_s), dtype=torch.float64,
                          device=self.dev)
        for c in range(0, lane.shape[0], WALK_CHUNK):
            s = slice(c, c + WALK_CHUNK)
            boxes, spheres, _ = bvh.walk(tree, fr.tab, o[s], d[s], tm[s],
                                         fr.t_min)
            for k, x in enumerate((torch.ones_like(boxes), boxes, spheres)):
                per[k].index_add_(0, lane[s], x.double())
        out = {"frames": len(self.ends), "lane_bounces_per_frame": lb,
               "pixels": self.W * self.H,
               "spheres": len(ref_world.spheres),
               "ref_bvh_nodes": tree.sphere.shape[0]}
        for k, what in ((1, "box"), (2, "sphere")):
            mean, rel_se = ratio(per[k], per[0])
            out[f"ref_{what}_tests_per_lane_bounce"] = mean
            out[f"ref_{what}_tests_rel_se"] = rel_se
        out["ref_walk_s"] = time.perf_counter() - t
        return out

    def readings(self, ref_world) -> list:
        return self.sample.readings(self.kept, ref_world)


def ratio(y: torch.Tensor, n: torch.Tensor) -> tuple:
    """(sum(y) / sum(n), its standard error over it): the ratio estimator
    of y per unit of n over sampled lanes, the error by the delta method."""
    L, sn = y.shape[0], float(n.sum())
    r = float(y.sum()) / sn
    se = (float(((y - r * n) ** 2).sum()) * L / max(L - 1, 1)) ** 0.5 / sn
    return r, se / r if r else 0.0


class Sample:
    """What a run compares: ``check.pixels`` pixels drawn from the seed,
    in ``check.frames`` frames of the window drawn from the seed after it
    closes (the last frame always among them)."""

    def __init__(self, cell, seed: int, device):
        c, tr = cell.config, cell.traffic
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.W, self.H, self.spp = c["width"], c["height"], tr["spp"]
        self.rng = np.random.default_rng(np.random.SeedSequence(
            [seed % (1 << 63), 1 << 20]))
        flat = np.sort(self.rng.choice(self.W * self.H,
                                       tr["check"]["pixels"], replace=False))
        self.row, self.col = flat // self.W, flat % self.W   # top row 0
        self.pix = (self.H - 1 - self.row) * self.W + self.col

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
        fr = tracer.Frame(ref_world, self.W, self.H, K, self.dev)
        lo = None if low is None else tracer.Frame(
            ref_world, self.W, self.H, K, self.dev, low)
        pix = torch.as_tensor(self.pix, device=self.dev)
        seeds = [frame_seed(self.seed, i + 1) for i in pick]

        def u8(frame):
            sums = tracer.radiance(frame, pix, seeds, self.spp)[0]
            return tracer.to_u8(sums, self.spp).cpu().numpy().astype(
                np.int32)
        ref = u8(fr)
        got = u8(lo) if lo is not None else [kept[i] for i in pick]
        diffs = [np.abs(g.astype(np.int32) - r) for g, r in zip(got, ref)
                 if g is not None]
        missing = len(pick) - len(diffs)
        d = np.concatenate(diffs) if diffs else np.full((1, 3), 255)
        return [Reading("u8_mean_abs", float(d.mean())),
                Reading("pixels_off_pct",
                        100.0 * float((d.max(1) >= 2).mean())),
                Reading("frames_missing", float(missing))]
