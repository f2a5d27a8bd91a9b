"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout -- K1
(``csrc/mega2_render.cu``), K2 (``csrc/mega2_trace.cu``), K3
(``csrc/replay_fwd.cu``), K4 (``csrc/replay_bwd.cu``), K5
(``csrc/mega_bounces.cu``) and K6 (``csrc/closest_geo.cu``), one nvcc
each, all started together -- and drives the port's three paths: the
render (the CLI's ``ops/render.render``, engine ``mega2``, at the
reference's headline config), the training step
(``parallel/train.make_train_step_mega2``) and the XLA-family engines
(``render`` with ``wavefront_pallas`` and ``mega``), holding every kernel
against its plain PyTorch version.  Phases:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the kernels' build times and ptxas reports;
3. pcg4d draws and ``generate_rays`` on the card, bit-exact against the
   numpy uint32 reference / the CPU port;
4. K1 against ``render_radiance_plain`` on the card for all ten scenes at
   64x32@4, max_bounces 50 (at most 1% of pixels above 1e-4, mean < 2e-3);
5. the main path: scene 0 at 1440x720@10 through ``render``, best of 3,
   with K1's launch count over that run; the PPM is written and checked,
   and K1 is compared with the plain version on every 97th pixel id;
6. scene 9 at 360x180@10 through K1 against the plain version on every
   97th pixel id, and K1 and the plain version timed at scene 0 360x180@10
   (K1's bound from that run's lane-bounces);
7. K2 against ``trace_tapes_plain``: all ten scenes at 64x32, spp 2, K 8
   (at most 0.1% of lanes may differ), and K2's in-kernel raygen against
   external rays from ``generate_rays`` on a pinhole scene;
8. K3 / K4 against ``replay_plain`` and its autograd: all ten scenes at
   64x32, spp 1, K 8 (forward: K1's bounds; backward: d_rep rel-L2 <=
   1e-3, at most 1% of lanes whose d_rays or d_bg differ by more than
   1e-3 of the largest);
9. the training step at full width: scene 0 at 640x360, spp 8, K 8
   (1.84 M lanes), Adam lr 1e-2, one warm-up and three timed steps, split
   into phases with CUDA events, with the K2 / K3 / K4 launch counts of
   that run; the device's busy share of a step (torch.profiler's kernel
   time over the unprofiled step); K2 against its plain version on all
   lanes, K3 and K4 against ``replay_plain`` and its autograd on all of
   sample 0's lanes (the shape the step launches them at), K4 also on
   every 97th pixel; each kernel timed alone against its plain version;
   then the scene-4 loss-decrease check (12x8, 4 steps);
10. K6 against ``closest_geo_plain`` on all ten scenes, on the rays of the
    first three iterations of a plain ``wavefront`` pool at 64x32@2
    (``t`` bit-equal, ``prim`` equal on at least 99.9% of lanes);
11. K5 against ``mega_bounces_plain`` on scenes 0, 1, 4, 6, 7 and 8, two
    calls on a full 8192-lane pool (``ri`` equal on at least 99.9% of
    lanes, ``rf`` within K1's bounds); K5 timed on scene 0's pool, the
    main path's shape;
12. the XLA-family path at full width: scene 0 at 1440x720@10 through
    ``render`` with ``wavefront_pallas`` (K6) and ``mega`` (K5), best of
    3, with the launch counts (one launch per loop iteration), the
    kernel's device ms per launch and the device's busy share of a frame
    (torch.profiler); both frames held against K1's ``mega2`` frame and
    the plain ``wavefront`` frame, all on the card; K6 against its plain
    version on the main path's first pool (131072 camera rays); scene 9
    at 1440x720@10 through ``wavefront_pallas``, timed and held against
    K1's frame.

Prints the kernel record and the card on lines of their own, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, before that
line, if any phase fails or there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from raytracinginoneweekendincuda_torch.core import rng
from raytracinginoneweekendincuda_torch.core.image import write_ppm
from raytracinginoneweekendincuda_torch.models.scenes import (
    SCENE_NAMES, build_scene,
)
from raytracinginoneweekendincuda_torch.scene import api
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from raytracinginoneweekendincuda_torch.ops import hit, integrator, mega
from raytracinginoneweekendincuda_torch.ops import mega2, pallas_hit
from raytracinginoneweekendincuda_torch.ops import replay as rp
from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc
from raytracinginoneweekendincuda_torch.ops.raygen import (
    camera_tuple, generate_rays,
)
from raytracinginoneweekendincuda_torch.ops.render import finalize, render
from raytracinginoneweekendincuda_torch.parallel import train
from raytracinginoneweekendincuda_torch.utils.benchmark import card_line

TOL_ABOVE = 1e-4          # a pixel "differs" when a channel moves more
MAX_FRAC_ABOVE = 0.01     # at most 1% of pixels may differ
MAX_MEAN = 2e-3           # mean absolute difference over all channels
STRIDE = 97               # pixel-id stride of the main-path check subset
MAIN = (1440, 720, 10)    # the main path's frame: width, height, spp
SMALL = (64, 32, 4)       # every scene, K1 against the plain version
SIDE = (360, 180, 10)     # scene 9, and the K1 / plain timing of scene 0
TRACE = (64, 32, 2, 8)    # every scene, K2 against the plain version
REPLAY = (64, 32, 1, 8)   # every scene, K3 / K4 against the plain version
TRAIN = (640, 360, 8, 8)  # the training step: width, height, spp, K
MAX_DIFF_LANES = 0.001    # K2: at most 0.1% of lanes may differ
GRAD_REL = 1e-3           # K4: d_rep rel-L2, and the per-lane d_rays /
                          # d_bg tolerance relative to the largest entry
# The plain ``wavefront`` frame tests spheres in the contraction form of
# ops/hit.py (dot products of the ray with each centre), which rounds the
# hits on scene 0's small spheres differently in f32 from K5's, K6's and
# K1's direct form; 5.4% of its pixels then move by more than 1e-4 against
# theirs at 1440x720@10, mean 5.8e-4 (measured on an H100 80GB HBM3 at
# 700 W: 55,726 and 55,700 of 1,036,800 pixels against K6's and K5's
# frames).
MAX_FRAC_PLAIN_WF = 0.06
POOL = (64, 32, 2, 3)     # K6 on a plain wavefront pool: w, h, spp,
                          # iterations
MEGA_SCENES = (0, 1, 4, 6, 7, 8)   # the scenes K5 renders (no Perlin or
                                   # image textures)
MEGA_FRAME = (64, 32, 4)  # K5's 8192-lane pool: the first refill of a
                          # frame of this size

# The card's peaks for the bounds (H100 SXM at 700 W): FP32 outside the
# tensor cores, device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations (each add, multiply, compare, divide, sqrt one op) per
# row test, counted from csrc/mega2_bounce.cuh: a sphere row (moving
# centre, quadratic, discriminant) 26, a loose quad row 16, a box slab row
# 36, a medium 40, and the rest of a bounce (record, emission, scatter,
# RNG) 100; a replayed bounce (csrc/replay_bounce.cuh: re-intersection,
# record, scatter) 160, its adjoint with the two recomputes 570.
OPS_SPHERE, OPS_QUAD, OPS_BOX, OPS_MEDIUM, OPS_BOUNCE = 26, 16, 36, 40, 100
OPS_REPLAY, OPS_REPLAY_BWD = 160, 570
# FP32 ops per pair test of csrc/xla_pair.cuh (K5, K6): a sphere through
# the sign of its discriminant (moving centre, oc, half-b, cc, disc) 28 --
# the roots follow only where it is positive -- and a quad (plane hit,
# interior test, compares) 39; the rest of a K5 bounce (record, texture,
# RNG, scatter) 120, a medium 45.
OPS_XSPHERE, OPS_XQUAD, OPS_XBOUNCE, OPS_XMEDIUM = 28, 39, 120, 45


def synthetic_texture() -> np.ndarray:
    """[256, 512, 3] byte-valued texture from seed 1984 (stands in for the
    earth JPEG where PIL cannot decode it)."""
    rs = np.random.default_rng(1984)
    return rs.integers(0, 256, (256, 512, 3)).astype(np.float32) / 255.0


def scene_desc(sid: int):
    """Scene ``sid``; image textures that could not be decoded get the
    synthetic texture, so the texel path really runs.  Returns (desc,
    texture label or None)."""
    desc = build_scene(sid)
    label = None
    for i, obj in enumerate(desc.objects):
        mat = getattr(obj, "material", None)
        tex = getattr(mat, "texture", None)
        if isinstance(tex, api.ImageTexture):
            if tex.image is None:
                img = synthetic_texture()
                desc.objects[i] = dataclasses.replace(
                    obj, material=api.Lambertian(
                        api.ImageTexture(img)))
                label = "synthetic 256x512 (seed 1984): earthmap.jpg " \
                        "not decoded"
            else:
                label = f"earthmap.jpg decoded {tex.image.shape[1]}x" \
                        f"{tex.image.shape[0]}"
    return desc, label


def compile_cfg(sid: int, w: int, h: int, spp: int, max_bounces: int = 50):
    desc, label = scene_desc(sid)
    scene, meta = compile_scene(desc, w, h, dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_bounces=max_bounces, engine="mega2")
    return scene, meta, cfg, label


def image_of(fb: torch.Tensor, spp: int) -> np.ndarray:
    return finalize(fb, spp, gamma=True, out_u8=False).cpu().numpy()


def compare(k1: np.ndarray, plain: np.ndarray, what: str,
            unit: str = "pixels", max_frac: float = MAX_FRAC_ABOVE) -> dict:
    """Per-row comparison of a kernel's [P, C] image (or radiance, or ray
    state) with its plain version's, checked against the bounds above."""
    diff = np.abs(k1.astype(np.float64) - plain.astype(np.float64))
    px = diff.max(axis=1)
    stats = {"pixels": int(px.shape[0]),
             "identical": int((px == 0).sum()),
             "above_1e-4": int((px > TOL_ABOVE).sum()),
             "mean_abs": float(diff.mean()), "max_abs": float(diff.max())}
    print(f"  {what}: {stats['identical']}/{stats['pixels']} {unit} "
          f"bit-identical, {stats['above_1e-4']} above 1e-4, mean |diff| "
          f"{stats['mean_abs']:.3e}, max {stats['max_abs']:.3e}", flush=True)
    if not np.isfinite(k1).all():
        raise AssertionError(f"{what}: the kernel produced non-finite values")
    if stats["above_1e-4"] > max_frac * stats["pixels"] \
            or stats["mean_abs"] >= MAX_MEAN:
        raise AssertionError(f"{what}: the kernel disagrees with the plain "
                             f"version")
    return stats


def timed(fn, repeats: int = 3):
    """(best seconds, last result) of ``fn`` after one warm-up, each run
    ending in torch.cuda.synchronize()."""
    fn()
    torch.cuda.synchronize()
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def once_s(fn):
    """(seconds, result) of one call of ``fn``, ending in
    torch.cuda.synchronize()."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def once_ms(fn):
    """(milliseconds of one call of ``fn`` by CUDA events, its result):
    for the plain versions, which run long enough that the host's share
    is small."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def device_events(fn, repeats: int) -> list:
    """(name, device microseconds, launches) of every kernel that
    ``repeats`` calls of ``fn`` ran, from torch.profiler, after one
    warm-up call.  Sums the profiler's raw device records by name
    (``key_averages`` takes minutes over the ~340 k launches of a full
    ``mega`` frame)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    sums = {}
    for ev in prof.profiler.kineto_results.events():
        if "CUDA" in str(ev.device_type()) and ev.duration_ns() > 0:
            us, n = sums.get(ev.name(), (0.0, 0))
            sums[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    return [(name, us, n) for name, (us, n) in sums.items()]


def device_ms(fn, kernel: str, repeats: int = 5) -> float:
    """Mean device milliseconds of the CUDA kernel named ``kernel`` over
    ``repeats`` calls of ``fn`` (the kernel alone, without the wrapper's
    host time that CUDA events around a short launch would include)."""
    evs = [(us, n) for key, us, n in device_events(fn, repeats)
           if kernel in key]
    if not evs:
        raise AssertionError(f"the profiler saw no {kernel} launch")
    return sum(us for us, _ in evs) / 1e3 / sum(n for _, n in evs)


LOADERS = {"mega2_render": mega2.load_kernel,
           "mega2_trace": mega2.load_trace_kernel,
           "replay_fwd": rc.load_fwd_kernel,
           "replay_bwd": rc.load_bwd_kernel,
           "mega_bounces": mega.load_kernel,
           "closest_geo": pallas_hit.load_kernel}


def build_kernels() -> dict:
    """Every kernel's build record; one nvcc per source, all together."""
    with ThreadPoolExecutor(len(LOADERS)) as ex:
        futs = {n: ex.submit(f) for n, f in LOADERS.items()}
        return {n: f.result()[1] for n, f in futs.items()}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def table_bytes(tab) -> int:
    return nbytes(tab.sph, tab.quad, tab.attr, tab.med, tab.perm, tab.vec,
                  tab.texels, tab.img_dims)


def pair_ops(tab) -> int:
    """FP32 ops of one K1 / K2 bounce over this scene's rows."""
    n_sph = int((tab.sph[:, 9] > 0.5).sum())
    n_quad = int((tab.quad[:tab.nl_pad, 12] > 0.5).sum())
    n_box = int((tab.quad[tab.q_pad:, 7] > 0.5).sum()) if tab.b_pad else 0
    return (n_sph * OPS_SPHERE + n_quad * OPS_QUAD + n_box * OPS_BOX
            + tab.n_media * OPS_MEDIUM + OPS_BOUNCE)


def lane_bounces(tab, tape: torch.Tensor) -> int:
    """Bounces the lanes of a tape [K, L] ran: every hit, plus the miss
    that ended a path before K (a path's first -1 after a hit that is not
    a light).  A metal ray absorbed by its own surface ends the same way
    and is counted too, so the count is at most that many too high."""
    K = tape.shape[0]
    hit = tape >= 0
    first = torch.where(hit.all(0), K, (~hit).to(torch.int32).argmax(0))
    prev = tape.gather(0, (first - 1).clamp_min(0)[None].long())[0]
    geo = (prev >= 0) & (prev < tab.np_rows)
    light = geo & (tab.attr[prev.clamp(0, tab.np_rows - 1).long(), 10]
                   == 3.0)
    ended_by_miss = (first < K) & ((first == 0) | ~light)
    return int(hit.sum()) + int(ended_by_miss.sum())


def row_contention(tape: torch.Tensor) -> dict:
    """How K4's d_rep atomics see a tape [K, N]: the share of hits on the
    hottest row, and the share of warp-bounces with a hit whose hits all
    share one row (K4 adds those with one atomic per column)."""
    hits = tape[tape >= 0].long()
    counts = torch.bincount(hits)
    K, N = tape.shape
    w = tape[:, :N - N % 32].reshape(K, -1, 32)
    top = w.max(-1, keepdim=True).values
    busy = top[..., 0] >= 0
    uniform = ((w < 0) | (w == top)).all(-1) & busy
    return {"hot_row": int(counts.argmax()),
            "hot_share": float(counts.max()) / max(int(hits.numel()), 1),
            "uniform_warp_share": float(uniform.sum())
            / max(int(busy.sum()), 1)}


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FP32 ops over the FP32 rate."""
    tb, to = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def phase_rng(dev) -> None:
    n = 1 << 17
    rs = np.random.default_rng(0)
    words = [rs.integers(0, 2 ** 32, n, dtype=np.uint32) for _ in range(4)]
    with np.errstate(over="ignore"):
        want = rng.pcg4d_numpy(*words)
    got = rng.pcg4d(*[torch.from_numpy(w.view(np.int32)).to(dev)
                      for w in words])
    for a, b in zip(got, want):
        if not np.array_equal(rng.as_uint32(a), b):
            raise AssertionError("pcg4d on the card differs from numpy")
    u = rng.unit(got[0]).cpu().numpy()
    if not np.array_equal(u, (want[0] >> 8).astype(np.float32)
                          * np.float32(rng.INV_2POW24)):
        raise AssertionError("unit() on the card differs from numpy")
    w, h, _ = SMALL
    for sid in (4, 0):
        scene, meta, cfg, _ = compile_cfg(sid, w, h, 1)
        fp = mega2.frame_params(scene, cfg)
        pix = torch.arange(w * h, dtype=torch.int32)
        for s in (0, 3):
            cpu = generate_rays(fp.cam, pix, s, w, h, fp.seed)
            gpu = generate_rays(fp.cam, pix.to(dev), s, w, h, fp.seed)
            for a, b in zip(cpu[:3], gpu[:3]):
                a, b = a.numpy(), b.cpu().numpy()
                if sid == 0:
                    # lens disk: sin/cos differ between the CPU and CUDA
                    # math libraries by an ulp or two, which moves the
                    # origin and direction by ~lens radius * 1e-7
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
                elif not np.array_equal(a, b):
                    raise AssertionError(f"scene {sid} rays differ")
    print("  pcg4d: 4 x 131072 words bit-exact vs numpy uint32; rays: "
          "scene 4 bit-exact vs the CPU port, scene 0 within 1e-6",
          flush=True)


def phase_trace(dev) -> None:
    w, h, spp, K = TRACE
    pix_all = torch.arange(w * h, dtype=torch.int32, device=dev)
    pix, samp = mega2.tape_lanes(pix_all, spp)
    for sid in range(10):
        scene, meta, cfg, _ = compile_cfg(sid, w, h, 1, K)
        tab = mega2.pack_mega2_tables(scene, meta, dev)
        fp = mega2.frame_params(scene, cfg)
        got = mega2.trace_tapes_cuda(tab, pix, samp, fp)
        want = mega2.trace_tapes_plain(tab, pix, samp, fp)
        differ = float((got != want).any(0).float().mean())
        print(f"  scene {sid}: {int((got == want).all(0).sum())}/"
              f"{pix.shape[0]} lanes identical", flush=True)
        if differ > MAX_DIFF_LANES:
            raise AssertionError(f"K2 differs on scene {sid}")
    # in-kernel raygen against external rays (scene 4: pinhole camera)
    scene, meta, cfg, _ = compile_cfg(4, w, h, 1, K)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg)
    o, d, tm, _ = generate_rays(fp.cam, pix, samp, w, h, fp.seed)
    rays = torch.cat([o, d, tm[:, None]], dim=1)
    ext = mega2.trace_tapes_cuda(tab, pix, samp, fp, rays)
    inner = mega2.trace_tapes_cuda(tab, pix, samp, fp)
    same = int((ext == inner).all(0).sum())
    print(f"  scene 4 external rays: {same}/{pix.shape[0]} lanes identical "
          f"to the in-kernel raygen", flush=True)
    if same < (1 - MAX_DIFF_LANES) * pix.shape[0]:
        raise AssertionError("K2 with external rays differs")


def grad_check(tt, rays, tape, pc, bg, g, t_min, what: str) -> dict:
    """K4 against autograd of replay_plain on the same inputs; the record
    also holds the time of the plain version's backward (``plain_ms``,
    CUDA events, one call)."""
    d_rep, d_rays, d_bg = rc.replay_bwd_cuda(tt, tt.rep.detach(), rays, tape,
                                             pc, 0, bg, g, t_min=t_min)
    rep = tt.rep.detach().clone().requires_grad_(True)
    rays_p = rays.clone().requires_grad_(True)
    bg_p = bg.expand(rays.shape[0], 3).clone().requires_grad_(True)
    out = rp.replay_plain(tt._replace(rep=rep), rays_p, tape, pc, 0, bg_p,
                          t_min=t_min)
    plain_ms, grads = once_ms(lambda: torch.autograd.grad(
        out, (rep, rays_p, bg_p), g, allow_unused=True))
    want = tuple(torch.zeros_like(x) if gr is None else gr
                 for gr, x in zip(grads, (rep, rays_p, bg_p)))
    del out, grads
    rel = float((d_rep - want[0]).norm()) / max(float(want[0].norm()), 1e-30)
    bad = []
    for got, ref in ((d_rays, want[1]), (d_bg, want[2])):
        tol = GRAD_REL * float(ref.abs().max())
        bad.append(float(((got - ref).abs().max(1).values > tol)
                         .float().mean()))
    st = {"d_rep_rel_l2": rel, "d_rays_lanes_off": bad[0],
          "max_abs": max(float((d_rep - want[0]).abs().max()),
                         float((d_rays - want[1]).abs().max())),
          "d_bg_lanes_off": bad[1], "d_rep_norm": float(want[0].norm()),
          "d_rays_max": float(want[1].abs().max()), "plain_ms": plain_ms}
    print(f"  {what}: d_rep rel-L2 {rel:.2e} (|d_rep| {st['d_rep_norm']:.3e}),"
          f" lanes off: d_rays {bad[0]:.4f} (max |d_rays| "
          f"{st['d_rays_max']:.3e}), d_bg {bad[1]:.4f}", flush=True)
    for t in (d_rep, d_rays, d_bg):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{what}: K4 produced non-finite values")
    if rel > GRAD_REL or max(bad) > MAX_FRAC_ABOVE:
        raise AssertionError(f"{what}: K4 disagrees with autograd")
    return st


def replay_inputs(scene, meta, tab, fp, pix, samp: int, tape, dev):
    tt = rp.replay_table(scene, meta, tab,
                         kernel_space=mega2.mega2_kernel_id_space(tab, meta))
    o, d, tm, pc = generate_rays(fp.cam, pix, samp, fp.width, fp.height,
                                 fp.seed)
    rays = torch.cat([o, d, tm[:, None]], dim=1).contiguous()
    bg = torch.tensor(fp.background, dtype=torch.float32, device=dev)
    rs = np.random.default_rng(1984)
    g = torch.as_tensor(rs.uniform(0.5, 1.5, (pix.shape[0], 3))
                        .astype(np.float32), device=dev)
    return tt, rays, tape, pc, bg, g


def phase_replay(dev) -> None:
    w, h, _, K = REPLAY
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    for sid in range(10):
        scene, meta, cfg, _ = compile_cfg(sid, w, h, 1, K)
        tab = mega2.pack_mega2_tables(scene, meta, dev)
        fp = mega2.frame_params(scene, cfg)
        tape = mega2.trace_tapes_cuda(tab, pix, torch.zeros_like(pix), fp)
        tt, rays, tape, pc, bg, g = replay_inputs(scene, meta, tab, fp, pix,
                                                  0, tape, dev)
        out = rc.replay_fwd_cuda(tt, tt.rep.detach(), rays, tape, pc, 0, bg,
                                 t_min=fp.t_min)
        plain = rp.replay_plain(tt, rays, tape, pc, 0, bg, t_min=fp.t_min)
        compare(out.cpu().numpy(), plain.detach().cpu().numpy(),
                f"scene {sid} K3")
        grad_check(tt, rays, tape, pc, bg, g, fp.t_min, f"scene {sid} K4")


def phase_train(dev, card: str) -> dict:
    """The training step at full width; returns the kernels' numbers."""
    W, H, spp, K = TRAIN
    scene, meta, cfg, _ = compile_cfg(0, W, H, spp, K)
    P, L = W * H, W * H * spp
    pix_all = torch.arange(P, dtype=torch.int32, device=dev)
    # target: K1's render of the scene; the start: albedos perturbed
    target = mega2.render_radiance_cuda(
        mega2.pack_mega2_tables(scene, meta, dev), pix_all,
        mega2.frame_params(scene, cfg)) / float(spp)
    start = scene._replace(tex_c0=np.clip(
        np.asarray(scene.tex_c0) * 0.5 + 0.2, 0.0, 1.0).astype(np.float32))
    state = train.init_state(start, lambda ps: torch.optim.Adam(ps, lr=1e-2),
                             device=dev)
    step = train.make_train_step_mega2(start, meta, cfg)
    pix = np.arange(P, dtype=np.int32)

    counters = (mega2.trace_tapes_cuda, rc.replay_fwd_cuda,
                rc.replay_bwd_cuda)
    for c in counters:
        c.launches = 0
    state, loss = step(state, pix, target)               # warm-up
    torch.cuda.synchronize()
    losses, walls, split = [float(loss)], [], {}
    for _ in range(3):
        ev = [("start", torch.cuda.Event(enable_timing=True))]
        ev[0][1].record()

        def mark(name, ev=ev):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append((name, e))

        t0 = time.perf_counter()
        state, loss = step(state, pix, target, mark=mark)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        for (_, a), (name, b) in zip(ev, ev[1:]):
            split.setdefault(name, []).append(a.elapsed_time(b))
    launches = [c.launches for c in counters]
    print(f"  {W}x{H}, spp {spp}, K {K} ({P * spp} lanes): ms per step "
          f"{np.mean(walls):.2f} (best {min(walls):.2f}) on {card}",
          flush=True)
    print("  split (mean ms, CUDA events): " + ", ".join(
        f"{n} {np.mean(v):.2f}" for n, v in split.items())
        + "  [pack: host packing + upload; trace: K2; forward: derive, "
          "raygen, K3 x spp; backward: K4 x spp + derive's backward; "
          "update: Adam]", flush=True)
    print(f"  launches over the 4 steps: K2 {launches[0]}, K3 {launches[1]}, "
          f"K4 {launches[2]}; losses {losses}", flush=True)
    if min(launches) < 1:
        raise AssertionError("the training step did not launch every kernel")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    # the device's busy share: the kernel time of a profiled step (the
    # profiler slows the host, not the kernels) over the unprofiled step
    step_ms = float(np.mean(walls))
    box = [state]

    def one_step():
        box[0], _ = step(box[0], pix, target)

    evs = sorted(device_events(one_step, 1), key=lambda e: -e[1])
    state = box[0]
    busy_ms = sum(us for _, us, _ in evs) / 1e3
    print(f"  device kernels {busy_ms:.2f} ms of the {step_ms:.2f} ms step "
          f"(busy {busy_ms / step_ms:.3f}, idle {1 - busy_ms / step_ms:.3f}); "
          f"{sum(n for *_, n in evs)} launches; busiest: " + ", ".join(
              f"{key[:40]} {us / 1e3:.2f} ms x{n}" for key, us, n in evs[:6]),
          flush=True)

    # the kernels alone at the step's shapes, against their plain versions
    sc_np = train.merge_params(start, train.params_to_numpy(state.params))
    tab = mega2.pack_mega2_tables(sc_np, meta, dev)
    fp = mega2.frame_params(sc_np, cfg)
    lane_pix, lane_samp = mega2.tape_lanes(pix_all, spp)
    tapes = mega2.trace_tapes_cuda(tab, lane_pix, lane_samp, fp)
    k2_plain_ms, plain_tapes = once_ms(lambda: mega2.trace_tapes_plain(
        tab, lane_pix, lane_samp, fp))
    same = float((tapes == plain_tapes).all(0).float().mean())
    k2_err = float((tapes - plain_tapes).abs().max())
    del plain_tapes
    print(f"  K2 on all {L} lanes: {same:.6f} of lanes identical to the "
          f"plain version", flush=True)
    if same < 1 - MAX_DIFF_LANES:
        raise AssertionError("K2 differs from its plain version")
    lb_all = lane_bounces(tab, tapes)
    tape0 = tapes[:, :P].contiguous()                    # sample 0
    lb0 = lane_bounces(tab, tape0)
    cont = row_contention(tape0)
    print(f"  d_rep contention, sample 0: row {cont['hot_row']} takes "
          f"{cont['hot_share']:.3f} of the hits; {cont['uniform_warp_share']:.3f}"
          f" of the warp-bounces with a hit have one row (one atomic per "
          f"column)", flush=True)
    tt, rays, tape0, pc, bg, g = replay_inputs(sc_np, meta, tab, fp,
                                               pix_all, 0, tape0, dev)
    out = rc.replay_fwd_cuda(tt, tt.rep.detach(), rays, tape0, pc, 0, bg,
                             t_min=fp.t_min)
    with torch.no_grad():
        k3_plain_ms, plain = once_ms(lambda: rp.replay_plain(
            tt, rays, tape0, pc, 0, bg, t_min=fp.t_min))
    k3_st = compare(out.cpu().numpy(), plain.cpu().numpy(),
                    f"K3 sample 0, all {P} pixels")
    # K4 on the shape the step launches it: all of sample 0's lanes
    k4_st = grad_check(tt, rays, tape0, pc, bg, g, fp.t_min,
                       f"K4 sample 0, all {P} pixels")
    k4_plain_ms = k4_st["plain_ms"]
    dev_ms = {
        "mega2_trace": device_ms(lambda: mega2.trace_tapes_cuda(
            tab, lane_pix, lane_samp, fp), "mega2_trace_kernel"),
        "replay_fwd": device_ms(lambda: rc.replay_fwd_cuda(
            tt, tt.rep.detach(), rays, tape0, pc, 0, bg, t_min=fp.t_min),
            "replay_fwd_kernel"),
        "replay_bwd": device_ms(lambda: rc.replay_bwd_cuda(
            tt, tt.rep.detach(), rays, tape0, pc, 0, bg, g, t_min=fp.t_min),
            "replay_bwd_kernel"),
    }
    print("  device ms per launch (torch.profiler): " + ", ".join(
        f"{k} {v:.4f}" for k, v in dev_ms.items()) + f"; plain versions "
        f"(CUDA events, one call): K2 {k2_plain_ms:.1f}, K3 "
        f"{k3_plain_ms:.1f}, K4 (autograd backward) {k4_plain_ms:.1f}; "
        f"lane-bounces {lb0} (sample 0), {lb_all} (all samples)",
        flush=True)
    k34 = [spp * dev_ms["replay_fwd"], spp * dev_ms["replay_bwd"]]
    pack_ms, k2_ms = float(np.mean(split["pack"])), dev_ms["mega2_trace"]
    print(f"  per step: pack {pack_ms:.2f}, K2 {k2_ms:.2f}, K3 x {spp} "
          f"{k34[0]:.2f}, K4 x {spp} {k34[1]:.2f}, the rest (derive, raygen, "
          f"autograd glue, Adam, host gaps) "
          f"{step_ms - pack_ms - k2_ms - sum(k34):.2f} of {step_ms:.2f} ms",
          flush=True)
    sub = pix_all[::STRIDE].contiguous()
    grad_check(*replay_inputs(
        sc_np, meta, tab, fp, sub, 0,
        mega2.trace_tapes_cuda(tab, sub, torch.zeros_like(sub), fp), dev),
        fp.t_min, f"K4 sample 0, every {STRIDE}th pixel")

    n_geo = table_bytes(tab)
    n_tt = nbytes(tt.rep, tt.med, tt.perm, tt.vec, tt.texels, tt.img_dims)
    recs = {
        "mega2_trace": dict(
            launches=launches[0], max_abs_err=k2_err,
            ms=dev_ms["mega2_trace"], plain_ms=k2_plain_ms,
            bound=bound(n_geo + L * (4 + 4 + 4 * K), lb_all * pair_ops(tab))),
        "replay_fwd": dict(
            launches=launches[1], max_abs_err=k3_st["max_abs"],
            ms=dev_ms["replay_fwd"], plain_ms=k3_plain_ms,
            bound=bound(n_tt + P * (28 + 4 * K + 4 + 12), lb0 * OPS_REPLAY)),
        "replay_bwd": dict(
            launches=launches[2], max_abs_err=k4_st["max_abs"],
            ms=dev_ms["replay_bwd"], plain_ms=k4_plain_ms,
            bound=bound(n_tt + nbytes(tt.rep)
                        + P * (28 + 4 * K + 4 + 12 + 28 + 12),
                        lb0 * OPS_REPLAY_BWD)),
    }
    for name, r in recs.items():
        print(f"  {name}: bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"measured {r['ms']:.3f} ms", flush=True)

    # the scene-4 loss-decrease check (tests/test_torch_train.py's config)
    scene, meta, cfg, _ = compile_cfg(4, 12, 8, 2, 4)
    p4 = torch.arange(96, dtype=torch.int32, device=dev)
    tgt = mega2.render_radiance_cuda(mega2.pack_mega2_tables(
        scene, meta, dev), p4, mega2.frame_params(scene, cfg)) / 2.0
    start = scene._replace(tex_c0=np.clip(
        np.asarray(scene.tex_c0) * 0.5 + 0.2, 0.0, 1.0).astype(np.float32))
    st4 = train.init_state(start, lambda ps: torch.optim.Adam(ps, lr=0.05),
                           device=dev)
    step4 = train.make_train_step_mega2(start, meta, cfg)
    l4 = []
    for _ in range(4):
        st4, loss = step4(st4, np.arange(96), tgt)
        l4.append(float(loss))
    print(f"  scene 4 at 12x8@2, 4 steps: losses {l4}", flush=True)
    if not (np.isfinite(l4).all() and l4[-1] < 0.7 * l4[0]):
        raise AssertionError("scene 4 loss did not fall below 0.7x")
    return recs


def pool_rays(sid: int, dev):
    """(ray_pack [N, 8], sphere table, quad table, t_min) of scene ``sid``:
    the rays of the first iterations of a plain ``wavefront`` pool.  Every
    work item of the POOL frame fits in one pool, so the pool starts with
    all its camera rays and then bounces them (`integrator.bounce_step`
    with the brute-force hit, as the engine does)."""
    w, h, spp, iters = POOL
    scene, meta, cfg, _ = compile_cfg(sid, w, h, spp)
    st = hit.scene_tensors(scene, dev)
    hit_fn = hit.brute_force_hit_fn(st, meta)
    k = torch.arange(w * h * spp, device=dev)
    o, d, tm, pc = generate_rays(st.camera, k % (w * h), k // (w * h), w, h,
                                 cfg.seed)
    samp = (k // (w * h)).to(torch.int32)
    thr, acc = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones(k.shape[0], dtype=torch.bool, device=dev)
    packs = []
    for b in range(iters):
        packs.append(torch.cat([o, d, tm[:, None],
                                torch.zeros_like(tm)[:, None]], dim=1))
        o, d, thr, acc, alive = integrator.bounce_step(
            st, meta, hit_fn, o, d, tm, thr, acc, alive, pc, samp, b,
            t_min=cfg.t_min)
    sph, quad = pallas_hit.pack_geometry(scene, dev)
    return torch.cat(packs).contiguous(), sph, quad, cfg.t_min


def check_k6(rays, sph, quad, t_min: float, what: str) -> float:
    """K6 against its plain version: ``t`` bit-equal on every lane,
    ``prim`` on at least 1 - MAX_DIFF_LANES of them.  Returns the largest
    |t| difference."""
    t, p = pallas_hit.closest_geo_cuda(rays, sph, quad, t_min)
    tp, pp = pallas_hit.closest_geo_plain(rays, sph, quad, t_min)
    t_eq = float((t == tp).float().mean())
    p_eq = float((p == pp).float().mean())
    print(f"  {what}: {rays.shape[0]} rays, t identical on {t_eq:.6f}, prim "
          f"on {p_eq:.6f} of lanes; hits {float((pp >= 0).float().mean()):.3f}",
          flush=True)
    if t_eq < 1.0 or p_eq < 1 - MAX_DIFF_LANES:
        raise AssertionError(f"{what}: K6 disagrees with the plain version")
    return float((t - tp).abs().max())


def phase_closest_geo(dev) -> None:
    for sid in range(10):
        rays, sph, quad, t_min = pool_rays(sid, dev)
        check_k6(rays, sph, quad, t_min, f"scene {sid}")


def active_prims(tab_s, row_s: int, tab_q, row_q: int):
    return (int((tab_s[row_s] > 0.5).sum()), int((tab_q[row_q] > 0.5).sum()))


def mega_pool(sid: int, dev):
    """(tables, rf, ri, kwargs) of K5's first call on scene ``sid``: the
    first refill of a MEGA_FRAME frame (work item k -> pixel k % npix,
    sample k // npix)."""
    w, h, spp = MEGA_FRAME
    scene, meta, cfg, _ = compile_cfg(sid, w, h, spp)
    tabs = mega.pack_mega_tables(scene, meta, dev)
    k = torch.arange(w * h * spp, device=dev)
    o, d, tm, pc = generate_rays(camera_tuple(scene.camera), k % (w * h),
                                 k // (w * h), w, h, cfg.seed)
    rf = torch.cat([o, d, tm[:, None], torch.ones_like(o),
                    torch.zeros_like(o)], dim=1).contiguous()
    zero = torch.zeros_like(pc)
    ri = torch.stack([pc, (k // (w * h)).to(torch.int32), zero, zero + 1],
                     dim=1).contiguous()
    kw = dict(k_bounces=mega.MEGA_K, t_min=cfg.t_min,
              max_bounces=cfg.max_bounces,
              background=tuple(float(x) for x in
                               np.asarray(scene.camera.background)))
    return tabs, rf, ri, kw


def phase_mega_bounces(dev) -> dict:
    """K5 against its plain version; returns K5's record from scene 0's
    pool (the main path's shape: 8192 lanes, scene 0's tables)."""
    rec = {}
    for sid in MEGA_SCENES:
        tabs, rf, ri, kw = mega_pool(sid, dev)
        first = (tabs, rf, ri, kw)
        errs = []
        for call in range(2):
            rf_k, ri_k = mega.mega_bounces_cuda(rf, ri, tabs, **kw)
            rf_p, ri_p = mega.mega_bounces_plain(rf, ri, tabs, **kw)
            ri_eq = float((ri_k == ri_p).all(1).float().mean())
            print(f"  scene {sid} call {call}: ri identical on {ri_eq:.6f} of "
                  f"lanes", flush=True)
            if ri_eq < 1 - MAX_DIFF_LANES:
                raise AssertionError(f"scene {sid}: K5's ri differs")
            st = compare(rf_k.cpu().numpy(), rf_p.cpu().numpy(),
                         f"scene {sid} call {call} rf", unit="lanes")
            errs.append(st["max_abs"])
            rf, ri = rf_k, ri_k
        if sid != 0:
            continue
        tabs, rf, ri, kw = first
        ms = device_ms(lambda: mega.mega_bounces_cuda(rf, ri, tabs, **kw),
                       "mega_bounces_kernel")
        plain_ms, (_, ri_p) = once_ms(
            lambda: mega.mega_bounces_plain(rf, ri, tabs, **kw))
        lb = int((ri_p[:, 2] - ri[:, 2]).sum())
        n_s, n_q = active_prims(tabs.sph, mega.SPH_ACTIVE, tabs.quad,
                                mega.QUAD_ACTIVE)
        ops = lb * (n_s * OPS_XSPHERE + n_q * OPS_XQUAD
                    + tabs.n_media * OPS_XMEDIUM + OPS_XBOUNCE)
        rec = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                   bound=bound(nbytes(tabs.sph, tabs.quad, tabs.attr, tabs.med)
                               + 2 * nbytes(rf, ri), ops))
        print(f"  K5 on scene 0's {rf.shape[0]}-lane pool: {ms:.4f} ms a "
              f"launch (torch.profiler), plain {plain_ms:.2f} ms; "
              f"{lb} lane-bounces over {n_s} spheres, {n_q} quads; bound "
              f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]})", flush=True)
    return rec


def frame_split(evs, kernel: str, frame_ms: float) -> dict:
    """The profiled frame's device time: the kernel's, the rest's, and the
    busy share of the unprofiled frame."""
    k_us = sum(us for key, us, _ in evs if kernel in key)
    k_n = sum(n for key, _, n in evs if kernel in key)
    all_us = sum(us for _, us, _ in evs)
    busy_ms = all_us / 1e3
    print(f"    device: {kernel} {k_us / 1e3:.2f} ms over {k_n} launches "
          f"({k_us / 1e3 / max(k_n, 1):.4f} ms each), other kernels "
          f"{(all_us - k_us) / 1e3:.2f} ms, {sum(n for *_, n in evs)} "
          f"launches in all; busy {busy_ms / frame_ms:.3f} of the "
          f"{frame_ms:.1f} ms frame; busiest: " + ", ".join(
              f"{key[:32]} {us / 1e3:.1f} ms x{n}" for key, us, n in
              sorted(evs, key=lambda e: -e[1])[:5]), flush=True)
    return {"kernel_ms": k_us / 1e3 / max(k_n, 1), "busy": busy_ms / frame_ms}


def phase_xla_frames(dev, card: str) -> dict:
    """The XLA-family engines at full width; returns K6's record at the
    main path's first pool and the launch counts of K5 and K6 over the
    main path's frames."""
    w, h, spp = MAIN
    scene, meta, cfg, _ = compile_cfg(0, w, h, spp)
    flat = lambda img: np.ascontiguousarray(img).reshape(-1, 3)

    # K6 at the main path's first pool: the camera rays of work items
    # 0 .. P-1
    P = min(cfg.rays_per_batch, w * h * spp)
    k = torch.arange(P, device=dev)
    o, d, tm, _ = generate_rays(camera_tuple(scene.camera), k % (w * h),
                                k // (w * h), w, h, cfg.seed)
    rays = torch.cat([o, d, tm[:, None], torch.zeros_like(tm)[:, None]],
                     dim=1).contiguous()
    sph, quad = pallas_hit.pack_geometry(scene, dev)
    err = check_k6(rays, sph, quad, cfg.t_min, "scene 0's first pool")
    ms = device_ms(lambda: pallas_hit.closest_geo_cuda(rays, sph, quad,
                                                       cfg.t_min),
                   "closest_geo_kernel")
    plain_ms, _ = once_ms(lambda: pallas_hit.closest_geo_plain(
        rays, sph, quad, cfg.t_min))
    n_s, n_q = active_prims(sph, pallas_hit.SPH_ACTIVE, quad,
                            pallas_hit.QUAD_ACTIVE)
    k6 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
              bound=bound(nbytes(sph, quad) + 40 * P,
                          P * (n_s * OPS_XSPHERE + n_q * OPS_XQUAD)))
    print(f"  K6 on {P} rays: {ms:.4f} ms a launch (torch.profiler), plain "
          f"{plain_ms:.2f} ms; {n_s} spheres, {n_q} quads; bound "
          f"{k6['bound'][0]:.4f} ms ({k6['bound'][1]})", flush=True)

    k1_img = flat(render(scene, meta, cfg, device=dev))
    plain_s, plain_img = once_s(lambda: flat(render(
        scene, meta, cfg.with_(engine="wavefront"), device=dev)))
    print(f"  references: K1's mega2 frame; the plain wavefront frame, "
          f"{plain_s:.2f} s on the card", flush=True)
    launches = {}
    for engine, wrapper, kname in (
            ("wavefront_pallas", pallas_hit.closest_geo_cuda,
             "closest_geo_kernel"),
            ("mega", mega.mega_bounces_cuda, "mega_bounces_kernel")):
        ecfg = cfg.with_(engine=engine)
        wrapper.launches = 0
        sec, img = timed(lambda: render(scene, meta, ecfg, device=dev))
        launches[kname] = wrapper.launches
        print(f"  {engine}: best of 3 {sec:.4f} s, {w * h * spp / sec / 1e6:.2f}"
              f" M rays/s on {card}; {wrapper.launches} launches over 4 "
              f"frames ({wrapper.launches // 4} loop iterations a frame, one "
              f"host sync each)", flush=True)
        if wrapper.launches < 4:
            raise AssertionError(f"{engine} did not launch its kernel")
        t0 = time.perf_counter()
        frame_split(device_events(lambda: render(scene, meta, ecfg,
                                                 device=dev), 1),
                    kname, sec * 1e3)
        print(f"    (profiled frame and its reading: "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        img = flat(img)
        compare(img, k1_img, f"{engine} vs K1's frame")
        compare(img, plain_img, f"{engine} vs the plain wavefront frame",
                max_frac=MAX_FRAC_PLAIN_WF)
    k6["launches"] = launches["closest_geo_kernel"]

    scene, meta, cfg, label = compile_cfg(9, w, h, spp)
    print(f"  scene 9 texture: {label}", flush=True)
    s9, img9 = once_s(lambda: flat(render(
        scene, meta, cfg.with_(engine="wavefront_pallas"), device=dev)))
    print(f"  scene 9 wavefront_pallas: {s9:.2f} s on {card}", flush=True)
    compare(img9, flat(render(scene, meta, cfg, device=dev)),
            "scene 9 wavefront_pallas vs K1's frame")
    return {"closest_geo": k6,
            "mega_bounces_launches": launches["mega_bounces_kernel"]}

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)

    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)

    t0 = time.perf_counter()
    builds = build_kernels()
    print(f"[2] kernel builds, in parallel: {time.perf_counter() - t0:.2f} s",
          flush=True)
    for kname, build in builds.items():
        print(f"  {kname}: {build['seconds']:.2f} s ({build['path']})",
              flush=True)
        for ln in build["ptxas"].splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"    ptxas: {ln.strip()}", flush=True)

    print("[3] RNG and raygen on the card", flush=True)
    phase_rng(dev)

    w, h, spp = SMALL
    print(f"[4] K1 vs plain, all scenes at {w}x{h}@{spp}, max_bounces 50",
          flush=True)
    launches0 = mega2.render_radiance_cuda.launches
    for sid in range(10):
        scene, meta, cfg, label = compile_cfg(sid, w, h, spp)
        if label:
            print(f"  scene {sid} texture: {label}", flush=True)
        tab = mega2.pack_mega2_tables(scene, meta, dev)
        fp = mega2.frame_params(scene, cfg)
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        k1 = image_of(mega2.render_radiance_cuda(tab, pix, fp), spp)
        plain = image_of(mega2.render_radiance_plain(tab, pix, fp), spp)
        compare(k1, plain, f"scene {sid} ({SCENE_NAMES[sid]})")
    if mega2.render_radiance_cuda.launches <= launches0:
        raise AssertionError("K1 launch counter did not rise")

    w, h, spp = MAIN
    print(f"[5] main path: ops/render.render, scene 0 at {w}x{h}@{spp}",
          flush=True)
    scene, meta, cfg, _ = compile_cfg(0, w, h, spp)
    mega2.render_radiance_cuda.launches = 0
    sec, img = timed(lambda: render(scene, meta, cfg, device=dev,
                                    out_u8=True))
    launches = mega2.render_radiance_cuda.launches
    if launches < 1:
        raise AssertionError("the main path did not launch K1")
    print(f"  best of 3: {sec:.4f} s, {w * h * spp / sec / 1e6:.2f} M "
          f"rays/s on {card} (render(): packing, K1, epilogue, readback); "
          f"K1 launches {launches}", flush=True)
    if img.shape != (h, w, 3) or not img.any():
        raise AssertionError("main-path image is empty or misshapen")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene0.ppm")
        write_ppm(path, img)
        with open(path) as f:
            head = [f.readline().strip() for _ in range(3)]
    if head != ["P3", f"{w} {h}", "255"]:
        raise AssertionError(f"bad PPM header {head}")
    print(f"  PPM header {head}", flush=True)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    k1_frame, fb = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    u8 = finalize(fb, spp, gamma=True, out_u8=True).cpu().numpy()
    if not np.array_equal(u8.reshape(h, w, 3)[::-1], img):
        raise AssertionError("main-path frame differs from K1's frame")
    print(f"  K1 alone: {k1_frame:.4f} s for the frame on {card}",
          flush=True)
    sub = pix[::STRIDE]
    main_st = compare(
        image_of(fb[sub.long()], spp),
        image_of(mega2.render_radiance_plain(tab, sub, fp), spp),
        f"scene 0 every {STRIDE}th pixel")

    w, h, spp = SIDE
    print(f"[6] scene 9 at {w}x{h}@{spp}; K1 and plain timed on scene 0",
          flush=True)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    scene, meta, cfg, label = compile_cfg(9, w, h, spp)
    print(f"  scene 9 texture: {label}", flush=True)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg)
    s9, fb = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    print(f"  scene 9 K1: {s9:.4f} s on {card}", flush=True)
    sub = pix[::STRIDE]
    compare(image_of(fb[sub.long()], spp),
            image_of(mega2.render_radiance_plain(tab, sub, fp), spp),
            f"scene 9 every {STRIDE}th pixel")
    scene, meta, cfg, _ = compile_cfg(0, w, h, spp)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg)
    k1_s, _ = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    plain_s, _ = timed(lambda: mega2.render_radiance_plain(tab, pix, fp),
                       repeats=1)
    k1_s2, _ = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    print(f"  scene 0 K1: {k1_s:.4f} s, then {k1_s2:.4f} s; plain "
          f"{plain_s:.4f} s; on {card}", flush=True)
    # K1's bound: this frame's lane-bounces, counted from K2's tape of the
    # same (pixel, sample) lanes at the same depth
    lane_pix, lane_samp = mega2.tape_lanes(pix, spp)
    k1_lb = lane_bounces(tab, mega2.trace_tapes_cuda(tab, lane_pix,
                                                     lane_samp, fp))
    k1_bound = bound(table_bytes(tab) + pix.shape[0] * (4 + 12),
                     k1_lb * pair_ops(tab))
    print(f"  K1 bound at scene 0 {w}x{h}@{spp}: {k1_lb} lane-bounces, "
          f"{k1_bound[0]:.3f} ms ({k1_bound[1]})", flush=True)

    w, h, spp, K = TRACE
    print(f"[7] K2 vs plain, all scenes at {w}x{h}, spp {spp}, K {K}",
          flush=True)
    phase_trace(dev)

    w, h, spp, K = REPLAY
    print(f"[8] K3 / K4 vs replay_plain and its autograd, all scenes at "
          f"{w}x{h}, spp {spp}, K {K}", flush=True)
    phase_replay(dev)

    w, h, spp, K = TRAIN
    print(f"[9] main path: parallel/train.make_train_step_mega2, scene 0 at "
          f"{w}x{h}, spp {spp}, K {K}, Adam lr 1e-2", flush=True)
    recs = phase_train(dev, card)

    w, h, spp, iters = POOL
    print(f"[10] K6 vs closest_geo_plain, all scenes: the first {iters} "
          f"iterations of a plain wavefront pool at {w}x{h}@{spp}",
          flush=True)
    phase_closest_geo(dev)

    w, h, spp = MEGA_FRAME
    print(f"[11] K5 vs mega_bounces_plain, scenes {MEGA_SCENES}: two calls "
          f"on the {w * h * spp}-lane pool of a {w}x{h}@{spp} frame",
          flush=True)
    k5 = phase_mega_bounces(dev)

    w, h, spp = MAIN
    print(f"[12] main path: ops/render.render, engines wavefront_pallas and "
          f"mega, scene 0 at {w}x{h}@{spp}; scene 9 through "
          f"wavefront_pallas", flush=True)
    xla = phase_xla_frames(dev, card)
    recs["mega_bounces"] = dict(launches=xla["mega_bounces_launches"], **k5)
    recs["closest_geo"] = xla["closest_geo"]

    if any(m.startswith(("jax", "raytracinginoneweekendincuda_tpu"))
           for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    recs = {"mega2_render": dict(
        launches=launches, max_abs_err=main_st["max_abs"],
        ms=min(k1_s, k1_s2) * 1e3, plain_ms=plain_s * 1e3, bound=k1_bound),
        **recs}
    replaces = {
        "mega2_render": "raytracinginoneweekendincuda_tpu/ops/mega2.py:797",
        "mega2_trace": "raytracinginoneweekendincuda_tpu/ops/mega2.py:797",
        "replay_fwd":
            "raytracinginoneweekendincuda_tpu/ops/pallas_replay.py:655",
        "replay_bwd":
            "raytracinginoneweekendincuda_tpu/ops/pallas_replay.py:693",
        "mega_bounces": "raytracinginoneweekendincuda_tpu/ops/mega.py:218",
        "closest_geo":
            "raytracinginoneweekendincuda_tpu/ops/pallas_hit.py:106",
    }
    print(json.dumps({"kernels": [{
        "name": kname,
        "route": "cuda",
        "source": f"raytracinginoneweekendincuda_torch/csrc/{kname}.cu",
        "replaces": replaces[kname],
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1],
        "library_ms": None,
    } for kname, r in recs.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
