"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout -- K1
(``csrc/mega2_render.cu``), K2 (``csrc/mega2_trace.cu``), K3
(``csrc/replay_fwd.cu``), K4 (``csrc/replay_bwd.cu``), K5
(``csrc/mega_bounces.cu``), K6 (``csrc/closest_geo.cu``) and the probes
P1-P3 (``csrc/probe_pair.cu``, ``probe_intmul.cu``, ``probe_mosaic.cu``),
one nvcc each, all started together -- and drives the port's six paths:
the render (the CLI's ``ops/render.render``, engine ``mega2``, at the
reference's headline config, and on a world large enough for the chunk
cull), the training step
(``parallel/train.make_train_step_mega2``), the XLA-family engines
(``render`` with ``wavefront_pallas`` and ``mega``), the probe tools
(``tools/probe_*.main``) and the general train step
(``parallel/train.make_train_step``, plain PyTorch, held against K2-K4)
and the BVH engines (``render`` with ``bvh`` and ``wavefront_bvh``, plain
PyTorch, held against the brute-force engines and the f64 oracle),
holding every kernel against its plain PyTorch version.  Phases:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the kernels' build times and ptxas reports;
3. pcg4d draws and ``generate_rays`` on the card, bit-exact against the
   numpy uint32 reference / the CPU port;
4. K1 against ``render_radiance_plain`` on the card, radiance sums
   array-equal: all ten scenes at 64x32@4, max_bounces 50, scene 0's
   pixel ids permuted, padded with -1, 31 and 389 of them; the large
   worlds (``models/scenes.sphere_field``, 3,200 and 10,000 spheres at
   32x16@2, the chunk cull engaged, rows in shared and in global memory),
   and scenes 9 and 0 with every chunk culled; each with K1's launch
   shape;
5. the main path: scene 0 at 1440x720@10 through ``render``, best of 3,
   with K1's launch count over that run; the PPM is written and checked;
   K1 alone on the frame (best of 3) and the u8 frame's SHA-256; K1's
   sums array-equal to the plain version's on the whole frame (more ids
   than lanes, so lanes refill), and the plain version's time;
6. K1's bound at the main path's frame, from its lane-bounces counted
   from K2's tapes in chunks of 72 rows, and the lane shares of a nested
   and a flat loop (`tools/lane_share.py`); scene 9 at 360x180@10 through
   K1 against the plain version on every 97th pixel id, and K1 and the
   plain version timed at scene 0 360x180@10 with that frame's bound and
   lane shares;
7. K2 against ``trace_tapes_plain``: all ten scenes at 64x32, spp 2, K 8
   (at most 0.1% of lanes may differ), and scene 0's pixel ids permuted
   with 257 padding lanes (pix < 0, all -1) and mixed samples; K2's
   in-kernel raygen against external rays from ``generate_rays`` on a
   pinhole scene; and K2 on the 3,200-sphere world at 32x16, spp 2, K 8
   with the cull, identical on every lane to K2 without it and to the
   plain version;
8. K3 / K4 against ``replay_plain`` and its autograd: all ten scenes at
   64x32, spp 1, K 8 (forward: K1's bounds; backward: d_rep rel-L2 <=
   1e-3, at most 1% of lanes whose d_rays or d_bg differ by more than
   1e-3 of the largest), and K4 on ``sphere_field(FIELD_SMALL)`` at phase
   7's 32x16 (sample 0, K 8), a table above the opt-in; with K3's and
   K4's ptxas reports, K3's launch shapes, and each K4 launch's shape and
   d_rep memory (shared where it fits beside the states, else global:
   scene 9 and the large world);
9. the training step at full width: scene 0 at 640x360, spp 8, K 8
   (1.84 M lanes), Adam lr 1e-2, one warm-up and three timed steps, split
   into phases with CUDA events (the forward into the replay table,
   camera rays x spp, K3 x spp and the loss), with the K2 / K3 / K4 launch
   counts of that run; the device's busy share of a step (torch.profiler's
   kernel time over the unprofiled step); the lane shares of K2's tapes
   (`tools/lane_share.trace_shares`) and K2 against its plain version on
   all lanes, K3 and K4 against ``replay_plain`` and its autograd on all of
   sample 0's lanes (the shape the step launches them at; K3's launch
   shape and ptxas report, K4's launch shape, d_rep in shared memory), K4
   also on every 97th pixel; each kernel timed alone against its plain
   version;
   then the scene-4 loss-decrease check (12x8, 4 steps);
10. K6 against ``closest_geo_plain`` on all ten scenes (tables in shared
    memory) and on ``sphere_field()`` (10,001 spheres: tables above the
    opt-in, read from global memory), on the rays of the first three
    iterations of a plain ``wavefront`` pool at 64x32@2 (``t`` bit-equal,
    ``prim`` equal on at least 99.9% of lanes);
11. K5 against ``mega_bounces_plain`` on scenes 0, 1, 4, 6, 7 and 8, two
    calls on a full 8192-lane pool (``ri`` equal on at least 99.9% of
    lanes, ``rf`` within K1's bounds); K5 timed on scene 0's pool, the
    main path's shape (K2-K6 alone are timed by CUDA events, in batches
    of back-to-back launches behind a sleep kernel);
12. the XLA-family path at full width: scene 0 at 1440x720@10 through
    ``render`` with ``wavefront_pallas`` (K6) and ``mega`` (K5), best of
    3, with the launch counts (one launch per loop iteration), the
    kernel's device ms per launch and the device's busy share of a frame
    (torch.profiler); both frames held against K1's ``mega2`` frame and
    the plain ``wavefront`` frame, all on the card; K6 against its plain
    version on the main path's first pool (131072 camera rays) of scenes
    0 and 9, each timed; scene 9 at 1440x720@10 through
    ``wavefront_pallas``, timed and held against K1's frame;
13. the probes: ``main()`` of ``tools/probe_pair`` (C 512, REP 100 of the
    tool's 500, SUB 8, all 18 variants), ``probe_intmul`` (200 k of the
    tool's 5 M iterations) and ``probe_mosaic`` on the card, with every
    probe wrapper's launch count over those runs; then each P1 variant
    identical to its plain version at that shape (two copies of the
    block), the ``full`` / ``noreduce`` / ``dotsonly`` loops timed at C and
    2C and read in the SASS, K1's ns a sphere pair (phase 6) beside P1
    ``direct``'s; each P2 flavour identical to its plain version at 2000
    iterations, its loop's IMADs counted in the SASS (8 for i32mul and
    u32mul, 4 for u32mix; the phase fails without cuobjdump or a loop);
    each of the 13 P3 cases identical to its plain version (trig within
    2 ulp) on the tool's inputs and on seeded random ones of the same
    shapes, its kernel, plain version and library call timed (P3 in
    batches of back-to-back launches behind a sleep kernel, with CUDA
    events, as K2-K6); the two cases that lost to their library call
    (``transposed_onehot_dot``, ``gather_sublane``) timed again, kernel
    and library in turns, seven readings each, with their spread;
14. the main path on the large world: ``sphere_field()`` (10,000 spheres,
    157 chunks) at 1440x720@10 through ``render``, best of 3, with K1's
    launch count; K1 with the cull and with it forced off on the whole
    frame, both timed, array-equal but where the f32 sphere test without
    the cull reports a hit on a sphere that its ray misses in f64 (each
    such lane is found and checked: a rounding hit, which the culled
    kernel skips lane by lane, and the culled winner the ray's f64
    winner); K1 against the plain version on every
    97th pixel id, whose cull counts (slab tests, chunks and rows let
    through, per lane-bounce) and the frame's lane-bounces (K2's tapes)
    give K1's bound with the cull and without it;
15. the general train step at phase 9's configuration (scene 0 at
    640x360, spp 8, K 8, Adam lr 1e-2): engine ``taped``, one warm-up and
    three timed steps, and ``scan``, one warm-up and one timed step, each
    split at its marks by CUDA events, with its peak allocated memory,
    the device's busy share and launches of one profiled step, beside
    phase 9's mega2 step (and that step's peak memory); the port's
    kernels launched by those steps (none: plain PyTorch); then its
    gates: (b)1 the warm-up steps of the two engines (the same
    parameters; the gradients before the update) agree, loss within rel
    1e-5 and every leaf with a gradient within rel-L2 1e-3; (b)2
    ``replay.generate_tape`` on sample 0 against K2's tape in global ids,
    at least 97% of lanes identical over all bounces; (b)3 on K2's tape,
    ``replay.replay`` against K3 (K1's bounds) and autograd through it
    against K4 (the gradient of a seeded weighted sum of the radiance,
    every leaf within rel-L2 1e-3); (b)4 one step of each engine on scene
    4 at 12x8@2, K 4, on the card and on the CPU from the same
    parameters: loss within rel 1e-5, every leaf after Adam within rtol
    1e-5; (b)5 ``render`` with ``differentiable=True`` (``bruteforce``,
    scene 4 at 64x32@4) equal to the ``while`` form's frame on the card;
    (b)6 ``examples/recover_geometry.main`` on the card passes its own
    assert; (e) one more step of each engine from the start's parameters,
    its loss, gradients and leaves after Adam bit-identical to (a)'s
    warm-up step (a gate: the winner reads' backward, ``hit.row_sum``,
    adds in an order fixed by the data), the taped step timed with the
    winner reads as the parent's ``index_select``, as ``read_rows``, in
    turns (P C C P C P; a gate: the median backward by CUDA events grows
    by at most 10% of the median parent step; the host-clock ratio
    printed), and as
    ``index_select`` under deterministic algorithms from the forward's end
    to the backward's; the mega2 step twice from the start's parameters
    and a ``wavefront_pallas`` frame of scene 0 at 1440x720@10 twice,
    their equality reported, not gated; the phase's seconds;
16. the BVH engines (plain PyTorch, no kernel): the numpy build's time
    on scene 9 and ``sphere_field()``; (a) ``bvh_engine.traverse`` on
    phase 12's scene-9 pool (131,072 camera rays) on the card against
    its CPU run (``prim`` equal on at least 99.9% of lanes, ``t`` within
    rel 1e-6), its steps and ms a call beside K6's on the same rays; (b)
    scenes 0, 4 and 9 at 32x18@2, 8 bounces: ``bvh`` against
    ``bruteforce`` and ``wavefront_bvh`` against ``wavefront`` in f64 (at
    most 2 pixels above 1e-9), ``wavefront_bvh`` against ``wavefront`` in
    f32 (phase 12's share of pixels above 1e-4, the mean printed), each
    frame timed; (c) ``bvh`` in f64, 50 bounces, against
    ``testing/oracle.Oracle`` at 96x54@2 on scenes 0 and 3
    (``assert_images_close``'s defaults); (d) ``wavefront_bvh`` timed
    against ``wavefront_pallas`` on scene 9 and against ``render()``'s
    mega2 on ``sphere_field()`` at 96x54@2, 8 bounces, with its
    iterations, traversal steps an iteration, launches and busy share
    (profiler), each frame against the other engine's as in (b).

Prints the kernel record and the card on lines of their own, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, before that
line, if any phase fails or there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import collections
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from raytracinginoneweekendincuda_torch.core import rng
from raytracinginoneweekendincuda_torch.core.image import write_ppm
from raytracinginoneweekendincuda_torch.examples import recover_geometry
from raytracinginoneweekendincuda_torch.models.scenes import (
    SCENE_NAMES, build_scene, sphere_field,
)
from raytracinginoneweekendincuda_torch.scene import api
from raytracinginoneweekendincuda_torch.scene.bvh import build_scene_bvh
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.testing.compare import (
    assert_images_close,
)
from raytracinginoneweekendincuda_torch.testing.oracle import Oracle
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from raytracinginoneweekendincuda_torch.ops import bvh_engine
from raytracinginoneweekendincuda_torch.ops import hit, integrator, mega
from raytracinginoneweekendincuda_torch.ops import mega2, pallas_hit
from raytracinginoneweekendincuda_torch.ops import replay as rp
from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc
from raytracinginoneweekendincuda_torch.ops.raygen import (
    camera_tuple, generate_rays,
)
from raytracinginoneweekendincuda_torch.ops.render import finalize, render
from raytracinginoneweekendincuda_torch.parallel import train
from raytracinginoneweekendincuda_torch.tools import (
    cull_share, probe_intmul, probe_mosaic, probe_pair,
)
from raytracinginoneweekendincuda_torch.tools.common import best_ms
from raytracinginoneweekendincuda_torch.tools.kernel_times import (
    first_pool, replay_inputs, step_phase_ms, train_setup,
)
from raytracinginoneweekendincuda_torch.tools.lane_share import (
    lane_shares, path_bounces, trace_shares,
)
from raytracinginoneweekendincuda_torch.utils.benchmark import card_line

TOL_ABOVE = 1e-4          # a pixel "differs" when a channel moves more
MAX_FRAC_ABOVE = 0.01     # at most 1% of pixels may differ
MAX_MEAN = 2e-3           # mean absolute difference over all channels
STRIDE = 97               # pixel-id stride of the main-path check subset
TAPE_CHUNK = 1440 * 72    # pixels a K2 trace when counting a frame's paths
NO_SPILLS = ("mega2_render", "mega2_trace", "replay_bwd", "mega_bounces",
             "closest_geo")                     # sized to hold no spills
MAIN = (1440, 720, 10)    # the main path's frame: width, height, spp
SMALL = (64, 32, 4)       # every scene, K1 against the plain version
SIDE = (360, 180, 10)     # scene 9, and the K1 / plain timing of scene 0
FIELD = (32, 16, 2)       # the large worlds' frame: width, height, spp
FIELD_SMALL = 3200        # sphere_field spheres: 51 chunks, rows in shared
FIELD_LARGE = 10_000      # and 157 chunks, rows in global memory
CULL_FORCED = dict(dense_max=0, cull_min_chunks=0)   # cull every chunk
CULL_OFF = dict(cull_min_chunks=10 ** 9)             # cull no chunk
TRACE = (64, 32, 2, 8)    # every scene, K2 against the plain version
TRACE_FIELD = (32, 16, 2, 8)   # K2 on sphere_field(FIELD_SMALL / _LARGE)
REPLAY = (64, 32, 1, 8)   # every scene, K3 / K4 against the plain version
TRAIN = (640, 360, 8, 8)  # the training step: width, height, spp, K
GENERAL_SMALL = (4, 12, 8, 2, 4)   # phase 15 (b)4: scene, w, h, spp, K
DIFF_RENDER = (4, 64, 32, 4)       # phase 15 (b)5: scene, w, h, spp
# Phase 16.  A BVH traversal step is ~130 small PyTorch launches, and an
# engine runs one traversal a bounce over the whole batch or pool, so its
# frames are launch-bound: at the reference's 50 bounces (c)'s scene-0
# frame alone takes 84 traversals.  (b) and (d) cut the depth to BVH_DEPTH
# bounces to keep the phase near two minutes; (c), the oracle's parity,
# keeps 50.
BVH_FRAME = (32, 18, 2)   # phase 16 (b): every engine pair's frame
BVH_SCENES = (0, 4, 9)    # and its scenes
BVH_DEPTH = 8             # (b) and (d): bounces
BVH_ORACLE = (96, 54, 2)  # phase 16 (c): bvh against the oracle
ORACLE_SCENES = (0, 3)
BVH_TIMED = (96, 54, 2)   # phase 16 (d): the timed wavefront_bvh frames
TAPE_AGREE = 0.97         # XLA tape vs K2: share of identical lanes
                          # (tests/test_replay.py's bound: f32 ties)
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
# a chunk's slab test (chunk_visible: six subtractions, six multiplies,
# twelve min / max, a multiply and two compares) 26; the three sanitized
# reciprocals of a culled bounce are in OPS_BOUNCE's margin
OPS_SLAB = 26
OPS_REPLAY, OPS_REPLAY_BWD = 160, 570
# FP32 ops per pair test of csrc/xla_pair.cuh (K5, K6): a sphere through
# the sign of its discriminant (moving centre, oc, half-b, cc, disc) 28 --
# the roots follow only where it is positive -- and a quad (plane hit,
# interior test, compares) 39; the rest of a K5 bounce (record, texture,
# RNG, scatter) 120, a medium 45.
OPS_XSPHERE, OPS_XQUAD, OPS_XBOUNCE, OPS_XMEDIUM = 28, 39, 120, 45
# The probes' main path: P1 at C 512, SUB 8 with REP cut from the tool's 500
# to 100; P2 with its 5 M iterations cut to 200 k, its records' ms and
# bound at that count; P2 against its plain version (a Python loop of ~40
# launches an iteration) at 2000.
PAIR_MAIN = (512, 100, 8)
INTMUL_MAIN, INTMUL_CHECK = 200_000, 2_000
TRIG_ULP = 2              # P3 trig: kernel against the plain version
# FP32 ops a pair of each P1 kernel variant (csrc/probe_pair.cu; a compare
# or select one op): the two coefficient dots 64 (k8dot 32; nodots 2; the
# direct quadratic 15), then discriminant 3, root 1, keys 2, select 5,
# reduce 2 (noselect: one add for the select); per lane-iteration 17
# (tweak, od, features, result).  noreduce and dotsonly need only
# primitive 0.
OPS_PAIR = {"full": 77, "bf16dot": 77, "nodots": 15, "nosqrt": 77,
            "noselect": 73, "noidx": 77, "noreduce": 75, "dotsonly": 65,
            "k8dot": 45, "direct": 28}
OPS_PAIR_ITER = 17
# coefficient loads a pair (the SASS's loop is read per pair with them)
LOADS_PAIR = {"nodots": 2, "k8dot": 16, "direct": 4}
LOADS_PAIR.update({v: 32 for v in OPS_PAIR if v not in LOADS_PAIR})
# P2: instructions of a chain iteration (FP32 for f32mul, INT32 otherwise)
OPS_INTMUL = {"f32mul": 16, "i32mul": 8, "u32mul": 8, "u32addxor": 24,
              "u32mix": 12}
INT32_LANES = 64          # INT32 lanes of a Hopper SM
PROBE_BATCH = 20          # back-to-back launches a timed P3 batch
P3_RETIME = ("transposed_onehot_dot", "gather_sublane")   # lost to their
RETIME_ROUNDS = 7         # library call (PERF.md): timed again, in turns
KERNEL_BATCH = 10         # back-to-back launches a timed K2-K6 batch


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
            unit: str = "pixels", max_frac: float = MAX_FRAC_ABOVE,
            max_mean: float = MAX_MEAN) -> dict:
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
            or stats["mean_abs"] >= max_mean:
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


def device_events(fn, repeats: int, warm: bool = True) -> list:
    """(name, device microseconds, launches) of every kernel that
    ``repeats`` calls of ``fn`` ran, from torch.profiler, after one
    warm-up call (none if not ``warm``).  Sums the profiler's raw device
    records by name (``key_averages`` takes minutes over the ~340 k
    launches of a full ``mega`` frame)."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
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


def device_ms(fn, dev) -> float:
    """Device milliseconds of one call of a kernel's wrapper ``fn``: CUDA
    events around batches of ``KERNEL_BATCH`` back-to-back calls behind a
    sleep kernel that hides the wrapper's host time, best of 5
    (``tools/common.best_ms``).  The wrappers allocate their outputs
    without a launch, but for K4's zeroed ``d_rep`` (one fill).  Not
    torch.profiler: in a long process it at times returns no device
    record of a kernel that ran."""
    return best_ms(fn, dev, 5, KERNEL_BATCH)


LOADERS = {"mega2_render": mega2.load_kernel,
           "mega2_trace": mega2.load_trace_kernel,
           "replay_fwd": rc.load_fwd_kernel,
           "replay_bwd": rc.load_bwd_kernel,
           "mega_bounces": mega.load_kernel,
           "closest_geo": pallas_hit.load_kernel,
           "probe_pair": probe_pair.load_kernel,
           "probe_intmul": probe_intmul.load_kernel,
           "probe_mosaic": probe_mosaic.load_kernel}


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


def path_counts(tab, fp, pix: torch.Tensor,
                chunk: int = TAPE_CHUNK) -> torch.Tensor:
    """Bounces each (sample, pixel) path of the frame ran [spp, P], from
    K2's tapes of the same lanes at the same depth, ``chunk`` pixels (all
    their samples) a trace."""
    counts = torch.empty((fp.spp, pix.shape[0]), dtype=torch.int32,
                         device=pix.device)
    for a in range(0, pix.shape[0], chunk):
        part = pix[a:a + chunk]
        lane_pix, lane_samp = mega2.tape_lanes(part, fp.spp)
        tape = mega2.trace_tapes_cuda(tab, lane_pix, lane_samp, fp)
        counts[:, a:a + part.shape[0]] = path_bounces(
            tape, tab.attr, tab.np_rows).reshape(fp.spp, -1)
    return counts


def k1_equal(tab, fp, pix: torch.Tensor, what: str) -> None:
    """K1's radiance sums against the plain version's: array-equal."""
    got = mega2.render_radiance_cuda(tab, pix, fp).cpu().numpy()
    want = mega2.render_radiance_plain(tab, pix, fp).cpu().numpy()
    same = int((got == want).all(1).sum())
    print(f"  {what}: {same}/{pix.shape[0]} sums identical; launch "
          f"(blocks, threads, shared bytes) "
          f"{mega2.render_radiance_cuda.shape}; cull {culled(tab)}",
          flush=True)
    if not np.isfinite(got).all() or not np.array_equal(got, want):
        raise AssertionError(f"{what}: K1 differs from the plain version")


def culled(tab) -> str:
    """Which chunks the tables cull: "pairs+boxes", "pairs", "boxes" or
    "none"."""
    kinds = [k for k, on in (("pairs", tab.cull_pairs),
                             ("boxes", tab.cull_boxes)) if on]
    return "+".join(kinds) or "none"


def field_tables(n: int, w: int, h: int, dev, **pack):
    """(scene, meta, tables) of ``sphere_field(n)`` at w x h; ``pack``
    goes to the packer (its cull thresholds)."""
    scene, meta = compile_scene(sphere_field(n), w, h, dtype=np.float32)
    return scene, meta, mega2.pack_mega2_tables(scene, meta, dev, **pack)


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
              f"{pix.shape[0]} lanes identical; launch (blocks, threads, "
              f"shared bytes) {mega2.trace_tapes_cuda.shape}", flush=True)
        if differ > MAX_DIFF_LANES:
            raise AssertionError(f"K2 differs on scene {sid}")
        if mega2.trace_tapes_cuda.shape[2] == 0:
            raise AssertionError(f"K2 did not stage scene {sid}'s rows")
    # the lane queue on a permuted pixel list padded with pix < 0 lanes,
    # samples mixed (scene 0: lens rays)
    rs = np.random.default_rng(5)
    ids = np.insert(rs.permutation(w * h), rs.integers(0, w * h, 257), -1)
    lp = torch.as_tensor(ids.astype(np.int32), device=dev)
    ls = torch.as_tensor(rs.integers(0, 2 * spp, ids.shape[0]).astype(
        np.int32), device=dev)
    scene, meta, cfg, _ = compile_cfg(0, w, h, 1, K)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, cfg)
    got = mega2.trace_tapes_cuda(tab, lp, ls, fp)
    want = mega2.trace_tapes_plain(tab, lp, ls, fp)
    same = int((got == want).all(0).sum())
    print(f"  scene 0, {w * h} pixel ids permuted with 257 padding lanes: "
          f"{same}/{lp.shape[0]} lanes identical; padding lanes all -1: "
          f"{bool((got[:, lp < 0] == -1).all())}", flush=True)
    if same < (1 - MAX_DIFF_LANES) * lp.shape[0] \
            or not bool((got[:, lp < 0] == -1).all()):
        raise AssertionError("K2 differs on the permuted, padded list")
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
    # the chunk cull, culled and not, every lane: the 3,200-sphere world
    # (rows in shared memory), culled K2 identical to the unculled K2 and
    # to the plain version; the 10,000-sphere world (rows in global
    # memory), each instantiation identical to the plain version on the
    # same tables
    w, h, spp, K = TRACE_FIELD
    pix, samp = mega2.tape_lanes(
        torch.arange(w * h, dtype=torch.int32, device=dev), spp)
    for n, staged in ((FIELD_SMALL, True), (FIELD_LARGE, False)):
        tapes = {}
        for what, pack in (("culled", {}), ("unculled", CULL_OFF)):
            scene, meta, tab = field_tables(n, w, h, dev, **pack)
            fp = mega2.frame_params(scene, RenderConfig(
                width=w, height=h, samples_per_pixel=1, max_bounces=K))
            tapes[what] = mega2.trace_tapes_cuda(tab, pix, samp, fp)
            shape = mega2.trace_tapes_cuda.shape
            if (shape[2] > 0) != staged:
                raise AssertionError(f"sphere_field({n}), {what}: K2's rows "
                                     f"went to the wrong memory")
            if tab.cull_pairs != (what == "culled"):
                raise AssertionError(f"sphere_field({n}), {what}: the "
                                     f"tables cull {tab.cull_pairs}")
            plain = mega2.trace_tapes_plain(tab, pix, samp, fp)
            same = int((tapes[what] == plain).all(0).sum())
            print(f"  sphere_field({n}) at {w}x{h}, spp {spp}, K {K}: "
                  f"{what} K2 {same}/{pix.shape[0]} lanes identical to the "
                  f"plain version; launch (blocks, threads, shared bytes) "
                  f"{shape}", flush=True)
            if not torch.equal(tapes[what], plain):
                raise AssertionError(f"sphere_field({n}): {what} K2 differs "
                                     f"from the plain version")
        if n == FIELD_SMALL:
            same = int((tapes["culled"] == tapes["unculled"]).all(0).sum())
            print(f"  sphere_field({n}): culled K2 {same}/{pix.shape[0]} "
                  f"lanes identical to the unculled K2", flush=True)
            if not torch.equal(tapes["culled"], tapes["unculled"]):
                raise AssertionError("culled K2 differs from the unculled "
                                     "tapes")


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


def ptxas_kernels(report: str) -> list:
    """(entry function, registers, stack bytes, spill-store bytes) of each
    kernel of a ``ptxas -v`` report."""
    return [(m.group(1), int(m.group(4)), int(m.group(2)), int(m.group(3)))
            for m in re.finditer(
                r"Compiling entry function '(\S+)'.*?(\d+) bytes stack "
                r"frame, (\d+) bytes spill stores.*?Used (\d+) registers",
                report, re.S)]


def k4_ptxas(report: str) -> str:
    """K4's instantiations in its ptxas report: registers, stack, spills."""
    return "; ".join(
        f"{'shared' if 'ILb1E' in name else 'global'} d_rep {regs} "
        f"registers, {stack}-byte stack, {spill} bytes spilled"
        for name, regs, stack, spill in ptxas_kernels(report)
        if "replay_bwd_kernel" in name)


def k3_ptxas(report: str) -> str:
    """K3's kernel in its ptxas report: registers, stack, spills."""
    return "; ".join(
        f"{regs} registers, {stack}-byte stack, {spill} bytes spilled"
        for name, regs, stack, spill in ptxas_kernels(report)
        if "replay_fwd_kernel" in name)


def k4_launch(what: str, rep_shared: bool) -> None:
    """Prints K4's last launch; raises if it summed d_rep in the other
    memory than ``rep_shared`` says."""
    got = rc.replay_bwd_cuda.rep_shared
    print(f"  {what}: K4 launch (blocks, threads, shared bytes) "
          f"{rc.replay_bwd_cuda.shape}, d_rep summed in "
          f"{'shared' if got else 'global'} memory", flush=True)
    if got != rep_shared:
        raise AssertionError(f"{what}: K4 summed d_rep in the wrong memory")


def phase_replay(dev, k3_report: str, k4_report: str) -> None:
    w, h, _, K = REPLAY
    print(f"  K3 ptxas: {k3_ptxas(k3_report)}", flush=True)
    print(f"  K4 ptxas: {k4_ptxas(k4_report)}", flush=True)
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
        print(f"  scene {sid}: K3 launch (blocks, threads, shared bytes) "
              f"{rc.replay_fwd_cuda.shape}", flush=True)
        grad_check(tt, rays, tape, pc, bg, g, fp.t_min, f"scene {sid} K4")
        k4_launch(f"scene {sid} ({tt.NP} table rows)", rc.bwd_rep_in_shared(
            tt.NP, K, rc.bwd_smem_optin()))
    # a table above the opt-in: sphere_field(FIELD_SMALL), sample 0 of
    # phase 7's frame, its tape traced by K2 (the chunk cull engaged)
    w, h, _, K = TRACE_FIELD
    scene, meta, tab = field_tables(FIELD_SMALL, w, h, dev)
    fp = mega2.frame_params(scene, RenderConfig(
        width=w, height=h, samples_per_pixel=1, max_bounces=K))
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    tape = mega2.trace_tapes_cuda(tab, pix, torch.zeros_like(pix), fp)
    tt, rays, tape, pc, bg, g = replay_inputs(scene, meta, tab, fp, pix, 0,
                                              tape, dev)
    grad_check(tt, rays, tape, pc, bg, g, fp.t_min,
               f"sphere_field({FIELD_SMALL}) at {w}x{h}, K {K}, K4")
    k4_launch(f"sphere_field({FIELD_SMALL}) ({tt.NP} table rows)", False)


def phase_train(dev, card: str, k3_report: str, k4_report: str):
    """The training step at full width; returns the kernels' numbers, and
    the step's (ms per step, busy share, launches per step) for phase 15
    (None where the profiler returned no device record)."""
    W, H, spp, K = TRAIN
    P, L = W * H, W * H * spp
    pix_all = torch.arange(P, dtype=torch.int32, device=dev)
    # target: K1's render of scene 0; the start: albedos perturbed
    start, meta, cfg, target, state, step = train_setup((0, *TRAIN), dev)
    pix = np.arange(P, dtype=np.int32)

    counters = (mega2.trace_tapes_cuda, rc.replay_fwd_cuda,
                rc.replay_bwd_cuda)
    for c in counters:
        c.launches = 0
    state, loss = step(state, pix, target)               # warm-up
    torch.cuda.synchronize()
    losses, walls, split, box = [float(loss)], [], {}, [state]
    for _ in range(3):
        t0 = time.perf_counter()
        phases, loss = step_phase_ms(step, box, pix, target)
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        for name, ms in phases.items():
            split.setdefault(name, []).append(ms)
    state = box[0]
    launches = [c.launches for c in counters]
    print(f"  {W}x{H}, spp {spp}, K {K} ({P * spp} lanes): ms per step "
          f"{np.mean(walls):.2f} (best {min(walls):.2f}) on {card}",
          flush=True)
    mean = {n: float(np.mean(v)) for n, v in split.items()}
    fwd = ("derive", "raygen", "replay", "forward")
    print(f"  split (mean ms, CUDA events): pack {mean['pack']:.2f}, trace "
          f"{mean['trace']:.2f}, forward {sum(mean[n] for n in fwd):.2f} "
          f"(derive {mean['derive']:.2f}, raygen x {spp} "
          f"{mean['raygen']:.2f}, K3 x {spp} {mean['replay']:.2f}, loss "
          f"{mean['forward']:.2f}), backward {mean['backward']:.2f}, update "
          f"{mean['update']:.2f}  [pack: host packing + upload; trace: K2; "
          f"derive: the replay table; raygen: camera rays; K3: the replay "
          f"call and the sum; backward: K4 x spp + derive's backward; "
          f"update: Adam]", flush=True)
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
    if not evs:
        print(f"  device kernels of the {step_ms:.2f} ms step: not measured "
              f"(the profiler returned no device record)", flush=True)
    else:
        print(f"  device kernels {busy_ms:.2f} ms of the {step_ms:.2f} ms "
              f"step (busy {busy_ms / step_ms:.3f}, idle "
              f"{1 - busy_ms / step_ms:.3f}); {sum(n for *_, n in evs)} "
              f"launches; busiest: " + ", ".join(
                  f"{key[:40]} {us / 1e3:.2f} ms x{n}"
                  for key, us, n in evs[:6]), flush=True)

    # the kernels alone at the step's shapes, against their plain versions
    sc_np = train.merge_params(start, train.params_to_numpy(state.params))
    tab = mega2.pack_mega2_tables(sc_np, meta, dev)
    fp = mega2.frame_params(sc_np, cfg)
    lane_pix, lane_samp = mega2.tape_lanes(pix_all, spp)
    tapes = mega2.trace_tapes_cuda(tab, lane_pix, lane_samp, fp)
    print(f"  K2 launch (blocks, threads, shared bytes) "
          f"{mega2.trace_tapes_cuda.shape}; lane shares of its tapes (one "
          f"thread a lane keeps 'nested' busy): "
          f"{json.dumps(trace_shares(tapes, tab.attr, tab.np_rows, spp))}",
          flush=True)
    k2_plain_ms, plain_tapes = once_ms(lambda: mega2.trace_tapes_plain(
        tab, lane_pix, lane_samp, fp))
    same = float((tapes == plain_tapes).all(0).float().mean())
    k2_err = float((tapes - plain_tapes).abs().max())
    del plain_tapes
    print(f"  K2 on all {L} lanes: {same:.6f} of lanes identical to the "
          f"plain version", flush=True)
    if same < 1 - MAX_DIFF_LANES:
        raise AssertionError("K2 differs from its plain version")
    lb_all = int(path_bounces(tapes, tab.attr, tab.np_rows).sum())
    tape0 = tapes[:, :P].contiguous()                    # sample 0
    lb0 = int(path_bounces(tape0, tab.attr, tab.np_rows).sum())
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
    print(f"  K3 launch (blocks, threads, shared bytes) "
          f"{rc.replay_fwd_cuda.shape} for {P} lanes; ptxas: "
          f"{k3_ptxas(k3_report)}", flush=True)
    # K4 on the shape the step launches it: all of sample 0's lanes
    k4_st = grad_check(tt, rays, tape0, pc, bg, g, fp.t_min,
                       f"K4 sample 0, all {P} pixels")
    k4_launch(f"K4 sample 0 ({tt.NP} table rows)", True)
    print(f"  K4 ptxas: {k4_ptxas(k4_report)}", flush=True)
    k4_plain_ms = k4_st["plain_ms"]
    dev_ms = {
        "mega2_trace": device_ms(lambda: mega2.trace_tapes_cuda(
            tab, lane_pix, lane_samp, fp), dev),
        "replay_fwd": device_ms(lambda: rc.replay_fwd_cuda(
            tt, tt.rep.detach(), rays, tape0, pc, 0, bg, t_min=fp.t_min),
            dev),
        "replay_bwd": device_ms(lambda: rc.replay_bwd_cuda(
            tt, tt.rep.detach(), rays, tape0, pc, 0, bg, g, t_min=fp.t_min),
            dev),
    }
    print("  device ms per launch (CUDA events): " + ", ".join(
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
    return recs, (step_ms, busy_ms / step_ms if evs else None,
                  sum(n for *_, n in evs) if evs else None)


def pool_rays(desc, dev):
    """(ray_pack [N, 8], sphere table, quad table, t_min) of the scene
    description ``desc``: the rays of the first iterations of a plain
    ``wavefront`` pool.  Every work item of the POOL frame fits in one
    pool, so the pool starts with all its camera rays and then bounces
    them (`integrator.bounce_step` with the brute-force hit, as the engine
    does)."""
    w, h, spp, iters = POOL
    scene, meta = compile_scene(desc, w, h, dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp)
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
    """K6 on every scene's pool (tables in shared memory), and on the
    large world's pool, whose tables exceed the opt-in (global memory)."""
    for what, desc, staged in (
            *((f"scene {sid}", scene_desc(sid)[0], True)
              for sid in range(10)),
            (f"sphere_field({FIELD_LARGE})", sphere_field(FIELD_LARGE),
             False)):
        rays, sph, quad, t_min = pool_rays(desc, dev)
        check_k6(rays, sph, quad, t_min, what)
        shape = pallas_hit.closest_geo_cuda.shape
        print(f"    launch (blocks, threads, shared bytes) {shape}; tables "
              f"{nbytes(sph, quad)} bytes", flush=True)
        if (shape[2] > 0) != staged:
            raise AssertionError(f"{what}: K6's tables went to the wrong "
                                 f"memory")


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
                       dev)
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
              f"launch (CUDA events), plain {plain_ms:.2f} ms; "
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
    if k_n == 0:
        print(f"    device: not measured (the profiler returned no record "
              f"of {kernel})", flush=True)
        return {"kernel_ms": None, "busy": None}
    print(f"    device: {kernel} {k_us / 1e3:.2f} ms over {k_n} launches "
          f"({k_us / 1e3 / k_n:.4f} ms each), other kernels "
          f"{(all_us - k_us) / 1e3:.2f} ms, {sum(n for *_, n in evs)} "
          f"launches in all; busy {busy_ms / frame_ms:.3f} of the "
          f"{frame_ms:.1f} ms frame; busiest: " + ", ".join(
              f"{key[:32]} {us / 1e3:.1f} ms x{n}" for key, us, n in
              sorted(evs, key=lambda e: -e[1])[:5]), flush=True)
    return {"kernel_ms": k_us / 1e3 / k_n, "busy": busy_ms / frame_ms}


def phase_xla_frames(dev, card: str) -> dict:
    """The XLA-family engines at full width; returns K6's record at the
    main path's first pool and the launch counts of K5 and K6 over the
    main path's frames."""
    w, h, spp = MAIN
    scene, meta, cfg, _ = compile_cfg(0, w, h, spp)
    flat = lambda img: np.ascontiguousarray(img).reshape(-1, 3)

    # K6 at the main path's first pool: the camera rays of work items
    # 0 .. P-1; scene 0's record, scene 9's (the largest tables) beside it
    P = min(cfg.rays_per_batch, w * h * spp)
    for sid in (9, 0):
        sc = scene if sid == 0 else compile_cfg(sid, w, h, spp)[0]
        rays, sph, quad = first_pool(sc, w, h, P, cfg.seed, dev)
        err = check_k6(rays, sph, quad, cfg.t_min, f"scene {sid}'s first "
                       f"pool")
        shape = pallas_hit.closest_geo_cuda.shape
        ms = device_ms(lambda: pallas_hit.closest_geo_cuda(
            rays, sph, quad, cfg.t_min), dev)
        plain_ms, _ = once_ms(lambda: pallas_hit.closest_geo_plain(
            rays, sph, quad, cfg.t_min))
        n_s, n_q = active_prims(sph, pallas_hit.SPH_ACTIVE, quad,
                                pallas_hit.QUAD_ACTIVE)
        k6 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  bound=bound(nbytes(sph, quad) + 40 * P,
                              P * (n_s * OPS_XSPHERE + n_q * OPS_XQUAD)))
        print(f"  K6 on scene {sid}'s {P} rays: {ms:.4f} ms a launch (CUDA "
              f"events), plain {plain_ms:.2f} ms; {n_s} spheres, {n_q} "
              f"quads; bound {k6['bound'][0]:.4f} ms ({k6['bound'][1]}); "
              f"launch (blocks, threads, shared bytes) {shape}", flush=True)

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


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0])


def sass_loops(lib_path: str) -> dict:
    """{kernel template id: opcode counts of its innermost loop} of the
    ``*_kernel<N>`` functions in a built library, from ``cuobjdump -sass``
    (the loop: the shortest span that a backward branch closes).  Raises
    where the toolkit has no cuobjdump beside nvcc."""
    from raytracinginoneweekendincuda_torch.utils.cuda_build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise AssertionError(f"no cuobjdump beside nvcc ({tool}): the "
                             f"probes' SASS cannot be checked")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    loops = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        tid = re.search(r"kernelILi(\d+)E", fn.split("\n", 1)[0])
        if not tid:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
            r"([^;]*);", fn)]
        spans = [(int(m.group(1), 16), a) for a, op, rest in ins
                 if op == "BRA" and (m := re.search(r"0x([0-9a-f]+)", rest))
                 and int(m.group(1), 16) < a]
        if spans:
            lo, hi = min(spans, key=lambda sp: sp[1] - sp[0])
            loops[int(tid.group(1))] = collections.Counter(
                op for a, op, _ in ins if lo <= a <= hi)
    return loops


def build_path(name: str) -> str:
    """The built library of ``csrc/<name>.cu`` (loaded in phase 2)."""
    return LOADERS[name]()[1]["path"]


def sum_bounds(parts) -> tuple:
    """The bound of a set of launches: the sum of their bounds, labelled by
    the kind that holds most of it."""
    by = collections.Counter()
    for ms, kind in parts:
        by[kind] += ms
    return sum(by.values()), by.most_common(1)[0][0]


# library calls that compute a P3 probe's function (timed, used nowhere in
# the port): (case inputs) -> result
PROBE_LIBRARY = {
    "gather_lane": lambda t, i: torch.take_along_dim(t[:, :128], i, 1),
    "gather_lane_full": lambda t, i: torch.take_along_dim(t, i, 1),
    "gather_sublane": lambda t, i: torch.take_along_dim(t, i, 0),
    "dynamic_sublane_slice_dot": lambda a, b, c: torch.matmul(
        a.view(c, -1, a.shape[1]), b).sum(0),
    "f32_matmul": lambda a, b, c: torch.matmul(a, b),
    "transposed_onehot_dot": lambda w, a, hot: torch.matmul(
        a.T, (w == hot).float()),
    "gather_wide(256)": lambda t, i: torch.take_along_dim(t, i, 1),
    "gather_wide(65536)": lambda t, i: torch.take_along_dim(t, i, 1),
    "gather_wide(256, rows=24)": lambda t, i: torch.take_along_dim(t, i, 1),
    "gather_int32_wide(524288)": lambda t, i: torch.take_along_dim(t, i, 1),
    "trig": lambda x: torch.acos(torch.clamp(x, -1.0, 1.0))
    + torch.atan2(x, 1.0 - x),
}


def library_args(name: str, args) -> list:
    """A P3 case's inputs as its library call takes them (torch gathers
    with int64 indices)."""
    largs = list(args)
    if "gather" in name:
        largs[1] = args[1].long()
    return largs


def probe_ops(name: str, args, out) -> int:
    """FP32 ops of a P3 case: the dots' multiply-adds and the accumulated
    gathers' adds; the other probes only move bytes."""
    if name in ("dynamic_sublane_slice_dot", "f32_matmul"):
        a, _, chunks = args
        return 2 * out.numel() * a.shape[1] * chunks
    if name == "transposed_onehot_dot":
        return 2 * out.numel() * args[1].shape[0]
    if name == "gather_timing":
        return args[2] * out.numel()
    return 0


def phase_probes(dev, k1_pair) -> dict:
    """P1-P3: the three tools' main() on the card (the counted run), then
    every kernel against its plain version; returns the three records."""
    wrappers = {"probe_pair": (probe_pair.probe_pair_cuda,),
                "probe_intmul": (probe_intmul.intmul_chain_cuda,),
                "probe_mosaic": probe_mosaic.WRAPPERS}
    for ws in wrappers.values():
        for w in ws:
            w.launches = 0
    C, REP, SUB = PAIR_MAIN
    t0 = time.perf_counter()
    pair = probe_pair.main([str(C), str(REP), str(SUB)])
    intmul = probe_intmul.main(["--iters", str(INTMUL_MAIN)])
    probe_mosaic.main([])
    launches = {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}
    idle = [w.__name__ for ws in wrappers.values() for w in ws
            if w.launches == 0]
    print(f"  the tools' main(): {time.perf_counter() - t0:.1f} s; launches "
          + ", ".join(f"{w.__name__} {w.launches}" for ws in wrappers.values()
                      for w in ws), flush=True)
    if idle:
        raise AssertionError(f"the probes' main path never launched {idle}")
    recs = {}

    # P1: every variant against its plain version at the main path's shape;
    # two copies of the block, each equal to the plain version
    coef, ray = probe_pair.make_inputs(C, SUB, dev)
    lanes = SUB * probe_pair.R
    ms_sum = plain_sum = 0.0
    bounds = []
    for v in probe_pair.VARIANTS:
        kv = probe_pair.KERNEL_OF[v]
        got = probe_pair.probe_pair_cuda(coef, ray, v, REP, copies=2)
        plain_ms, want = once_ms(
            lambda: probe_pair.probe_pair_plain(coef, ray, v, REP))
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if not all(np.array_equal(g, want, equal_nan=True) for g in got):
            raise AssertionError(f"P1 {v}: the kernel differs from the "
                                 f"plain version")
        n_pairs = 1 if kv in ("noreduce", "dotsonly") else C
        b = bound(nbytes(coef, ray) + 4 * lanes, lanes * REP * (
            OPS_PAIR_ITER + n_pairs * OPS_PAIR[kv]))
        ms_sum, plain_sum = ms_sum + pair[v]["ms"], plain_sum + plain_ms
        bounds.append(b)
        print(f"  P1 {v} (kernel {kv}): identical to the plain version; "
              f"{pair[v]['ms']:.3f} ms (main's best of 5), plain "
              f"{plain_ms:.1f} ms, bound {b[0]:.4f} ms ({b[1]})", flush=True)
    recs["probe_pair"] = dict(launches=launches["probe_pair"],
                              max_abs_err=0.0, ms=ms_sum, plain_ms=plain_sum,
                              bound=sum_bounds(bounds))
    coef2, ray2 = probe_pair.make_inputs(2 * C, SUB, dev)
    for v in ("full", "noreduce", "dotsonly"):
        one, two = (best_ms(lambda c=c, r=r: probe_pair.probe_pair_cuda(
            c, r, v, REP), dev, 3) for c, r in ((coef, ray), (coef2, ray2)))
        print(f"  P1 {v}: {one:.3f} ms at C {C}, {two:.3f} ms at C {2 * C} "
              f"(x{two / one:.2f}: the loop over C is "
              f"{'kept' if two > 1.5 * one else 'removed'})", flush=True)
    for kv, ops in sorted(sass_loops(build_path("probe_pair")).items()):
        name = [k for k, i in probe_pair.KERNEL_IDS.items() if i == kv][0]
        pairs = ops["LDG.E.CONSTANT"] / LOADS_PAIR[name]    # unrolled pairs
        print(f"  P1 SASS, {name}'s pair loop: {pairs:.0f} pair(s) an "
              f"iteration, {sum(ops.values()) / pairs:.0f} instructions a "
              f"pair: " + ", ".join(f"{op} {n / pairs:.0f}" for op, n in
                                    ops.most_common(6)), flush=True)
    k1_ms, k1_lb, k1_sph = k1_pair
    k1_ns = k1_ms * 1e6 / (k1_lb * k1_sph)
    d = pair["direct"]
    print(f"  K1: {k1_ns:.5f} ns a sphere pair ({k1_ms:.2f} ms over {k1_lb} "
          f"lane-bounces x {k1_sph} spheres, the whole card); P1 direct "
          f"{d['ns_pair']:.5f} ns a pair on one block, "
          f"{1 / d['card_gpair_s']:.5f} over a full wave of "
          f"{d['card_copies']} blocks ({d['card_gpair_s']:.1f} Gpair/s); "
          f"K1 {k1_ns * d['card_gpair_s']:.1f}x direct's full-wave time a "
          f"pair", flush=True)

    # P2: bit-equal to the plain version at INTMUL_CHECK; the loops' SASS
    x = probe_intmul.make_input(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_mhz()
    int_rate = sms * INT32_LANES * clock * 1e6
    print(f"  P2 INT32 rate {int_rate / 1e12:.2f} T ops/s ({sms} SMs x "
          f"{INT32_LANES} lanes x {clock:.0f} MHz, clocks.max.sm)",
          flush=True)
    ms_sum = plain_sum = 0.0
    bounds = []
    for f in probe_intmul.FLAVOURS:
        got = probe_intmul.intmul_chain_cuda(x, f, INTMUL_CHECK, copies=2)
        plain_ms, want = once_ms(
            lambda: probe_intmul.intmul_chain_plain(x, f, INTMUL_CHECK))
        got = got.view(torch.int32).cpu().numpy()
        if not all(np.array_equal(g, want.view(torch.int32).cpu().numpy())
                   for g in got):
            raise AssertionError(f"P2 {f}: the kernel differs from the "
                                 f"plain version")
        r = intmul[f]
        ops = x.numel() * INTMUL_MAIN * OPS_INTMUL[f]
        b = (ops / (PEAK_FP32 if f == "f32mul" else int_rate) * 1e3,
             "operations")
        ms_sum, plain_sum = ms_sum + r["ms"], plain_sum + plain_ms
        bounds.append(b)
        print(f"  P2 {f}: identical to the plain version at {INTMUL_CHECK} "
              f"iterations (plain {plain_ms:.1f} ms); main at "
              f"{INTMUL_MAIN}: {r['ms']:.3f} ms, bound {b[0]:.4f} ms, "
              f"{r['ns_op']:.3f} ns/[8x128]-op on one block, "
              f"{r['card_ns_op']:.4f} over {r['card_copies']} blocks",
              flush=True)
    recs["probe_intmul"] = dict(launches=launches["probe_intmul"],
                                max_abs_err=0.0, ms=ms_sum,
                                plain_ms=plain_sum, bound=sum_bounds(bounds),
                                iters=INTMUL_MAIN, plain_iters=INTMUL_CHECK)
    loops = sass_loops(build_path("probe_intmul"))
    for f in probe_intmul.FLAVOURS:
        ops = loops.get(probe_intmul.FLAVOUR_IDS[f])
        if ops is None:
            raise AssertionError(f"P2 {f}: no loop in the kernel's SASS")
        print(f"  P2 SASS, {f}'s loop: " + ", ".join(
            f"{op} {n}" for op, n in ops.most_common(5)), flush=True)
        imads = ops.get("IMAD", 0)
        want_imads = {"i32mul": 8, "u32mul": 8, "u32mix": 4}.get(f)
        if want_imads and imads != want_imads:
            raise AssertionError(f"P2 {f}: {imads} IMADs an iteration, not "
                                 f"{want_imads}: the compiler changed the "
                                 f"chain")

    # P3: every case against its plain version, on the tool's inputs and on
    # seeded random ones; kernel, plain and library timed on the tool's
    p3 = {}
    err = 0.0
    for name, case in probe_mosaic.CASES.items():
        for what, inputs in (("random", case.random),
                             ("tool's", case.inputs)):
            args = inputs(dev)
            got = case.cuda(*args)
            plain_ms, want = once_ms(lambda: case.plain(*args))
            g, w = got.cpu().numpy(), want.cpu().numpy()
            if name == "trig":
                ok = (np.abs(g - w) <= TRIG_ULP * np.spacing(np.abs(w))).all()
            else:
                ok = np.array_equal(g, w)
            if not ok:
                raise AssertionError(
                    f"P3 {name}: the kernel differs from the plain version "
                    f"on the {what} inputs")
            err = max(err, float(np.abs(g.astype(np.float64) - w).max()))
        # args, got and plain_ms are now the tool's inputs'
        kernel = case.cuda.__name__.replace("_cuda", "_kernel")
        ms = best_ms(lambda: case.cuda(*args), dev, 5, PROBE_BATCH)
        lib = PROBE_LIBRARY.get(name)
        lib_ms = None
        if lib is not None:
            largs = library_args(name, args)
            lib_ms = best_ms(lambda: lib(*largs), dev, 5, PROBE_BATCH)
        tensors = [a for a in args if torch.is_tensor(a)]
        b = bound(nbytes(*tensors, got), probe_ops(name, args, got))
        p3[name] = dict(ms=ms, plain_ms=plain_ms, bound=b, library_ms=lib_ms)
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        same = f"within {TRIG_ULP} ulp" if name == "trig" else "identical"
        print(f"  P3 {name}: {same} on the tool's and on random inputs; "
              f"{kernel} {ms:.4f} ms (back to back), plain {plain_ms:.2f} "
              f"ms, library {lib_txt}, bound {b[0]:.6f} ms ({b[1]})",
              flush=True)
    # the cases that lost to their library call: kernel and library timed
    # in turns, RETIME_ROUNDS readings each, with their spread
    for name in P3_RETIME:
        case = probe_mosaic.CASES[name]
        args = case.inputs(dev)
        lib, largs = PROBE_LIBRARY[name], library_args(name, args)
        k_ms, l_ms = [], []
        for _ in range(RETIME_ROUNDS):
            k_ms.append(best_ms(lambda: case.cuda(*args), dev, 5,
                                PROBE_BATCH))
            l_ms.append(best_ms(lambda: lib(*largs), dev, 5, PROBE_BATCH))
        print(f"  P3 {name} re-timed, kernel and library in turns, "
              f"{RETIME_ROUNDS} readings each (ms, median [min, max]): "
              f"kernel {np.median(k_ms):.5f} [{min(k_ms):.5f}, "
              f"{max(k_ms):.5f}], library {np.median(l_ms):.5f} "
              f"[{min(l_ms):.5f}, {max(l_ms):.5f}]; kernel / library "
              f"{np.median(k_ms) / np.median(l_ms):.3f}", flush=True)
    # the record sums the cases with a library call, so that its ms, plain,
    # bound and library are one workload; the others stand beside it
    with_lib = [n for n, r in p3.items() if r["library_ms"] is not None]
    recs["probe_mosaic"] = dict(
        launches=launches["probe_mosaic"], max_abs_err=err,
        ms=sum(p3[n]["ms"] for n in with_lib),
        plain_ms=sum(p3[n]["plain_ms"] for n in with_lib),
        bound=sum_bounds(p3[n]["bound"] for n in with_lib),
        library_ms=sum(p3[n]["library_ms"] for n in with_lib),
        cases=with_lib,
        without_library={n: dict(ms=r["ms"], plain_ms=r["plain_ms"],
                                 bound_ms=r["bound"][0])
                         for n, r in p3.items() if n not in with_lib})
    print(f"  records: P1 sums its 18 variants at C {C}, REP {REP}, SUB "
          f"{SUB}; P2 its 5 flavours at {INTMUL_MAIN} iterations (plain at "
          f"{INTMUL_CHECK}); P3 the {len(with_lib)} cases with a library "
          f"call, the other {len(p3) - len(with_lib)} beside them",
          flush=True)
    return recs


def f64_sphere_winner(tab, o, d, tm: float, t_min: float) -> int:
    """The table row of the sphere that the ray (o, d) at time tm meets
    first beyond t_min in f64 (-1: none), over every active sphere row."""
    r = tab.sph.double().cpu().numpy()
    r = r[r[:, 9] > 0.5]
    rows = np.nonzero(tab.sph[:, 9].cpu().numpy() > 0.5)[0]
    c = r[:, 0:3] + ((tm - r[:, 6]) * r[:, 7])[:, None] * r[:, 3:6]
    oc = o[None, :] - c
    qa, qb = d @ d, oc @ d
    disc = qb * qb - qa * ((oc * oc).sum(1) - r[:, 8] ** 2)
    sq = np.sqrt(np.maximum(disc, 0.0))
    t1, t2 = (-qb - sq) / qa, (-qb + sq) / qa
    t = np.where(t1 > t_min, t1, t2)
    t = np.where((disc > 0.0) & (t > t_min), t, np.inf)
    k = int(np.argmin(t))
    return int(rows[k]) if np.isfinite(t[k]) else -1


def rounding_hits(tab, off, fp, ids: torch.Tensor) -> list:
    """Where the sums of pixel ids ``ids`` differ with the cull and without
    it: each (pixel, sample) lane whose winners differ (the plain version's
    tapes), its first differing bounce, the two winners, whether the
    unculled winner is a rounding hit -- a sphere that the ray, in f64,
    does not meet at all -- and the ray's f64 winner among all spheres
    (the world must hold spheres only).  The f32 quadratic of a ray from
    far away (here: paths inside the 1000-unit ground sphere) cancels
    |oc|^2 against b^2 and can report such a hit; the culled kernel skips
    its chunk, whose box the ray does not meet, lane by lane (ROADMAP.md,
    queue 3)."""
    if tab.nl_pad or tab.b_pad or tab.n_media:
        raise AssertionError("rounding_hits compares with f64 spheres only")
    pix, samp = mega2.tape_lanes(ids, fp.spp)
    fp1 = fp._replace(spp=1)
    on = mega2.trace_tapes_plain(tab, pix, samp, fp1)
    unc = mega2.trace_tapes_plain(off, pix, samp, fp1)
    out = []
    for k in (on != unc).any(0).nonzero()[:, 0].tolist():
        b = int((on[:, k] != unc[:, k]).nonzero()[0, 0])
        o, d, tm, pc = generate_rays(fp.cam, pix[k:k + 1], samp[k:k + 1],
                                     fp.width, fp.height, fp.seed)
        thr, acc = torch.ones_like(o), torch.zeros_like(o)
        for j in range(b):       # both runs agree on the bounces before b
            o, d, thr, acc, _, _ = mega2._bounce(
                off, fp1, o, d, tm, thr, acc, pc, samp[k:k + 1], j, 256)
        row = int(unc[b, k])
        o64, d64 = o[0].double().cpu().numpy(), d[0].double().cpu().numpy()
        rec = {"pixel": int(pix[k]), "sample": int(samp[k]), "bounce": b,
               "culled_winner": int(on[b, k]), "unculled_winner": row,
               "f64_winner": f64_sphere_winner(tab, o64, d64, float(tm[0]),
                                               float(fp.t_min)),
               "rounding_hit": False}
        if 0 <= row < tab.s_pad:
            r = tab.sph[row].double().cpu().numpy()
            c = r[0:3] + (float(tm[0]) - r[6]) * r[7] * r[3:6]
            oc = o64 - c
            qa, qb = d64 @ d64, oc @ d64
            rec["f64_disc"] = float(qb * qb - qa * (oc @ oc - r[8] * r[8]))
            rec["rounding_hit"] = rec["f64_disc"] < 0.0
        out.append(rec)
    return out


def phase_large_world(dev, card: str) -> dict:
    """The main path on the large world: ``render()`` on
    ``sphere_field(FIELD_LARGE)`` at the main frame, then K1 with the cull
    and without it on the whole frame (array-equal, both timed), K1
    against the plain version on every STRIDE-th id with the plain
    version's cull counts, and the bounds.  Returns K1's large-world
    numbers."""
    w, h, spp = MAIN
    scene, meta = compile_scene(sphere_field(FIELD_LARGE), w, h,
                                dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_bounces=50, engine="mega2")
    mega2.render_radiance_cuda.launches = 0
    sec, img = timed(lambda: render(scene, meta, cfg, device=dev,
                                    out_u8=True))
    launches = mega2.render_radiance_cuda.launches
    if launches < 1:
        raise AssertionError("render() did not launch K1 on the large world")
    print(f"  render(): best of 3 {sec:.4f} s, {w * h * spp / sec / 1e6:.2f} "
          f"M rays/s on {card}; K1 launches {launches}", flush=True)
    if img.shape != (h, w, 3) or not img.any():
        raise AssertionError("the large world's image is empty or misshapen")
    fp = mega2.frame_params(scene, cfg)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    off = mega2.pack_mega2_tables(scene, meta, dev, **CULL_OFF)
    if not tab.cull_pairs or off.cull_pairs or off.cull_boxes:
        raise AssertionError("the cull flags are not as asked")
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    on_s, fb = timed(lambda: mega2.render_radiance_cuda(tab, pix, fp))
    shape = mega2.render_radiance_cuda.shape
    off_s, fb_off = timed(lambda: mega2.render_radiance_cuda(off, pix, fp))
    same = int((fb == fb_off).all(1).sum())
    print(f"  K1 culled {on_s * 1e3:.2f} ms, unculled {off_s * 1e3:.2f} ms "
          f"(x{off_s / on_s:.2f}), best of 3 on {card}; launch (blocks, "
          f"threads, shared bytes) {shape}; {same}/{w * h} sums identical",
          flush=True)
    differ = (fb != fb_off).any(1).nonzero()[:, 0]
    if differ.numel():
        # each kernel computes what its plain version does there, and every
        # lane that differs is a rounding hit of the unculled sphere test
        ids = differ.to(torch.int32)
        for what, t, f in (("culled", tab, fb), ("unculled", off, fb_off)):
            if not torch.equal(f[differ], mega2.render_radiance_plain(
                    t, ids, fp)):
                raise AssertionError(f"K1 {what} differs from the plain "
                                     f"version on {ids.tolist()}")
        lanes = rounding_hits(tab, off, fp, ids)
        for rec in lanes:
            print(f"    {json.dumps(rec)}", flush=True)
        if not lanes or not all(
                rec["rounding_hit"]
                and rec["culled_winner"] == rec["f64_winner"]
                for rec in lanes):
            raise AssertionError("K1 culled differs from K1 unculled where "
                                 "the unculled hit is not a rounding hit, "
                                 "or the culled winner is not the f64 one")
        print(f"  the {differ.numel()} pixels that differ: both kernels "
              f"equal to their plain versions there; {len(lanes)} lanes, "
              f"each a rounding hit of the unculled f32 sphere test (a "
              f"sphere its ray misses in f64) that the cull skips, the "
              f"culled winner the ray's f64 winner", flush=True)
    if shape[2] != 0:
        raise AssertionError("the large world's rows went to shared memory")
    u8 = finalize(fb, spp, gamma=True, out_u8=True).cpu().numpy()
    if not np.array_equal(u8.reshape(h, w, 3)[::-1], img):
        raise AssertionError("render()'s frame differs from K1's")
    print(f"  u8 frame sha256 {hashlib.sha256(u8.tobytes()).hexdigest()}",
          flush=True)
    sub = pix[::STRIDE]
    plain_s, (plain, cull) = once_s(lambda: cull_share.count(tab, fp, sub))
    st = compare(fb[sub.long()].cpu().numpy(), plain.cpu().numpy(),
                 f"K1 vs plain, every {STRIDE}th id ({sub.shape[0]} ids; "
                 f"plain {plain_s:.1f} s)", "sums")
    if not torch.equal(fb[sub.long()], plain):
        raise AssertionError("K1 differs from the plain version")
    pb = cull["per_bounce"]
    counts = path_counts(tab, fp, pix)
    lb = int(counts.sum())
    del counts
    ops_on = lb * (pb["tests"] * OPS_SLAB + pb["sphere_rows"] * OPS_SPHERE
                   + pb["quad_rows"] * OPS_QUAD + pb["box_rows"] * OPS_BOX
                   + tab.n_media * OPS_MEDIUM + OPS_BOUNCE)
    b_on = bound(table_bytes(tab) + nbytes(tab.cull_s, tab.cull_q)
                 + pix.shape[0] * (4 + 12), ops_on)
    b_off = bound(table_bytes(off) + pix.shape[0] * (4 + 12),
                  lb * pair_ops(off))
    print(f"  cull counts of the plain version on those ids, per "
          f"lane-bounce: {json.dumps(pb)}; the frame's lane-bounces (K2 "
          f"tapes) {lb}; bound culled {b_on[0]:.3f} ms ({b_on[1]}), "
          f"unculled {b_off[0]:.3f} ms ({b_off[1]})", flush=True)
    return {"ms": on_s * 1e3, "unculled_ms": off_s * 1e3,
            "bound_ms": b_on[0], "unculled_bound_ms": b_off[0],
            "plain_ms_every_97th": plain_s * 1e3, "render_s": sec,
            "rays_per_s": w * h * spp / sec, "launches": launches,
            "lane_bounces": lb, "chunk_share": pb["chunk_share"],
            "max_abs_err": st["max_abs"],
            "pixels_differing_unculled": int(differ.numel())}


def grads_of(params) -> list:
    """Copies of the gradients of a parameter dict's leaves (zeros where
    none arrived), in `train.parameter_list` order."""
    return [torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for p in train.parameter_list(params)]


def leaf_rel_l2(got: list, want: list) -> list:
    """rel-L2 of each leaf's gradient; 0 where both are zero."""
    return [float((g - w).norm()) / float(w.norm()) if float(w.norm()) > 0
            else (0.0 if float(g.norm()) == 0 else float("inf"))
            for g, w in zip(got, want)]


def taped_scan_gap(first: dict):
    """(summary, bad) of the two engines' first steps ``first[engine] =
    (loss, gradients)``: the loss's relative gap and the worst rel-L2 of a
    leaf with a gradient; bad if above rel 1e-5 / GRAD_REL."""
    (l_t, g_t), (l_s, g_s) = first["taped"], first["scan"]
    loss_rel = abs(l_t - l_s) / abs(l_s)
    rel = [r for r, g in zip(leaf_rel_l2(g_t, g_s), g_s)
           if float(g.norm()) > 0]
    return (f"loss rel {loss_rel:.2e}; gradient rel-L2 worst {max(rel):.2e} "
            f"over the {len(rel)} leaves with one",
            loss_rel > 1e-5 or max(rel) > GRAD_REL)


def general_step(start, meta, cfg, engine: str, dev, lr: float = 1e-2):
    """(state, step) of ``make_train_step(engine)`` with Adam at ``lr``
    over fresh parameters of ``start`` on ``dev``."""
    state = train.init_state(start, lambda ps: torch.optim.Adam(ps, lr=lr),
                             device=dev)
    return state, train.make_train_step(start, meta, cfg, engine=engine)


def phase_general_step(dev, card: str, mega2_step) -> None:
    """Phase 15: the general train step (module notes)."""
    t_phase = time.perf_counter()
    W, H, spp, K = TRAIN
    P = W * H
    pix = np.arange(P, dtype=np.int32)
    start, meta, cfg, target, state9, step9 = train_setup((0, *TRAIN), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    step9(state9, pix, target)
    torch.cuda.synchronize()
    m2_ms, m2_busy, m2_launches = mega2_step
    mega2_line = (f"mega2 step (phase 9): {m2_ms:.2f} ms, busy "
                  f"{'not measured' if m2_busy is None else f'{m2_busy:.3f}'}"
                  f", {m2_launches or 'not measured'} launches, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"({held / 2**30:.2f} held before the step)")
    del state9, step9

    # (a) each engine at full width; its warm-up step, from the start's
    # parameters, gives gate (b)1 its loss and gradients.  The step is
    # plain PyTorch: it launches none of the port's kernels
    counters = (mega2.render_radiance_cuda, mega2.trace_tapes_cuda,
                rc.replay_fwd_cuda, rc.replay_bwd_cuda, mega.mega_bounces_cuda,
                pallas_hit.closest_geo_cuda)
    for c in counters:
        c.launches = 0
    first, ref = {}, {}
    for engine, timed in (("taped", 3), ("scan", 1)):
        state, step = general_step(start, meta, cfg, engine, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        state, loss = step(state, start, pix, target)            # warm-up
        torch.cuda.synchronize()
        first[engine] = (float(loss), grads_of(state.params))
        ref[engine] = step_record(state, loss)
        box, walls, split, losses = [state], [], {}, [float(loss)]
        with_rest = lambda st, p, t, mark=None: step(st, start, p, t,
                                                     mark=mark)
        for _ in range(timed):
            t0 = time.perf_counter()
            phases, loss = step_phase_ms(with_rest, box, pix, target)
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            for name, ms in phases.items():
                split.setdefault(name, []).append(ms)
        peak = torch.cuda.max_memory_allocated()
        step_ms = float(np.mean(walls))
        if not np.isfinite(losses).all():
            raise AssertionError(f"{engine}: non-finite training loss")

        def one_step():
            box[0], _ = step(box[0], start, pix, target)

        evs = device_events(one_step, 1, warm=False)
        busy_ms = sum(us for _, us, _ in evs) / 1e3
        busy = (f"busy {busy_ms / step_ms:.3f} ({busy_ms:.2f} ms of device "
                f"kernels), {sum(n for *_, n in evs)} launches a step"
                if evs else "busy and launches not measured (the profiler "
                            "returned no device record)")
        print(f"  {engine}: {step_ms:.2f} ms per step (mean of {timed}, "
              f"host clock + sync), split (CUDA events, mean ms) "
              + ", ".join(f"{n} {np.mean(v):.2f}" for n, v in split.items())
              + f"; peak allocated {peak / 2**30:.2f} GiB ({held / 2**30:.2f}"
              f" held before); {busy}; losses {losses}; on {card}",
              flush=True)
        if evs:
            print(f"    busiest: " + ", ".join(
                f"{key[:40]} {us / 1e3:.2f} ms x{n}" for key, us, n in
                sorted(evs, key=lambda e: -e[1])[:5]), flush=True)
        print(f"    beside it, the {mega2_line}", flush=True)
        del state, step, box, evs

    print(f"  the port's kernels launched by the steps: "
          f"{sum(c.launches for c in counters)} (plain PyTorch path)",
          flush=True)
    phase_repeat(dev, card, start, meta, cfg, pix, target, ref)
    del ref

    # (b)1 taped against scan, one step each from the same parameters, the
    # gradients before the update.  In f32 the two differ on this scene by
    # the reference's own rounding (ROADMAP.md queue 3: the search's
    # coefficient-form sphere test against the replay's direct form, on
    # lanes that meet the ground sphere near a checker edge): phase (a)'s
    # warm-up steps measure it.  The gate holds the two to one function in
    # f64, on the same frame
    print(f"  (b)1 taped vs scan, f32 (phase (a)'s warm-up steps; measured, "
          f"the reference's rounding): " + taped_scan_gap(first)[0],
          flush=True)
    scene64, meta64 = compile_scene(build_scene(0), W, H, dtype=np.float64)
    start64 = scene64._replace(tex_c0=np.clip(
        np.asarray(scene64.tex_c0) * 0.5 + 0.2, 0.0, 1.0))
    first = {}
    for engine in ("taped", "scan"):
        t0 = time.perf_counter()
        state, step = general_step(start64, meta64, cfg, engine, dev)
        state, loss = step(state, start64, pix, target.double())
        torch.cuda.synchronize()
        first[engine] = (float(loss), grads_of(state.params))
        print(f"    f64 {engine} step: {time.perf_counter() - t0:.2f} s",
              flush=True)
        del state, step
    line, bad = taped_scan_gap(first)
    print(f"  (b)1 taped vs scan, f64, {W}x{H}@{spp}, K {K}: {line}",
          flush=True)
    if bad:
        raise AssertionError("taped and scan steps disagree")
    del first

    # (b)2 the XLA tape against K2's (global ids), sample 0 of the frame
    st = hit.scene_tensors(start, dev)
    pix_t = torch.arange(P, dtype=torch.int32, device=dev)
    o, d, tm, pc = generate_rays(st.camera, pix_t, 0, W, H, cfg.seed)
    with torch.no_grad():
        tape_x, _ = rp.generate_tape(st, meta, o, d, tm, pc, 0,
                                     max_bounces=K, t_min=cfg.t_min)
    tape_k = mega2.mega2_tapes(start, meta, pix, 1, width=W, height=H,
                               max_bounces=K, t_min=cfg.t_min, seed=cfg.seed,
                               id_space="global", device=dev)[0]
    same = float((tape_x == tape_k).all(0).float().mean())
    print(f"  (b)2 XLA tape vs K2, sample 0 ({P} lanes, K {K}): {same:.6f} "
          f"of lanes identical over all bounces", flush=True)
    if same < TAPE_AGREE:
        raise AssertionError("the XLA tape and K2's disagree")
    del tape_x, st

    # (b)3 the XLA replay against K3 / K4 on K2's tape: radiance and the
    # gradient of a weighted sum of it
    params = train.split_params(start, dev)
    sc = train.merge_params(hit.scene_tensors(start, dev), params)
    o, d, tm, pc = generate_rays(sc.camera, pix_t, 0, W, H, cfg.seed)
    fp = mega2.frame_params(start, cfg)
    rad_x = rp.replay(sc, meta, tape_k, o, d, tm, pc, 0, max_bounces=K,
                      t_min=cfg.t_min)
    tt = rp.replay_table(sc, meta, mega2.pack_mega2_tables(start, meta, dev))
    rad_k = rc.replay(tt, torch.cat([o, d, tm[:, None]], dim=1), tape_k, pc,
                      0, sc.camera.background, t_min=fp.t_min)
    compare(rad_k.detach().cpu().numpy(), rad_x.detach().cpu().numpy(),
            f"(b)3 K3 vs the XLA replay, sample 0 ({P} lanes)")
    wts = torch.as_tensor(np.random.default_rng(15).random((P, 3)),
                          dtype=torch.float32, device=dev)
    leaves = train.parameter_list(params)
    g_x, g_k = ([torch.zeros_like(p) if g is None else g
                 for g, p in zip(torch.autograd.grad(
                     (r * wts).sum(), leaves, retain_graph=True,
                     allow_unused=True), leaves)]
                for r in (rad_x, rad_k))
    rel = leaf_rel_l2(g_k, g_x)
    names = [*train.DIFF_SCENE_FIELDS,
             *(f"camera.{f}" for f in params["camera"]._fields)]
    print(f"  (b)3 K4 vs autograd of the XLA replay, d(weighted sum): "
          f"rel-L2 by leaf with a gradient: " + ", ".join(
              f"{n} {r:.1e}" for n, r, g in zip(names, rel, g_x)
              if float(g.norm()) > 0), flush=True)
    if max(rel) > GRAD_REL:
        raise AssertionError("K4's gradient and the XLA replay's disagree")
    del params, sc, rad_x, rad_k, tt, g_x, g_k, tape_k

    # (b)4 the card against the CPU: one step of each engine, scene 4
    sid, w, h, spp4, k4 = GENERAL_SMALL
    scene4, meta4 = compile_scene(build_scene(sid), w, h, dtype=np.float32)
    cfg4 = RenderConfig(width=w, height=h, samples_per_pixel=spp4,
                        max_bounces=k4)
    start4 = scene4._replace(tex_c0=np.clip(
        np.asarray(scene4.tex_c0) * 0.5 + 0.2, 0.0, 1.0).astype(np.float32))
    tgt4 = np.random.default_rng(4).random((w * h, 3)).astype(np.float32)
    for engine in ("taped", "scan"):
        out = {}
        for where in ("cpu", dev):
            state, step = general_step(start4, meta4, cfg4, engine, where,
                                       lr=0.05)
            state, loss = step(state, start4, np.arange(w * h),
                               torch.as_tensor(tgt4, device=where))
            out[str(where)] = (float(loss), [p.detach().cpu() for p in
                                             train.parameter_list(
                                                 state.params)])
        (l_c, p_c), (l_g, p_g) = out["cpu"], out[str(dev)]
        loss_rel = abs(l_g - l_c) / abs(l_c)
        leaf = max(float(((g - c).abs() / c.abs().clamp_min(1e-30)).max())
                   for g, c in zip(p_g, p_c))
        print(f"  (b)4 card vs CPU, {engine}, scene {sid} at {w}x{h}@{spp4}, "
              f"K {k4}: loss rel {loss_rel:.2e}, leaves after Adam max rel "
              f"{leaf:.2e}", flush=True)
        if loss_rel > 1e-5 or not all(
                torch.allclose(g, c, rtol=1e-5, atol=0)
                for g, c in zip(p_g, p_c)):
            raise AssertionError(f"{engine}: the card's step differs from "
                                 f"the CPU's")

    # (b)5 the differentiable render (the scan form) equals the while form
    sid, w, h, spp5 = DIFF_RENDER
    scene5, meta5 = compile_scene(build_scene(sid), w, h, dtype=np.float32)
    cfg5 = RenderConfig(width=w, height=h, samples_per_pixel=spp5,
                        engine="bruteforce")
    frames = [render(scene5, meta5, cfg5.with_(differentiable=flag),
                     device=dev) for flag in (False, True)]
    print(f"  (b)5 render(differentiable=True), bruteforce, scene {sid} at "
          f"{w}x{h}@{spp5}: {int((frames[0] == frames[1]).all(-1).sum())}/"
          f"{w * h} pixels equal to the while form's", flush=True)
    if not np.array_equal(*frames) or not frames[0].any():
        raise AssertionError("the differentiable frame differs")

    # (b)6 the geometry example passes its own assert
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        recover_geometry.main(["--device", "cuda"])
    summary = [ln for ln in log.getvalue().splitlines()
               if ln.startswith("center error")]
    print(f"  (b)6 examples/recover_geometry on the card: {summary[-1]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)


def leaves_of(params) -> list:
    """Copies of a parameter dict's leaves, in `train.parameter_list`
    order."""
    return [p.detach().clone() for p in train.parameter_list(params)]


def step_record(state, loss) -> tuple:
    """(loss, gradients, leaves after the update) of a step just taken."""
    return float(loss), grads_of(state.params), leaves_of(state.params)


def same_step(a: tuple, b: tuple) -> bool:
    """Two `step_record`s bit for bit equal."""
    return a[0] == b[0] and all(torch.equal(x, y) for x, y in
                                zip(a[1] + a[2], b[1] + b[2]))


@contextlib.contextmanager
def row_reads(read):
    """The winner reads of ops/hit.py and ops/replay.py through ``read``
    (``hit.read_rows``'s signature) while inside."""
    real = hit.read_rows
    hit.read_rows = read
    try:
        yield
    finally:
        hit.read_rows = real


def index_select_rows(table, idx):
    """The winner read as the parent commit has it: ``index_select``,
    whose backward adds with ``index_add_``'s atomics."""
    return table.index_select(0, idx)


def taped_step_ms(start, meta, cfg, pix, target, dev,
                  deterministic_backward: bool = False) -> tuple:
    """(host ms, backward ms by CUDA events) of one taped step from the
    start's parameters; ``deterministic_backward`` turns on
    ``torch.use_deterministic_algorithms`` from the forward's end to the
    backward's."""
    state, step = general_step(start, meta, cfg, "taped", dev)

    def with_rest(st, p, t, mark=None):
        def m(name):
            mark(name)
            if deterministic_backward:
                torch.use_deterministic_algorithms(name == "forward",
                                                   warn_only=True)
        return step(st, start, p, t, mark=m)

    t0 = time.perf_counter()
    try:
        phases, _ = step_phase_ms(with_rest, [state], pix, target)
    finally:
        torch.use_deterministic_algorithms(False)
    return (time.perf_counter() - t0) * 1e3, phases["backward"]


def phase_repeat(dev, card: str, start, meta, cfg, pix, target,
                 ref: dict) -> None:
    """Phase 15 (e): the general step's repeatability (a gate), the row
    read's cost against the parent's and the deterministic-algorithms
    option, and the mega2 step and a wavefront_pallas frame run twice
    (reported only)."""
    for engine in ("taped", "scan"):
        state, step = general_step(start, meta, cfg, engine, dev)
        state, loss = step(state, start, pix, target)
        same = same_step(step_record(state, loss), ref[engine])
        print(f"  (e) {engine} step again from the start's parameters: "
              f"loss, gradients and leaves after Adam "
              f"{'bit-identical' if same else 'DIFFER'} to phase (a)'s "
              f"warm-up step", flush=True)
        if not same:
            raise AssertionError(f"{engine}: the general step does not "
                                 f"repeat")
        del state, step

    runs = collections.defaultdict(list)
    parent = ("index_select", index_select_rows, False)
    change = ("read_rows", hit.read_rows, False)
    order = (parent, change, change, parent, change, parent,
             ("index_select, deterministic backward", index_select_rows,
              True))
    for name, read, det in order:
        with row_reads(read):
            runs[name].append(taped_step_ms(start, meta, cfg, pix, target,
                                            dev, det))
    for name, ms in runs.items():
        print(f"  (e) taped step, winner reads by {name}: " + ", ".join(
            f"{a:.1f} ms (backward {b:.1f})" for a, b in ms)
            + f" on {card}", flush=True)
    # The read changes only the backward (the forward is index_select in
    # both), so its cost is the backward's growth by CUDA events, gated at
    # 10% of the parent's step.  The steps' host clocks are printed beside
    # it: two steps of the same code differ by up to ~13% on the card's
    # host (the tape's host syncs and launches), more than the read costs
    median = lambda name, k: float(np.median([r[k] for r in runs[name]]))
    step_p = median("index_select", 0)
    cost = (median("read_rows", 1) - median("index_select", 1)) / step_p
    print(f"  (e) read_rows against index_select, taped step (P C C P C P, "
          f"medians): backward +{cost:.4f} of the parent's step (CUDA "
          f"events); host clock {median('read_rows', 0) / step_p:.4f}x",
          flush=True)
    if cost > 0.10:
        raise AssertionError("the repeatable row read costs more than 10% "
                             "of the taped step")

    recs = []
    m2 = train.make_train_step_mega2(start, meta, cfg)
    for _ in range(2):
        state = train.init_state(
            start, lambda ps: torch.optim.Adam(ps, lr=1e-2), device=dev)
        state, loss = m2(state, pix, target)
        recs.append(step_record(state, loss))
    same = same_step(*recs)
    rel = max(leaf_rel_l2(recs[0][1], recs[1][1]))
    print(f"  (e) mega2 step twice from the start's parameters (measured, "
          f"not gated): {'bit-identical' if same else 'differ'}; loss "
          f"{recs[0][0]!r} / {recs[1][0]!r}, gradients' worst leaf rel-L2 "
          f"{rel:.2e}", flush=True)
    del recs, m2, state

    w, h, spp = MAIN
    scene, meta0, cfg0, _ = compile_cfg(0, w, h, spp)
    wcfg = cfg0.with_(engine="wavefront_pallas")
    frames = [render(scene, meta0, wcfg, device=dev, gamma=False)
              for _ in range(2)]
    differ = int((frames[0] != frames[1]).any(-1).sum())
    print(f"  (e) wavefront_pallas frame twice, scene 0 at {w}x{h}@{spp} "
          f"(measured, not gated): {differ} of {w * h} pixels differ, max "
          f"|diff| {float(np.abs(frames[0] - frames[1]).max()):.3e}",
          flush=True)


def frames_close(img: np.ndarray, ref: np.ndarray, what: str) -> None:
    """The f64 BVH contract: at most 2 pixels above 1e-9
    (tests/test_torch_bvh.py)."""
    diff = np.abs(img - ref).max(-1)
    n = int((diff > 1e-9).sum())
    print(f"  {what}: {n} of {diff.size} pixels above 1e-9 (max "
          f"{float(diff.max()):.2e})", flush=True)
    if n > 2 or not img.any():
        raise AssertionError(f"{what}: the BVH frame disagrees")


def bvh_counts(fn) -> tuple:
    """(seconds, result, traversal calls, traversal steps) of one call of
    ``fn``, ending in a sync."""
    hit_fn = bvh_engine.bvh_closest_hit
    calls, steps = hit_fn.calls, hit_fn.steps
    sec, out = once_s(fn)
    return sec, out, hit_fn.calls - calls, hit_fn.steps - steps


def engines_agree(img: np.ndarray, other: np.ndarray, what: str) -> None:
    """Two engines' f32 frames of one small frame: phase 12's pixel gate,
    at most MAX_FRAC_PLAIN_WF of the pixels above 1e-4.  The BVH tests
    spheres in the direct form, the brute-force engine in the
    coefficient form, and a sample whose winner flips takes another path;
    on a few hundred pixels at 2 spp one such path sets the mean, so the
    mean is printed, not gated."""
    flat = lambda a: np.ascontiguousarray(a).reshape(-1, 3)
    compare(flat(img), flat(other), what, max_frac=MAX_FRAC_PLAIN_WF,
            max_mean=float("inf"))


def phase_bvh(dev, card: str) -> None:
    """Phase 16: the BVH engines (module notes)."""
    t_phase = time.perf_counter()

    # host builds (the JAX package's g++ builder is not ported)
    for name, desc in (("scene 9", scene_desc(9)[0]),
                       ("sphere_field()", sphere_field())):
        sc, _ = compile_scene(desc, 8, 8, dtype=np.float32)
        sec, bvh = once_s(lambda: build_scene_bvh(sc))
        print(f"  (a) numpy BVH build, {name}: {len(bvh.prim)} nodes in "
              f"{sec:.3f} s on the card's host", flush=True)

    # (a) the traversal on the card against its CPU run: phase 12's scene-9
    # pool
    w, h, spp = MAIN
    scene, meta, cfg, _ = compile_cfg(9, w, h, spp)
    P = min(cfg.rays_per_batch, w * h * spp)
    rays, sph, quad = first_pool(scene, w, h, P, cfg.seed, dev)
    S = scene.sph_c0.shape[0]
    bvh = build_scene_bvh(scene)
    out = []
    for where in (dev, torch.device("cpu")):
        tabs = bvh_engine.pack_tables(hit.scene_tensors(scene, where), bvh)
        r = rays.to(where)
        go = lambda: bvh_engine.traverse(tabs, S, r[:, 0:3], r[:, 3:6],
                                         r[:, 6], cfg.t_min)
        if where == dev:
            go()                                   # warm-up
        sec, res = once_s(go)
        out.append((sec, *res))
    (sec, t, p, steps), (sec_c, t_c, p_c, _) = out
    t, p = t.cpu(), p.cpu()
    same = p == p_c
    rel = float(((t - t_c).abs() / t_c.abs())[same & (p >= 0)].max())
    k6_ms = device_ms(lambda: pallas_hit.closest_geo_cuda(
        rays, sph, quad, cfg.t_min), dev)
    print(f"  (a) bvh_closest_hit's traversal, scene 9's first pool ({P} "
          f"rays): prim equal on {float(same.float().mean()):.6f} of lanes, "
          f"t rel {rel:.2e}; {steps} steps, {sec * 1e3:.1f} ms a call "
          f"({sec * 1e3 / steps:.3f} ms a step; CPU {sec_c:.2f} s) against "
          f"K6's {k6_ms:.4f} ms on the same rays, on {card}", flush=True)
    if float(same.float().mean()) < 1 - MAX_DIFF_LANES or rel > 1e-6:
        raise AssertionError("the traversal on the card differs from the "
                             "CPU's")
    del rays, sph, quad, out, t, p, t_c, p_c

    # (b) the BVH engines against their brute-force twins, f64 and f32
    w, h, spp = BVH_FRAME
    for sid in BVH_SCENES:
        desc = scene_desc(sid)[0]
        for dt in (np.float64, np.float32):
            sc, mt = compile_scene(desc, w, h, dtype=dt)
            cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                               max_bounces=BVH_DEPTH,
                               dtype=np.dtype(dt).name)
            img, secs = {}, {}
            for e in (("wavefront", "wavefront_bvh") if dt == np.float32
                      else ("bruteforce", "bvh", "wavefront",
                            "wavefront_bvh")):
                secs[e], img[e] = once_s(lambda: render(
                    sc, mt, cfg.with_(engine=e), device=dev))
            print(f"  (b) scene {sid} at {w}x{h}@{spp}, {BVH_DEPTH} "
                  f"bounces, {np.dtype(dt).name}, seconds a frame: "
                  + ", ".join(f"{e} {v:.2f}" for e, v in secs.items()),
                  flush=True)
            if dt == np.float64:
                frames_close(img["bvh"], img["bruteforce"],
                             f"(b) scene {sid}, f64, bvh vs bruteforce")
                frames_close(img["wavefront_bvh"], img["wavefront"],
                             f"(b) scene {sid}, f64, wavefront_bvh vs "
                             f"wavefront")
            else:
                engines_agree(img["wavefront_bvh"], img["wavefront"],
                              f"(b) scene {sid}, f32, wavefront_bvh vs "
                              f"wavefront")
    print(f"  (b) {time.perf_counter() - t_phase:.1f} s so far", flush=True)

    # (c) bvh at f64 against the oracle
    w, h, spp = BVH_ORACLE
    for sid in ORACLE_SCENES:
        sc, mt = compile_scene(scene_desc(sid)[0], w, h, dtype=np.float64)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           dtype="float64", engine="bvh")
        sec, img, calls, steps = bvh_counts(
            lambda: render(sc, mt, cfg, device=dev))
        o_sec, want = once_s(lambda: Oracle(sc, mt, w, h, cfg.seed)
                             .render(spp))
        frac, mean, worst = assert_images_close(
            img, want, label=f"scene {sid} bvh vs oracle")
        print(f"  (c) scene {sid} at {w}x{h}@{spp}, bvh f64 on the card vs "
              f"the oracle: {frac:.4%} of pixels within 1e-9, mean "
              f"{mean:.2e}, worst {worst:.2e}; bvh {sec:.2f} s ({calls} "
              f"traversals, {steps} steps), oracle {o_sec:.2f} s",
              flush=True)

    # (d) timed: wavefront_bvh against wavefront_pallas (scene 9) and
    # against render()'s mega2 on the large world
    w, h, spp = BVH_TIMED
    for name, desc, other in (("scene 9", scene_desc(9)[0],
                               "wavefront_pallas"),
                              ("sphere_field()", sphere_field(), "mega2")):
        sc, mt = compile_scene(desc, w, h, dtype=np.float32)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           max_bounces=BVH_DEPTH)
        bcfg = cfg.with_(engine="wavefront_bvh")
        sec, img, calls, steps = bvh_counts(      # with the host build
            lambda: render(sc, mt, bcfg, device=dev))
        evs = device_events(lambda: render(sc, mt, bcfg, device=dev), 1,
                            warm=False)
        busy = sum(us for _, us, _ in evs) / 1e3 / (sec * 1e3)
        launches = sum(n for *_, n in evs)
        ocfg = cfg.with_(engine=other)
        o_sec, o_img = timed(lambda: render(sc, mt, ocfg, device=dev), 1)
        print(f"  (d) {name} at {w}x{h}@{spp}, {BVH_DEPTH} bounces: "
              f"wavefront_bvh {sec:.2f} s, "
              f"{calls} iterations, {steps / max(calls, 1):.1f} traversal "
              f"steps an iteration, {launches} launches, busy {busy:.3f}; "
              f"{other} {o_sec:.4f} s; on {card}", flush=True)
        engines_agree(img, o_img, f"(d) {name}, wavefront_bvh vs {other}")
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)


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
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                print(f"    ptxas: {ln.strip()}", flush=True)
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                             build["ptxas"])]
        if kname in NO_SPILLS and (not spills or max(spills) > 0):
            raise AssertionError(f"{kname}: ptxas reports spills (or no "
                                 f"report)")

    print("[3] RNG and raygen on the card", flush=True)
    phase_rng(dev)

    w, h, spp = SMALL
    print(f"[4] K1 vs plain, array-equal: all scenes at {w}x{h}@{spp}, "
          f"max_bounces 50; pixel lists permuted and padded; the large "
          f"worlds, culled; scenes 9 and 0 with every chunk culled",
          flush=True)
    launches0 = mega2.render_radiance_cuda.launches
    for sid in range(10):
        scene, meta, cfg, label = compile_cfg(sid, w, h, spp)
        if label:
            print(f"  scene {sid} texture: {label}", flush=True)
        tab = mega2.pack_mega2_tables(scene, meta, dev)
        fp = mega2.frame_params(scene, cfg)
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        k1_equal(tab, fp, pix, f"scene {sid} ({SCENE_NAMES[sid]})")
        if sid == 0:
            rs = np.random.default_rng(11)
            perm = rs.permutation(w * h)
            for what, ids in (
                    ("permuted", perm),
                    ("permuted, 64 ids -1", np.insert(
                        perm, rs.integers(0, w * h, 64), -1)),
                    ("31 ids", perm[:31]), ("389 ids", perm[:389])):
                k1_equal(tab, fp, torch.as_tensor(ids.astype(np.int32),
                                                  device=dev),
                         f"scene 0, {what}")
    # the chunk cull: the two large worlds (culled by the JAX package's
    # rule; rows in shared and in global memory), and scenes 9 and 0 with
    # every chunk culled
    w, h, spp = FIELD
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    for n, smem in ((FIELD_SMALL, True), (FIELD_LARGE, False)):
        scene, meta, tab = field_tables(n, w, h, dev)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           max_bounces=50)
        k1_equal(tab, mega2.frame_params(scene, cfg), pix,
                 f"large world, {tab.s_pad} sphere rows at {w}x{h}@{spp}")
        if not tab.cull_pairs:
            raise AssertionError(f"sphere_field({n}) does not engage the "
                                 f"cull")
        if (mega2.render_radiance_cuda.shape[2] > 0) != smem:
            raise AssertionError(f"sphere_field({n})'s rows went to the "
                                 f"wrong memory")
    w, h, spp = SMALL
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    for sid in (9, 0):
        scene, meta, cfg, _ = compile_cfg(sid, w, h, spp)
        tab = mega2.pack_mega2_tables(scene, meta, dev, **CULL_FORCED)
        k1_equal(tab, mega2.frame_params(scene, cfg), pix,
                 f"scene {sid}, every chunk culled")
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
    print(f"  K1 alone: {k1_frame:.4f} s for the frame on {card}; launch "
          f"(blocks, threads, shared bytes) "
          f"{mega2.render_radiance_cuda.shape}", flush=True)
    print(f"  u8 frame sha256 {hashlib.sha256(u8.tobytes()).hexdigest()}",
          flush=True)
    main_plain_s, plain = once_s(
        lambda: mega2.render_radiance_plain(tab, pix, fp))
    print(f"  plain version, the whole frame: {main_plain_s:.2f} s",
          flush=True)
    blocks, threads, _ = mega2.render_radiance_cuda.shape
    main_st = compare(fb.cpu().numpy(), plain.cpu().numpy(),
                      f"scene 0, the whole frame ({w * h} ids on "
                      f"{blocks * threads} lanes: pixel refill)", "sums")
    if w * h <= blocks * threads:
        raise AssertionError("the main frame did not refill K1's lanes")
    if not torch.equal(fb, plain):
        raise AssertionError("K1's sums differ from the plain version on "
                             "the main frame")
    del plain

    print(f"[6] K1's bound and lane shares at scene 0 {w}x{h}@{spp}; scene 9 "
          f"at {SIDE[0]}x{SIDE[1]}@{SIDE[2]}; K1 and plain timed on scene 0 "
          f"there", flush=True)
    # K1's bound: the frame's lane-bounces, counted from K2's tapes of the
    # same (pixel, sample) lanes at the same depth
    counts = path_counts(tab, fp, pix)
    main_lb = int(counts.sum())
    k1_bound = bound(table_bytes(tab) + pix.shape[0] * (4 + 12),
                     main_lb * pair_ops(tab))
    print(f"  K1 bound at scene 0 {w}x{h}@{spp}: {main_lb} lane-bounces, "
          f"{k1_bound[0]:.3f} ms ({k1_bound[1]}); lane shares "
          f"{json.dumps(lane_shares(counts))}", flush=True)
    del counts
    w, h, spp = SIDE
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
    counts = path_counts(tab, fp, pix)
    k1_lb = int(counts.sum())
    side_bound = bound(table_bytes(tab) + pix.shape[0] * (4 + 12),
                       k1_lb * pair_ops(tab))
    print(f"  K1 bound at scene 0 {w}x{h}@{spp}: {k1_lb} lane-bounces, "
          f"{side_bound[0]:.3f} ms ({side_bound[1]}); lane shares "
          f"{json.dumps(lane_shares(counts))}", flush=True)
    k1_pair = (min(k1_s, k1_s2) * 1e3, k1_lb, int((tab.sph[:, 9] > 0.5).sum()))

    w, h, spp, K = TRACE
    print(f"[7] K2 vs plain, all scenes at {w}x{h}, spp {spp}, K {K}; the "
          f"{FIELD_SMALL}-sphere world culled, unculled and plain",
          flush=True)
    phase_trace(dev)

    w, h, spp, K = REPLAY
    print(f"[8] K3 / K4 vs replay_plain and its autograd, all scenes at "
          f"{w}x{h}, spp {spp}, K {K}", flush=True)
    phase_replay(dev, builds["replay_fwd"]["ptxas"],
                 builds["replay_bwd"]["ptxas"])

    w, h, spp, K = TRAIN
    print(f"[9] main path: parallel/train.make_train_step_mega2, scene 0 at "
          f"{w}x{h}, spp {spp}, K {K}, Adam lr 1e-2", flush=True)
    recs, mega2_step = phase_train(dev, card, builds["replay_fwd"]["ptxas"],
                                   builds["replay_bwd"]["ptxas"])

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

    print("[13] the probes P1-P3: the tools' main() on the card, then every "
          "kernel against its plain version", flush=True)
    recs.update(phase_probes(dev, k1_pair))

    w, h, spp = MAIN
    print(f"[14] main path on the large world: ops/render.render, "
          f"sphere_field({FIELD_LARGE}) at {w}x{h}@{spp}; K1 culled and "
          f"unculled", flush=True)
    large = phase_large_world(dev, card)

    w, h, spp, K = TRAIN
    print(f"[15] main path: parallel/train.make_train_step (engines taped "
          f"and scan), scene 0 at {w}x{h}, spp {spp}, K {K}, Adam lr 1e-2; "
          f"gates: taped vs scan, the XLA tape vs K2, the XLA replay vs "
          f"K3 / K4, card vs CPU, the differentiable render, "
          f"recover_geometry", flush=True)
    phase_general_step(dev, card, mega2_step)

    w, h, spp = BVH_FRAME
    print(f"[16] the BVH engines: bvh_closest_hit on the card vs the CPU; "
          f"bvh / wavefront_bvh vs bruteforce / wavefront at {w}x{h}@{spp} "
          f"(f64, f32); bvh vs the oracle at "
          f"{BVH_ORACLE[0]}x{BVH_ORACLE[1]}@{BVH_ORACLE[2]}; wavefront_bvh "
          f"timed against wavefront_pallas and mega2", flush=True)
    phase_bvh(dev, card)

    if any(m.startswith(("jax", "raytracinginoneweekendincuda_tpu"))
           for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    recs = {"mega2_render": dict(
        launches=launches, max_abs_err=main_st["max_abs"],
        ms=k1_frame * 1e3, plain_ms=main_plain_s * 1e3, bound=k1_bound,
        large_world=large),
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
        "probe_pair": "tools/probe_pair.py:45",
        "probe_intmul": "tools/probe_intmul.py:19",
        "probe_mosaic": "tools/probe_mosaic.py:39",
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
        "library_ms": r.get("library_ms"),
        **{k: r[k] for k in ("iters", "plain_iters", "cases",
                             "without_library", "large_world") if k in r},
    } for kname, r in recs.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
