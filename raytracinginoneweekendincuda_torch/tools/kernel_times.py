"""Device times of the kernels K1-K6 at fixed shapes, a hash of each
one's output, and the times of the train step and the
``wavefront_pallas`` frame, on one card:

    python -m raytracinginoneweekendincuda_torch.tools.kernel_times

- K1 (``render_radiance_cuda``): scene 0 at 1440x720@10 (the main path's
  frame) and 360x180@10, best of 3; scenes 1-9 at 1440x720 at the
  reference's sample counts (10 for 1-4, 200 for 5-8, 100 for 9), one run
  after a warm-up; 50 bounces;
- K2 (``trace_tapes_cuda``): scene 0 at the training step's shape,
  640x360, spp 8, K 8 (1.84 M lanes), best of 5;
- K3 (``replay_fwd_cuda``) and K4 (``replay_bwd_cuda``): the shape the
  train step launches them at, all 230,400 lanes of sample 0 of scene 0
  at 640x360, K 8, the tape traced by K2 on the step's start scene
  (``train_setup``), best of 5 batches of 10 launches;
- K5 (``mega_bounces_cuda``): scene 0's 8192-ray pool (the first refill of
  a 64x32@4 frame), K 2, best of 5 batches of 20 launches;
- K6 (``closest_geo_cuda``): the first pool of a ``wavefront_pallas``
  frame at 1440x720@10 (the camera rays of work items 0 .. 131,071) of
  scenes 0 and 9, best of 5 batches of 10 launches;
- K1 on the large world, ``models/scenes.sphere_field()`` (10,000
  spheres) at 1440x720@10, 50 bounces, best of 3: as packed by default
  (the chunk cull engaged, where the package has it) and, where the
  packer takes the cull's thresholds, with the cull forced off; with the
  frame's u8 hash, which the cull must not change;
- the two host-bound paths around K2-K4 and K6, by the host clock ended
  by ``torch.cuda.synchronize()``: the training step
  (``parallel/train.make_train_step_mega2``) at K2's shape, ms, median of
  5 steps after a warm-up, and its backward phase (K4 x spp and the
  derivation's backward; CUDA events), median of 5 more; and the
  ``wavefront_pallas`` frame of scene 0 at 1440x720@10
  (``ops/render.render``), s, median of 3 after a warm-up.

Times are CUDA events by ``tools/common.best_ms`` (each batch behind a
sleep kernel, so they are device times).  Each ``*_sha256`` is the SHA-256
of a kernel's output in the last timed call: K1's radiance sums of each
frame, K2's tape, K3's radiance, K4's (d_rep, d_rays, d_bg), K5's (rf, ri) and
K6's (t, prim); and the u8 frames of
scene 0 at 1440x720@10 (`ops/render.finalize`) and of the large world.  A
change that keeps a kernel's arithmetic keeps its hashes
(``tools/build_ab`` compares them across checkouts).  The script uses
only wrappers that every version of the port has, so it also times an
older checkout of the package: run this file by path with that checkout
first on ``PYTHONPATH``.  Prints the card and one JSON line; needs a CUDA
device.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import statistics
import sys
import time

import numpy as np
import torch

from raytracinginoneweekendincuda_torch.models.scenes import (
    build_scene, sphere_field,
)
from raytracinginoneweekendincuda_torch.ops import mega, mega2, pallas_hit
from raytracinginoneweekendincuda_torch.ops import replay as rp
from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc
from raytracinginoneweekendincuda_torch.ops.raygen import (
    camera_tuple, generate_rays,
)
from raytracinginoneweekendincuda_torch.ops.render import (
    finalize, render, resolve_device,
)
from raytracinginoneweekendincuda_torch.parallel import train
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.tools.common import best_ms
from raytracinginoneweekendincuda_torch.utils.benchmark import card_line
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig

K1_FRAMES = ((0, 1440, 720, 10, 3), (0, 360, 180, 10, 3),
             *((sid, 1440, 720, spp, 1) for sid, spp in (
                 (1, 10), (2, 10), (3, 10), (4, 10), (5, 200), (6, 200),
                 (7, 200), (8, 200), (9, 100))))   # scene, w, h, spp, repeats
K2_SHAPE = (0, 640, 360, 8, 8)          # scene, w, h, spp, K; K3 / K4
                                        # run on its sample 0
K5_POOL = (0, 64, 32, 4)                # scene, w, h, spp
K6_POOLS = (0, 9)                       # scenes; at K6_FRAME's first pool
K6_FRAME = (1440, 720, 10)              # w, h, spp
FIELD_FRAME = (1440, 720, 10)           # the large world: w, h, spp


def _frame(sid: int, w: int, h: int, spp: int, max_bounces: int, dev):
    scene, meta = compile_scene(build_scene(sid), w, h, dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_bounces=max_bounces)
    return mega2.pack_mega2_tables(scene, meta, dev), \
        mega2.frame_params(scene, cfg)


def digest(*ts: torch.Tensor) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def timed(fn, dev, *args, **kw):
    """(`best_ms` of ``fn``, the output of its last call)."""
    last = [None]

    def run():
        last[0] = fn()

    ms = best_ms(run, dev, *args, **kw)
    return ms, last[0]


def k1_times(dev) -> dict:
    out = {}
    for sid, w, h, spp, repeats in K1_FRAMES:
        tab, fp = _frame(sid, w, h, spp, 50, dev)
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        key = f"scene{sid}_{w}x{h}@{spp}"
        out[key + "_ms"], sums = timed(
            lambda: mega2.render_radiance_cuda(tab, pix, fp), dev, repeats)
        out[key + "_sha256"] = digest(sums)
        if sid == 0 and w == 1440:
            u8 = finalize(sums, spp, gamma=True, out_u8=True)
            out[key + "_u8_sha256"] = digest(u8)
        print(f"  K1 {key}: {out[key + '_ms']:.3f} ms", flush=True)
    return out


def k2_times(dev) -> dict:
    sid, w, h, spp, K = K2_SHAPE
    tab, fp = _frame(sid, w, h, 1, K, dev)
    pix, samp = mega2.tape_lanes(
        torch.arange(w * h, dtype=torch.int32, device=dev), spp)
    ms, tape = timed(lambda: mega2.trace_tapes_cuda(tab, pix, samp, fp), dev)
    return {"k2_train_shape_ms": ms, "k2_train_shape_sha256": digest(tape)}


def replay_inputs(scene, meta, tab, fp, pix, samp: int, tape, dev):
    """K3 / K4's inputs for the lanes (``pix``, sample ``samp``) of a
    frame and their tape [K, N]: (replay tables, rays [N, 7], tape,
    pix_ctr, background [3], radiance cotangent g [N, 3]); g is uniform in
    [0.5, 1.5) from seed 1984."""
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


def replay_record(k3_ms: float, out, k4_ms: float, d_rep, d_rays,
                  d_bg) -> dict:
    """kernel_times' K3 / K4 keys: the times, a hash of K3's radiance and
    of K4's (d_rep, d_rays, d_bg): K4 sums d_rep in an order fixed by the
    data, so all three repeat bit for bit."""
    return {"k3_train_shape_ms": k3_ms, "k3_train_shape_sha256": digest(out),
            "k4_train_shape_ms": k4_ms,
            "k4_train_shape_sha256": digest(d_rep, d_rays, d_bg)}


def replay_times(dev) -> dict:
    """K3 and K4 on all of sample 0's lanes at K2_SHAPE, the tape traced
    by K2 on the train step's start scene (the step's first tape of that
    sample: K2 compiles textures out, so the albedos do not move it)."""
    _, w, h, _, K = K2_SHAPE
    _, start, meta, cfg = train_start(K2_SHAPE)
    tab = mega2.pack_mega2_tables(start, meta, dev)
    fp = mega2.frame_params(start, cfg)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    tape = mega2.trace_tapes_cuda(tab, pix, torch.zeros_like(pix), fp)
    tt, rays, tape, pc, bg, g = replay_inputs(start, meta, tab, fp, pix, 0,
                                              tape, dev)
    rep = tt.rep.detach()
    k3_ms, out = timed(lambda: rc.replay_fwd_cuda(
        tt, rep, rays, tape, pc, 0, bg, t_min=fp.t_min), dev, launches=10)
    k4_ms, (d_rep, d_rays, d_bg) = timed(lambda: rc.replay_bwd_cuda(
        tt, rep, rays, tape, pc, 0, bg, g, t_min=fp.t_min), dev,
        launches=10)
    rec = replay_record(k3_ms, out, k4_ms, d_rep, d_rays, d_bg)
    print(f"  K3 {k3_ms:.4f} ms, K4 {k4_ms:.4f} ms ({w * h} lanes, K {K})",
          flush=True)
    return rec


def k5_times(dev) -> dict:
    sid, w, h, spp = K5_POOL
    scene, meta = compile_scene(build_scene(sid), w, h, dtype=np.float32)
    tabs = mega.pack_mega_tables(scene, meta, dev)
    k = torch.arange(w * h * spp, device=dev)
    o, d, tm, pc = generate_rays(camera_tuple(scene.camera), k % (w * h),
                                 k // (w * h), w, h, 1984)
    rf = torch.cat([o, d, tm[:, None], torch.ones_like(o),
                    torch.zeros_like(o)], dim=1).contiguous()
    zero = torch.zeros_like(pc)
    ri = torch.stack([pc, (k // (w * h)).to(torch.int32), zero, zero + 1],
                     dim=1).contiguous()
    kw = dict(k_bounces=mega.MEGA_K, t_min=1e-3, max_bounces=50,
              background=tuple(float(x) for x in
                               np.asarray(scene.camera.background)))
    ms, res = timed(lambda: mega.mega_bounces_cuda(rf, ri, tabs, **kw), dev,
                    launches=20)
    return {"k5_scene0_pool_ms": ms, "k5_scene0_pool_sha256": digest(*res)}


def first_pool(scene, w: int, h: int, P: int, seed: int, dev):
    """(ray_pack [P, 8], sphere table, quad table) of a ``wavefront_pallas``
    frame's first pool: the camera rays of work items 0 .. P-1 (pixel
    k % (w*h), sample k // (w*h))."""
    k = torch.arange(P, device=dev)
    o, d, tm, _ = generate_rays(camera_tuple(scene.camera), k % (w * h),
                                k // (w * h), w, h, seed)
    rays = torch.cat([o, d, tm[:, None], torch.zeros_like(tm)[:, None]],
                     dim=1).contiguous()
    return (rays, *pallas_hit.pack_geometry(scene, dev))


def k6_times(dev) -> dict:
    """K6 on the first pool of a wavefront_pallas frame of each K6_POOLS
    scene."""
    w, h, spp = K6_FRAME
    out = {}
    for sid in K6_POOLS:
        scene, _ = compile_scene(build_scene(sid), w, h, dtype=np.float32)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp)
        P = min(cfg.rays_per_batch, w * h * spp)
        rays, sph, quad = first_pool(scene, w, h, P, cfg.seed, dev)
        key = f"k6_scene{sid}_pool_"
        out[key + "ms"], res = timed(
            lambda: pallas_hit.closest_geo_cuda(rays, sph, quad, cfg.t_min),
            dev, launches=10)
        out[key + "sha256"] = digest(*res)
        print(f"  K6 scene {sid}'s {P}-ray pool: {out[key + 'ms']:.4f} ms",
              flush=True)
    return out


def field_times(dev) -> dict:
    """K1 on the large world, packed by default and (where the packer has
    the cull's thresholds) with the cull off; the default frame's hash."""
    w, h, spp = FIELD_FRAME
    scene, meta = compile_scene(sphere_field(), w, h, dtype=np.float32)
    fp = mega2.frame_params(scene, RenderConfig(
        width=w, height=h, samples_per_pixel=spp, max_bounces=50))
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    key = f"field10k_{w}x{h}@{spp}"
    packs = {key: {}}
    if "cull_min_chunks" in inspect.signature(
            mega2.pack_mega2_tables).parameters:
        packs[key + "_nocull"] = {"cull_min_chunks": 10 ** 9}
    out = {}
    for name, pack in packs.items():
        tab = mega2.pack_mega2_tables(scene, meta, dev, **pack)
        out[name + "_ms"], sums = timed(
            lambda: mega2.render_radiance_cuda(tab, pix, fp), dev, 3)
        out[name + "_sha256"] = digest(sums)
        if name == key:
            out[key + "_u8_sha256"] = digest(
                finalize(sums, spp, gamma=True, out_u8=True))
        print(f"  K1 {name}: {out[name + '_ms']:.3f} ms", flush=True)
    return out


def host_median(fn, runs: int) -> float:
    """Median seconds of ``runs`` calls of ``fn`` after a warm-up, each
    ended by torch.cuda.synchronize()."""
    fn()
    torch.cuda.synchronize()
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def train_start(shape):
    """(scene, start scene, meta, cfg) of the training step at ``shape``
    (scene, w, h, spp, K); the start is the scene with its albedos
    perturbed (x 0.5 + 0.2, clipped)."""
    sid, w, h, spp, K = shape
    scene, meta = compile_scene(build_scene(sid), w, h, dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_bounces=K, engine="mega2")
    start = scene._replace(tex_c0=np.clip(
        np.asarray(scene.tex_c0) * 0.5 + 0.2, 0.0, 1.0).astype(np.float32))
    return scene, start, meta, cfg


def train_setup(shape, dev):
    """The training step at ``shape`` (scene, w, h, spp, K), as
    ``chip_smoke.py``'s phase 9 and ``path_times`` run it: the target is
    K1's render of the scene over spp, the start is `train_start`'s, and
    Adam runs at lr 1e-2.  Returns (start scene, meta, cfg, target, train
    state, step)."""
    _, w, h, spp, _ = shape
    scene, start, meta, cfg = train_start(shape)
    target = mega2.render_radiance_cuda(
        mega2.pack_mega2_tables(scene, meta, dev),
        torch.arange(w * h, dtype=torch.int32, device=dev),
        mega2.frame_params(scene, cfg)) / float(spp)
    state = train.init_state(start, lambda ps: torch.optim.Adam(ps, lr=1e-2),
                             device=dev)
    return (start, meta, cfg, target, state,
            train.make_train_step_mega2(start, meta, cfg))


def step_phase_ms(step, box: list, pix, target) -> dict:
    """One train step on the state in ``box`` (updated), split into its
    phases (pack, trace, forward, backward, update, and the parts of the
    forward where the step marks them) by CUDA events at the step's
    ``mark`` points, a name marked more than once summed: (ms by phase,
    the step's loss)."""
    events, names = [torch.cuda.Event(enable_timing=True)], []

    def mark(name):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        names.append(name)

    events[0].record()
    box[0], loss = step(box[0], pix, target, mark=mark)
    torch.cuda.synchronize()
    ms = {}
    for n, a, b in zip(names, events, events[1:]):
        ms[n] = ms.get(n, 0.0) + a.elapsed_time(b)
    return ms, loss


def path_times(dev) -> dict:
    """The train step at K2's shape (``train_setup``): its host-clock time
    and its backward phase (``step_phase_ms``), medians of 5 steps; and the
    wavefront_pallas frame of scene 0 at K6_FRAME."""
    _, w, h, _, _ = K2_SHAPE
    *_, target, state, step = train_setup(K2_SHAPE, dev)
    pix = np.arange(w * h, dtype=np.int32)
    box = [state]

    def one_step():
        box[0], _ = step(box[0], pix, target)

    out = {"train_step_ms": host_median(one_step, 5) * 1e3,
           "train_step_backward_ms": statistics.median(
               step_phase_ms(step, box, pix, target)[0]["backward"]
               for _ in range(5))}
    w, h, spp = K6_FRAME
    scene, meta = compile_scene(build_scene(0), w, h, dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       engine="wavefront_pallas")
    out["wavefront_pallas_frame_s"] = host_median(
        lambda: render(scene, meta, cfg, device=dev), 3)
    print(f"  train step {out['train_step_ms']:.2f} ms (backward phase "
          f"{out['train_step_backward_ms']:.2f} ms), wavefront_pallas "
          f"frame {out['wavefront_pallas_frame_s']:.3f} s", flush=True)
    return out


def main(argv=None) -> dict:
    if argv:
        raise SystemExit(f"kernel_times takes no arguments, got {argv}")
    dev = resolve_device("cuda")
    card = card_line()
    print(f"card: {card}; package {mega2.__file__}", flush=True)
    res = {"card": card, "package": mega2.__file__, **k1_times(dev),
           **k2_times(dev), **replay_times(dev), **k5_times(dev),
           **k6_times(dev),
           **field_times(dev), **path_times(dev)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
