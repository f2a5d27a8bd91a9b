"""On-card validation of the port against its CPU build: the counterpart
of the JAX package's ``tools/validate_tpu.py``, with its sections,
configurations and gates.  The CPU reference is the port's own plain
engines, run on the card host's CPU.

1. Engines against the CPU, with a noise floor: scenes 0, 4, 6 and 8 at
   96x54@4 (f32, no gamma) through ``mega2`` (K1), ``mega`` (K5) and
   ``wavefront_pallas`` (K6) on the card, against ``bruteforce`` on the
   CPU at seed 1984; the noise floor is a second CPU frame at seed 31337.
   Gate: the p99 of |card - CPU| over the p99 of |reseed - CPU| below 1.5.
   The share of "re-rolled" pixels (a channel off by more than 1e-3) is
   recorded.
2. Convergence: scene 0 through ``mega`` at 4 and 64 spp against CPU
   ``bruteforce`` at the same spp.  Gate: p99 at 4 spp below 0.03, or a
   shrink from 4 to 64 spp above 2.5.
3. Frame hashes pinned on the card: K1's u8 frames of scenes 0-9 at
   `HASH_CONFIG` (SHA-256, first 16 hex digits), against the hashes
   recorded in ``VALIDATION_TORCH.json``: NEW, ok or CHANGED a scene; a
   change fails unless ``--hash-intended REASON`` gives its reason, which
   is recorded.  The same frames from the CPU build (``mega2`` on the
   CPU: K1's plain version): whether the u8 hashes are equal, and where
   they are not, the float frames held to the port's CPU-against-JAX
   bounds (`cpu_bounds`).
4. The north star against the CPU: ``book1_final()`` at 1200x675@4 on
   the card (``mega2``) against CPU ``bruteforce`` at seeds 1984 and
   31337.  A whole CPU frame takes ~40 min a seed, so the CPU renders
   every 16th pixel id (``ops/render.render_chunk``) and the card frame's
   same pixels are compared.  Gate: the p99 ratio below 1.5.
5. Fast-gradient FD at the north-star shape: 8192 pixels, K 6, spp 2,
   K2's tape of sample 0 in global ids; the loss is a seeded weighted sum
   of K3's radiance as a function of the albedos ``tex_c0``, its gradient
   K4's; the direction has its L-infinity norm set to 1, eps 1e-3.  Gate:
   rel < 0.15.
6. The oracle at a real frame size: ``bruteforce`` in f64 on the card
   against ``testing/oracle.Oracle`` at 96x54@8, 50 bounces, on scenes 0,
   3 and 9.  Gate: ``testing/compare.assert_images_close``'s defaults.

Prints one line a check and the metrics as one JSON line (also to
``--json PATH``); exits non-zero if any gate fails.  ``--sections 1,3``
runs a subset.  Needs a CUDA device.

    python -m raytracinginoneweekendincuda_torch.tools.validate_gpu \
        [--sections 1,2,3,4,5,6] [--json PATH] [--hash-intended REASON]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..models.scenes import book1_final, build_scene
from ..ops import hit, mega2
from ..ops import replay as rp
from ..ops import replay_cuda as rc
from ..ops.raygen import generate_rays
from ..ops.render import finalize, render, render_chunk, resolve_device
from ..scene.compiler import compile_scene
from ..testing.compare import assert_images_close
from ..testing.oracle import Oracle
from ..utils.benchmark import ROOT, device_line
from ..utils.config import RenderConfig

W, H = 96, 54
SEED, SEED2 = 1984, 31337
LOW = ((0, 4), (4, 4), (6, 4), (8, 4))
CONV = ((0, 4), (0, 64))
CARD_ENGINES = ("mega2", "mega", "wavefront_pallas")
RATIO_MAX = 1.5            # p99 over the reseed noise floor
REROLL_TOL = 1e-3
HASH_FRAME = (96, 54, 4)
HASH_CONFIG = "mega2 96x54@4 seed1984 u8"
RECORD = os.path.join(ROOT, "VALIDATION_TORCH.json")
# the port's CPU-against-JAX bounds (ROADMAP.md, "How each slice is
# held"; tests/test_mega2.py): flipped pixels (a channel off by more than
# 1e-5) allowed a 128-pixel frame, scaled to the frame, and a mean below
# 5e-3; on the noise and image scenes more than 90% of pixels within 1e-2
# and a mean below 2e-2
MAX_BAD = {0: 6, 1: 2, 4: 2, 6: 2, 7: 2, 8: 2}
NOISE_IMAGE = (2, 3, 5, 9)
NS = (1200, 675, 4)        # the north star against the CPU
NS_STRIDE = 16
NS_FD = dict(n_pix=8192, max_bounces=6, spp=2)
FD_EPS = 1e-3
FD_REL_MAX = 0.15
ORACLE = (96, 54, 8)
ORACLE_SCENES = (0, 3, 9)
T_MIN = 1e-3
CPU = torch.device("cpu")


def frame(desc, engine: str, spp: int, seed: int, dev, width: int = W,
          height: int = H) -> np.ndarray:
    """Float frame [H, W, 3] (no gamma, top row first) of the scene
    ``desc`` through ``engine`` on ``dev``."""
    scene, meta = compile_scene(desc, width, height, dtype=np.float32)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       engine=engine, seed=seed)
    return render(scene, meta, cfg, device=dev, gamma=False)


def reroll_stats(img: np.ndarray, ref: np.ndarray,
                 ref2: np.ndarray) -> dict:
    """The p99 of |img - ref| over the reseed noise floor's (|ref2 -
    ref|), and the share of pixels with a channel off by more than 1e-3."""
    noise = float(np.percentile(np.abs(ref2 - ref), 99))
    d = np.abs(img - ref)
    p99 = float(np.percentile(d, 99))
    return {"p99": p99, "noise_p99": noise,
            "ratio": p99 / max(noise, 1e-9),
            "rerolled": float((d.max(-1) > REROLL_TOL).mean())}


def frame_hash(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()) \
        .hexdigest()[:16]


def mega2_frames(sid: int, dev, width: int, height: int, spp: int,
                 max_bounces: int = 50):
    """(u8, float) frames [H, W, 3] of scene ``sid`` from one ``mega2``
    render on ``dev`` (K1 on the card, its plain version on the CPU),
    gamma applied, as ``render(..., out_u8=True)`` and ``render()`` give
    them."""
    scene, meta = compile_scene(build_scene(sid), width, height,
                                dtype=np.float32)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_bounces=max_bounces, seed=SEED)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fb = mega2.render_mega2(tab, mega2.frame_params(scene, cfg))

    def img(x):
        return x.cpu().numpy().reshape(height, width, 3)[::-1]
    return (img(finalize(fb, spp, gamma=True, out_u8=True)),
            img(finalize(fb, spp, gamma=True, out_u8=False)))


def cpu_bounds(sid: int, img: np.ndarray, ref: np.ndarray) -> dict:
    """The port's CPU-against-JAX bounds (`MAX_BAD`, `NOISE_IMAGE`) on two
    float frames; ``ok`` says whether they hold."""
    diff = np.abs(img.astype(np.float64) - ref)
    mean = float(diff.mean())
    if sid in NOISE_IMAGE:
        close = float((diff.max(-1) < 1e-2).mean())
        return {"close_frac": close, "mean": mean,
                "ok": close > 0.9 and mean < 2e-2}
    bad = int((diff.max(-1) > 1e-5).sum())
    allowed = MAX_BAD[sid] * diff.shape[0] * diff.shape[1] // 128
    return {"flipped": bad, "allowed": allowed, "mean": mean,
            "ok": bad <= allowed and mean < 5e-3}


def previous_hashes(path: str = RECORD) -> dict:
    """The card's frame hashes recorded in ``path`` at `HASH_CONFIG`
    ({} when there are none)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        sec = json.load(f).get("engines_vs_cpu", {})
    if sec.get("card_frame_hash_config") != HASH_CONFIG:
        return {}
    return dict(sec.get("card_frame_hashes", {}))


def pin_hashes(hashes: dict, prev: dict, intended: str = "",
               strict: bool = False):
    """(ok, tags, note): each scene's tag NEW, ok or CHANGED against the
    recorded hashes ``prev``; a change fails unless ``intended`` gives
    its reason, which becomes the note.  With ``strict`` (a run that
    checks the record rather than writes it) a scene the record lacks,
    NEW, fails too."""
    tags = {sid: ("NEW" if sid not in prev else
                  "ok" if prev[sid] == h else "CHANGED")
            for sid, h in hashes.items()}
    changed = [sid for sid, t in tags.items() if t == "CHANGED"]
    if (changed and not intended) or (strict and "NEW" in tags.values()):
        return False, tags, None
    return True, tags, (intended if changed else None)


def card_vs_cpu_frames(dev) -> dict:
    """Per scene 0-9: K1's u8 frame hash at the hash config, the CPU
    build's, whether they are equal, and the float frames' `cpu_bounds`
    ("bounds")."""
    w, h, spp = HASH_FRAME
    out = {}
    for sid in range(10):
        u8, img = mega2_frames(sid, dev, w, h, spp)
        u8_cpu, img_cpu = mega2_frames(sid, CPU, w, h, spp)
        card_h, cpu_h = frame_hash(u8), frame_hash(u8_cpu)
        out[str(sid)] = {"card": card_h, "cpu": cpu_h,
                         "equal": card_h == cpu_h,
                         "bounds": cpu_bounds(sid, img, img_cpu)}
    return out


def sec_engines(dev, m: dict, frames) -> bool:
    ok = True
    for sid, spp in LOW:
        ref = frames("bruteforce", CPU, sid, spp, SEED)
        ref2 = frames("bruteforce", CPU, sid, spp, SEED2)
        for engine in CARD_ENGINES:
            st = reroll_stats(frames(engine, dev, sid, spp, SEED), ref, ref2)
            good = st["ratio"] < RATIO_MAX
            ok &= good
            m[f"scene{sid}_reseed_noise_p99"] = st["noise_p99"]
            m[f"scene{sid}_{engine}_rerolled_frac"] = st["rerolled"]
            m[f"scene{sid}_{engine}_p99_over_noise"] = st["ratio"]
            print(f"scene {sid} {engine:16s} {W}x{H}@{spp}: "
                  f"{st['rerolled'] * 100:5.2f}% pixels re-rolled, p99 "
                  f"{st['p99']:.5f} / noise {st['noise_p99']:.5f} = "
                  f"{st['ratio']:.3f} [{'ok' if good else 'FAIL'}]",
                  flush=True)
    return ok


def sec_convergence(dev, m: dict, frames) -> bool:
    p99 = {}
    for sid, spp in CONV:
        d = np.abs(frames("mega", dev, sid, spp, SEED)
                   - frames("bruteforce", CPU, sid, spp, SEED))
        p99[spp] = float(np.percentile(d, 99))
        print(f"scene {sid} mega vs CPU bruteforce at {spp} spp: p99 "
              f"|diff| {p99[spp]:.5f}", flush=True)
    lo, hi = (spp for _, spp in CONV)
    shrink = p99[lo] / max(p99[hi], 1e-9)
    ok = p99[lo] < 0.03 or shrink > 2.5
    m.update({f"p99_diff_spp{lo}": p99[lo], f"p99_diff_spp{hi}": p99[hi],
              f"p99_shrink_{lo}_to_{hi}": shrink})
    print(f"p99 shrink {lo}->{hi} spp: {shrink:.2f}x (gate: p99 at {lo} "
          f"< 0.03 or shrink > 2.5) [{'ok' if ok else 'FAIL'}]", flush=True)
    return ok


def sec_hashes(dev, m: dict, intended: str = "",
               strict: bool = False) -> bool:
    recs = card_vs_cpu_frames(dev)
    hashes = {sid: r["card"] for sid, r in recs.items()}
    ok, tags, note = pin_hashes(hashes, previous_hashes(), intended, strict)
    for sid, r in recs.items():
        line = (f"scene {sid}: card {r['card']} [{tags[sid]}]; CPU build "
                f"{r['cpu']} ({'equal' if r['equal'] else 'differs'})")
        if not r["equal"]:
            ok &= r["bounds"]["ok"]
            line += (f"; float frames {json.dumps(r['bounds'])} "
                     f"[{'ok' if r['bounds']['ok'] else 'FAIL'}]")
        print(line, flush=True)
    changed = [sid for sid, t in tags.items() if t == "CHANGED"]
    if strict and "NEW" in tags.values():
        print("FAIL: the record pins no hash for scenes "
              f"{[sid for sid, t in tags.items() if t == 'NEW']}",
              flush=True)
    if changed and note is None:
        print(f"FAIL: the card's frame hash changed for scenes {changed} "
              f"without --hash-intended", flush=True)
    elif changed:
        print(f"hash change on scenes {changed} accepted: {note}",
              flush=True)
        m["card_frame_hash_change_note"] = note
    m["card_frame_hash_config"] = HASH_CONFIG
    m["card_frame_hashes"] = hashes
    m["card_frame_hash_tags"] = tags
    m["cpu_frame_hashes"] = {sid: r["cpu"] for sid, r in recs.items()}
    m["card_cpu_hash_equal"] = {sid: r["equal"] for sid, r in recs.items()}
    m["card_cpu_float_bounds"] = {sid: r["bounds"]
                                  for sid, r in recs.items()}
    return ok


def ns_cpu_pixels(seed: int) -> np.ndarray:
    """CPU ``bruteforce`` colours [P, 3] (no gamma) of every
    `NS_STRIDE`-th pixel id of the north-star frame."""
    w, h, spp = NS
    scene, meta = compile_scene(book1_final(), w, h, dtype=np.float32)
    st = hit.scene_tensors(scene, CPU)
    pix = torch.arange(0, w * h, NS_STRIDE, device=CPU)
    col = render_chunk(st, meta, pix, width=w, height=h, spp=spp,
                       seed=seed, max_bounces=50, t_min=T_MIN, gamma=False,
                       engine="bruteforce")
    return col.numpy()


def sec_north_star(dev, m: dict) -> bool:
    w, h, spp = NS
    stride = NS_STRIDE
    img = frame(book1_final(), "mega2", spp, SEED, dev, w, h)
    card = img[::-1].reshape(-1, 3)[::stride]      # pixel ids j*W + i
    ref = ns_cpu_pixels(SEED)
    ref2 = ns_cpu_pixels(SEED2)
    st = reroll_stats(card, ref, ref2)
    ok = st["ratio"] < RATIO_MAX
    m.update(ns_p99=st["p99"], ns_noise_p99=st["noise_p99"],
             ns_p99_over_noise=st["ratio"], ns_rerolled_frac=st["rerolled"],
             ns_pixel_stride=stride, ns_pixels=int(card.shape[0]))
    print(f"north star {w}x{h}@{spp}, every {stride}th pixel id "
          f"({card.shape[0]} pixels; the CPU renders only those): p99 "
          f"{st['p99']:.5f} vs reseed noise {st['noise_p99']:.5f} -> ratio "
          f"{st['ratio']:.3f} [{'ok' if ok else 'FAIL'}]", flush=True)
    return ok


class FdCase(NamedTuple):
    scene: object             # numpy SceneArrays
    meta: object
    tab: object               # packed tables (the replay's textures)
    pix: np.ndarray           # [P] int32
    tape: torch.Tensor        # [K, P] sample 0, global ids (K2)
    o: torch.Tensor
    d: torch.Tensor
    tm: torch.Tensor
    pc: torch.Tensor
    wgt: torch.Tensor         # [P, 3]
    v: torch.Tensor           # direction, |v|_inf = 1, tex_c0's shape


def fd_case(dev, *, width: int = NS[0], height: int = NS[1],
            n_pix: int = NS_FD["n_pix"],
            max_bounces: int = NS_FD["max_bounces"],
            spp: int = NS_FD["spp"]) -> FdCase:
    """The fast-gradient FD check's inputs (the JAX tool's draws from
    ``default_rng(11)``, in its order)."""
    scene, meta = compile_scene(book1_final(), width, height,
                                dtype=np.float32)
    rng = np.random.default_rng(11)
    pix = np.sort(rng.choice(width * height, n_pix, replace=False)) \
        .astype(np.int32)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    tape = mega2.mega2_tapes(scene, meta, pix, spp, width=width,
                             height=height, max_bounces=max_bounces,
                             t_min=T_MIN, seed=SEED, id_space="global",
                             device=dev, tab=tab)[0]
    cam = hit.scene_tensors(scene, dev).camera
    o, d, tm, pc = generate_rays(cam, torch.as_tensor(pix, device=dev), 0,
                                 width, height, SEED)
    wgt = torch.as_tensor(rng.standard_normal((n_pix, 3)),
                          dtype=torch.float32, device=dev)
    v = rng.standard_normal(np.asarray(scene.tex_c0).shape)
    v = torch.as_tensor(v / np.abs(v).max(), dtype=torch.float32,
                        device=dev)
    return FdCase(scene, meta, tab, pix, tape, o, d, tm, pc, wgt, v)


def fd_check(case: FdCase, eps: float = FD_EPS) -> dict:
    """The loss's directional derivative along ``case.v`` by K4 (autograd
    of K3; the plain versions on the CPU) and by a central difference of
    K3's loss."""
    dev = case.tape.device
    bg = torch.as_tensor(np.asarray(case.scene.camera.background),
                         dtype=torch.float32, device=dev)
    rays = torch.cat([case.o, case.d, case.tm[:, None]], dim=1)

    def loss(tex):
        tt = rp.replay_table(case.scene._replace(tex_c0=tex), case.meta,
                             case.tab)
        return (rc.replay(tt, rays, case.tape, case.pc, 0, bg, t_min=T_MIN)
                * case.wgt).sum()

    tex0 = torch.as_tensor(np.asarray(case.scene.tex_c0),
                           dtype=torch.float32, device=dev)
    leaf = tex0.clone().requires_grad_(True)
    g = torch.autograd.grad(loss(leaf), leaf)[0]
    ad = float((g * case.v).sum())
    with torch.no_grad():
        fd = float(loss(tex0 + eps * case.v) - loss(tex0 - eps * case.v)) \
            / (2 * eps)
    return {"ad": ad, "fd": fd, "rel": abs(fd - ad) / max(abs(fd), 1e-12)}


def sec_fastgrad(dev, m: dict) -> bool:
    case = fd_case(dev)
    r = fd_check(case)
    ok = r["ad"] != 0.0 and r["fd"] != 0.0 and r["rel"] < FD_REL_MAX
    m.update(ns_fastgrad_fd_rel=r["rel"], ns_fastgrad_ad=r["ad"],
             ns_fastgrad_fd=r["fd"])
    print(f"north-star fast-grad FD (K2's tape, K3 / K4, {NS[0]}x{NS[1]}, "
          f"{len(case.pix)} pixels, K {case.tape.shape[0]}): AD "
          f"{r['ad']:.6e} FD {r['fd']:.6e} rel {r['rel']:.5f} "
          f"[{'ok' if ok else 'FAIL'}]", flush=True)
    return ok


def oracle_check(sid: int, dev) -> dict:
    """``bruteforce`` in f64 on ``dev`` against the oracle at `ORACLE`,
    with ``assert_images_close``'s defaults."""
    w, h, spp = ORACLE
    sc, mt = compile_scene(build_scene(sid), w, h, dtype=np.float64)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       dtype="float64", engine="bruteforce")
    t0 = time.perf_counter()
    img = render(sc, mt, cfg, device=dev)
    t1 = time.perf_counter()
    want = Oracle(sc, mt, w, h, cfg.seed).render(spp)
    t2 = time.perf_counter()
    diff = np.abs(img - want).max(-1)
    rec = {"bulk_frac": float((diff <= 1e-9).mean()),
           "mean": float(diff.mean()), "worst": float(diff.max()),
           "engine_s": t1 - t0, "oracle_s": t2 - t1}
    try:
        assert_images_close(img, want, label=f"scene {sid}")
        rec["ok"] = True
    except AssertionError as e:
        rec.update(ok=False, message=str(e))
    return rec


def sec_oracle(dev, m: dict) -> bool:
    ok = True
    w, h, spp = ORACLE
    for sid in ORACLE_SCENES:
        r = oracle_check(sid, dev)
        ok &= r["ok"]
        m[f"oracle_scene{sid}"] = r
        print(f"scene {sid} bruteforce f64 vs the oracle at {w}x{h}@{spp}, "
              f"50 bounces: {r['bulk_frac']:.4%} of pixels within 1e-9, "
              f"mean {r['mean']:.2e}, worst {r['worst']:.2e}; engine "
              f"{r['engine_s']:.1f} s, oracle {r['oracle_s']:.1f} s "
              f"[{'ok' if r['ok'] else 'FAIL'}]", flush=True)
    m["oracle_config"] = f"{w}x{h}@{spp}, 50 bounces, f64"
    return ok


SECTIONS = {1: "engines against the CPU, with a noise floor",
            2: "convergence", 3: "frame hashes pinned on the card",
            4: "the north star against the CPU",
            5: "fast-gradient FD at the north-star shape",
            6: "the oracle at a real frame size"}


def validate(device="cuda", sections=tuple(SECTIONS), intended: str = "",
             strict: bool = False) -> dict:
    """Runs ``sections``; the metrics, with each section's seconds and
    ``ok``.  ``strict`` fails section 3 on a scene whose hash the record
    lacks (`pin_hashes`)."""
    dev = resolve_device(device)
    m = {"card": device_line(dev), "sections": list(sections)}
    cache = {}

    def frames(engine, on, sid, spp, seed):
        key = (engine, on.type, sid, spp, seed)
        if key not in cache:
            cache[key] = frame(build_scene(sid), engine, spp, seed, on)
        return cache[key]

    run = {1: lambda: sec_engines(dev, m, frames),
           2: lambda: sec_convergence(dev, m, frames),
           3: lambda: sec_hashes(dev, m, intended, strict),
           4: lambda: sec_north_star(dev, m),
           5: lambda: sec_fastgrad(dev, m),
           6: lambda: sec_oracle(dev, m)}
    ok = True
    for n in sections:
        print(f"\n-- {n}. {SECTIONS[n]} --", flush=True)
        t0 = time.perf_counter()
        good = bool(run[n]())
        m[f"section{n}_ok"] = good
        m[f"section{n}_seconds"] = time.perf_counter() - t0
        ok &= good
    m["ok"] = bool(ok)
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default=",".join(map(str, SECTIONS)),
                    help="comma-separated section numbers (default all)")
    ap.add_argument("--json", default=None, help="also write the metrics "
                    "here")
    ap.add_argument("--hash-intended", default="", metavar="REASON",
                    help="accept a change of the card's frame hashes, "
                         "recording REASON")
    args = ap.parse_args(argv)
    sections = tuple(int(s) for s in args.sections.split(","))
    if not set(sections) <= set(SECTIONS):
        ap.error(f"--sections: each of {sorted(SECTIONS)}")
    metrics = validate("cuda", sections, args.hash_intended)
    print(json.dumps(metrics))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=1)
    return 0 if metrics["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
