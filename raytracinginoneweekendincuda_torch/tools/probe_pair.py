"""P1: the render kernel's dense sphere-pair section, timed on the card.

    python -m raytracinginoneweekendincuda_torch.tools.probe_pair \\
        [C] [REP] [SUB] [variant,variant] [--device cuda|cpu]

Port of the JAX package's probe ``tools/probe_pair.py`` (Pallas kernel
``make_probe``), which timed ablation variants of the pair test to
attribute its cost before optimizing.  For SUB x 128 ray lanes, REP times
over C primitives: each pair's key (the smaller root of the quadratic above
``akey``, BIG when there is none), the minimum over the primitives and its
first index, ``mn + idx * 1e-9``, summed over REP.  Defaults C=512, REP=500,
SUB=8, all variants.  Prints ns a pair, Gpair/s and the attribution
against ``full``; on the card also the rate of a launch that repeats the
probe's one block over a full wave of the card (the TPU shape, [8, 128],
fills one SM of 132).

The kernel is ``csrc/probe_pair.cu``; `probe_pair_plain` is the same
arithmetic in PyTorch, in the kernel's order (16-term dots left to right,
no FMA), and `probe_pair` dispatches by device.  The TPU probe's variants
that differ only in how Mosaic scheduled them compute the same values as
one kernel variant and launch it (`KERNEL_OF`): ``fuseddot``,
``dotsfirst``, ``treereduce``, ``df_tree`` and ``wide{2,4,8}_tree`` launch
``full`` (a tree reduction with left-biased ties picks the first index of
the minimum as well, except on exact ties of two finite keys), and
``wide8_dotsonly`` launches ``dotsonly``.  The inputs are the probe's:
``coef`` [2C, 16] from ``default_rng(0)``, ``ray`` [11*SUB, 128] from
``default_rng(1)`` with ``a > 0`` and ``akey = 0.001 * a``.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..core.samplers import sqrt_f32
from ..ops.render import resolve_device
from .common import (
    add_device_argument, best_ms, call_kernel, card_copies, check_cuda,
    describe,
)

R = 128
BIG = float(np.float32(1.0e30))
TWEAK = np.float32(1e-20)         # dx moves by it * TWEAK (anti-hoist)
IDX_SCALE = float(np.float32(1e-9))

VARIANTS = ["full", "fuseddot", "bf16dot", "nodots", "nosqrt", "noselect",
            "noidx", "noreduce", "dotsonly", "treereduce", "k8dot",
            "dotsfirst", "df_tree", "wide2_tree", "wide4_tree",
            "wide8_tree", "wide8_dotsonly", "direct"]
# the kernel variant each probe variant launches (ids of csrc/probe_pair.cu)
KERNEL_IDS = {"full": 0, "bf16dot": 1, "nodots": 2, "nosqrt": 3,
              "noselect": 4, "noidx": 5, "noreduce": 6, "dotsonly": 7,
              "k8dot": 8, "direct": 9}
KERNEL_OF = {v: v for v in KERNEL_IDS}
KERNEL_OF.update({v: "full" for v in (
    "fuseddot", "dotsfirst", "treereduce", "df_tree", "wide2_tree",
    "wide4_tree", "wide8_tree")})
KERNEL_OF["wide8_dotsonly"] = "dotsonly"


def make_inputs(n_prim: int, sub: int, device="cuda"):
    """(coef [2C, 16], ray [11*SUB, 128]) f32 on ``device``: the probe's
    inputs, bit for bit."""
    dev = resolve_device(device)
    coef = np.random.default_rng(0).standard_normal(
        (2 * n_prim, 16)).astype(np.float32)
    ray = np.random.default_rng(1).standard_normal(
        (11 * sub, R)).astype(np.float32)
    ray[7 * sub:8 * sub] = np.abs(ray[7 * sub:8 * sub]) + np.float32(1.0)
    ray[10 * sub:11 * sub] = np.float32(0.001) * ray[7 * sub:8 * sub]
    return torch.as_tensor(coef, device=dev), torch.as_tensor(ray, device=dev)


def _sizes(coef: torch.Tensor, ray: torch.Tensor):
    if coef.dim() != 2 or coef.shape[1] != 16 or coef.shape[0] % 2 \
            or ray.dim() != 2 or ray.shape[1] != R or ray.shape[0] % 11:
        raise ValueError("coef must be [2C, 16] and ray [11*SUB, 128]")
    if coef.dtype != torch.float32 or ray.dtype != torch.float32:
        raise ValueError("coef and ray must be f32")
    return coef.shape[0] // 2, ray.shape[0] // 11


def probe_pair_plain(coef, ray, variant: str, rep: int) -> torch.Tensor:
    """The probe's [SUB, 128] result in plain PyTorch, op for op as
    ``csrc/probe_pair.cu`` computes it."""
    kv = KERNEL_OF[variant]
    n_prim, sub = _sizes(coef, ray)
    row = lambda k: ray[k * sub:(k + 1) * sub]                 # [SUB, R]
    col = lambda j, hi=0: coef[hi * n_prim:(hi + 1) * n_prim, j].reshape(
        n_prim, 1, 1)                                          # [C, 1, 1]
    dx0, dy, dz = row(0), row(1), row(2)
    opx, opy, opz = row(3), row(4), row(5)
    tmv, a, akey = row(6), row(7), row(10)
    oo = opx * opx + opy * opy + opz * opz
    one, zero = torch.ones_like(dx0), torch.zeros_like(dx0)
    iota = torch.arange(n_prim, device=coef.device).reshape(n_prim, 1, 1)
    bf16 = lambda x: x.to(torch.bfloat16).to(torch.float32)

    def dot(feats, hi):
        cv = lambda k: bf16(col(k, hi)) if kv == "bf16dot" else col(k, hi)
        s = cv(0) * feats[0]
        for k in range(1, len(feats)):
            s = s + cv(k) * feats[k]
        return s

    acc = torch.zeros_like(dx0)
    for it in range(rep):
        dx = dx0 + float(np.float32(it) * TWEAK)
        od = opx * dx + opy * dy + opz * dz
        if kv == "direct":
            ocx, ocy, ocz = opx - col(0), opy - col(1), opz - col(2)
            rad = col(3)
            b = ocx * dx + ocy * dy + ocz * dz
            cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        elif kv == "nodots":
            b, cc = col(0) + od, col(0, 1) + oo
        elif kv == "k8dot":
            f8 = [dx, dy, dz, opx, opy, opz, one, zero]
            b, cc = dot(f8, 0) + od, dot(f8, 1) + oo
        else:
            f = [dx, dy, dz, tmv * dx, tmv * dy, tmv * dz, opx, opy, opz,
                 tmv * opx, tmv * opy, tmv * opz, one, tmv, tmv * tmv, zero]
            if kv == "bf16dot":
                f = [bf16(x) for x in f]
            b, cc = dot(f, 0) + od, dot(f, 1) + oo
        if kv == "dotsonly":
            acc = acc + (b[0] + cc[0])
            continue
        disc = b * b - a * cc
        sq = disc * 0.5 if kv == "nosqrt" else sqrt_f32(disc)
        k1 = -b - sq
        k2 = -b + sq
        if kv == "noselect":
            key = k1 + k2
        else:
            key = torch.where(k1 > akey, k1, k2)
            key = torch.where((disc > 0.0) & (key > akey), key, BIG)
        if kv == "noreduce":
            acc = acc + key[0]
            continue
        mn = key.amin(0)                       # NaN if any key is NaN
        if kv == "noidx":
            acc = acc + mn
            continue
        idx = torch.where(key == mn, iota, n_prim).amin(0)
        acc = acc + (mn + idx.to(torch.float32) * IDX_SCALE)
    return acc


def load_kernel():
    """Build (at first use) and load the P1 kernels; returns (CDLL, build
    record)."""
    from ..utils.cuda_build import load_library

    lib, record = load_library("probe_pair")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_pair_launch.argtypes = [i, p, p, i, i, i, i, p, p]
    lib.probe_pair_launch.restype = i
    lib.probe_pair_blocks_per_sm.argtypes = [i, i, ctypes.POINTER(i)]
    lib.probe_pair_blocks_per_sm.restype = i
    return lib, record


def probe_pair_cuda(coef, ray, variant: str, rep: int,
                    copies: int = 1) -> torch.Tensor:
    """The kernel on the card: [copies, SUB, 128], every copy
    `probe_pair_plain`'s values.  Launches on the current stream and does
    not synchronise."""
    dev = check_cuda("probe_pair_cuda", coef, ray)
    n_prim, sub = _sizes(coef, ray)
    lib, _ = load_kernel()
    out = torch.empty((copies, sub, R), dtype=torch.float32, device=dev)
    call_kernel(lib.probe_pair_launch, "probe_pair", dev,
                KERNEL_IDS[KERNEL_OF[variant]], coef.data_ptr(),
                ray.data_ptr(), n_prim, sub, rep, copies, out.data_ptr())
    probe_pair_cuda.launches += 1
    return out


probe_pair_cuda.launches = 0


def full_card_copies(variant: str, sub: int, dev) -> int:
    """Copies of the probe's block that make one full wave on the card."""
    lib, _ = load_kernel()
    return card_copies(lib.probe_pair_blocks_per_sm, dev,
                       KERNEL_IDS[KERNEL_OF[variant]], sub)


def probe_pair(coef, ray, variant: str, rep: int) -> torch.Tensor:
    """[SUB, 128]: the plain version for CPU tensors, the kernel for CUDA
    tensors.  No fallback between them."""
    if coef.device.type == "cpu":
        return probe_pair_plain(coef, ray, variant, rep)
    if coef.device.type == "cuda":
        return probe_pair_cuda(coef, ray, variant, rep)[0]
    raise ValueError(f"no probe_pair for device {coef.device}")


def main(argv=None) -> dict:
    """Times the variants; returns {variant: readouts} (ms and ns a pair
    at the probe's shape, and on the card the full wave's)."""
    p = argparse.ArgumentParser(
        description="P1: time the sphere-pair section's variants")
    p.add_argument("C", nargs="?", type=int, default=512,
                   help="primitives (default 512)")
    p.add_argument("REP", nargs="?", type=int, default=500,
                   help="iterations (default 500)")
    p.add_argument("SUB", nargs="?", type=int, default=8,
                   help="sub-rows of 128 lanes (default 8)")
    p.add_argument("variants", nargs="?", default=None,
                   help="comma-separated variants (default all)")
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    only = args.variants.split(",") if args.variants else VARIANTS
    unknown = [v for v in only if v not in KERNEL_OF]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {VARIANTS}")

    n_prim, rep, sub = args.C, args.REP, args.SUB
    coef, ray = make_inputs(n_prim, sub, dev)
    pairs = rep * n_prim * R * sub
    print(f"device: {describe(dev)}  C={n_prim} REP={rep} SUB={sub}",
          flush=True)
    results = {}
    for v in only:
        ms = best_ms(lambda: probe_pair(coef, ray, v, rep), dev)
        res = {"ms": ms, "ns_pair": ms * 1e6 / pairs,
               "gpair_s": pairs / ms / 1e6}
        line = (f"{v:14s}: {ms:8.2f} ms  {res['ns_pair']:6.4f} ns/pair "
                f"({res['gpair_s']:6.1f} Gpair/s)")
        if dev.type == "cuda":
            copies = full_card_copies(v, sub, dev)
            card_ms = best_ms(lambda: probe_pair_cuda(coef, ray, v, rep,
                                                      copies), dev, 2)
            res.update(card_copies=copies, card_ms=card_ms,
                       card_gpair_s=pairs * copies / card_ms / 1e6)
            line += (f"; full wave ({copies} blocks): {card_ms:8.2f} ms, "
                     f"{res['card_gpair_s']:7.1f} Gpair/s")
        results[v] = res
        print(line, flush=True)
    base = results.get("full")
    if base:
        print("\nattribution vs full:")
        for v, res in results.items():
            if v == "full":
                continue
            d = base["ns_pair"] - res["ns_pair"]
            print(f"  {v:14s}: {d:+7.4f} ns/pair "
                  f"({100 * d / base['ns_pair']:+5.1f}%)")
    return results


if __name__ == "__main__":
    main()
