"""P2: are 32-bit integer multiplies (pcg4d's core) slow on the card?

    python -m raytracinginoneweekendincuda_torch.tools.probe_intmul \\
        [--iters N] [--device cuda|cpu]

Port of the JAX package's probe ``tools/probe_intmul.py`` (Pallas kernel
``make``).  One launch per flavour runs ``iters`` iterations (default
5,000,000, the probe's ITERS) of an 8-op dependent chain on every element
of an [8, 128] block, x = arange(1024) + 1.5, carried as its bits:

    f32mul     x = x * 1.000001 + 1e-9
    i32mul     x = x * 1664525 + 1          (int32, wrapping)
    u32mul     x = x * 1664525 + 1          (uint32)
    u32addxor  x = (x + 0x9E3779B9) ^ (x >> 16)
    u32mix     4 x {x = x * 1664525 + 1013904223; x ^= x >> 16}

Prints ms, ns a [8x128]-op and the ratio to ``f32mul``; on the card also
the same chains over a full wave of blocks (the [8, 128] block is one
block of 1024 threads: one SM of the card's 132).  The kernel is
``csrc/probe_intmul.cu``; `intmul_chain_plain` is the same chain in
PyTorch on int32 words (two's-complement add and multiply wrap like
uint32; the logical shift masks the sign bits), and `intmul_chain`
dispatches by device.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..ops.render import resolve_device
from .common import (
    add_device_argument, best_ms, call_kernel, card_copies, check_cuda,
    describe,
)

ITERS = 5_000_000
FLAVOURS = ("f32mul", "i32mul", "u32mul", "u32addxor", "u32mix")
FLAVOUR_IDS = {f: i for i, f in enumerate(FLAVOURS)}  # csrc/probe_intmul.cu
MUL = 1664525
ADD = {"f32mul": 0, "i32mul": 1, "u32mul": 1, "u32addxor": 0x9E3779B9,
       "u32mix": 1013904223}
F_MUL = float(np.float32(1.000001))
F_ADD = float(np.float32(1e-9))


def make_input(device="cuda") -> torch.Tensor:
    """The probe's [8, 128] f32 input, arange(1024) + 1.5."""
    return (torch.arange(8 * 128, dtype=torch.float32) + 1.5).reshape(
        8, 128).to(resolve_device(device))


def _word(x: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return x - (1 << 32) if x >= (1 << 31) else x


def intmul_chain_plain(x: torch.Tensor, flavour: str,
                       iters: int) -> torch.Tensor:
    """The chain in plain PyTorch: f32 ops for ``f32mul`` (one rounding
    each), int32 words with wraparound for the others; returns f32 bits."""
    if flavour == "f32mul":
        v = x
        for _ in range(iters):
            for _ in range(8):
                v = v * F_MUL + F_ADD
        return v
    v = x.contiguous().view(torch.int32)
    add = _word(ADD[flavour])
    shr16 = lambda w: (w >> 16) & 0xFFFF
    for _ in range(iters):
        if flavour in ("i32mul", "u32mul"):
            for _ in range(8):
                v = v * MUL + add
        elif flavour == "u32addxor":
            for _ in range(8):
                v = (v + add) ^ shr16(v)
        else:
            for _ in range(4):
                v = v * MUL + add
                v = v ^ shr16(v)
    return v.view(torch.float32)


def load_kernel():
    """Build (at first use) and load the P2 kernels; returns (CDLL, build
    record)."""
    from ..utils.cuda_build import load_library

    lib, record = load_library("probe_intmul")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.probe_intmul_launch.argtypes = [i, p, i, i, f, f, u, u, i, p, p]
    lib.probe_intmul_launch.restype = i
    lib.probe_intmul_blocks_per_sm.argtypes = [i, i, ctypes.POINTER(i)]
    lib.probe_intmul_blocks_per_sm.restype = i
    return lib, record


def intmul_chain_cuda(x: torch.Tensor, flavour: str, iters: int,
                      copies: int = 1) -> torch.Tensor:
    """The chain on the card: [copies, *x.shape] f32 bits, every copy
    `intmul_chain_plain`'s.  Launches on the current stream and does not
    synchronise."""
    dev = check_cuda("intmul_chain_cuda", x)
    if x.dtype != torch.float32:
        raise ValueError("intmul_chain_cuda takes f32 words")
    lib, _ = load_kernel()
    out = torch.empty((copies, *x.shape), dtype=torch.float32, device=dev)
    call_kernel(lib.probe_intmul_launch, "probe_intmul", dev,
                FLAVOUR_IDS[flavour], x.data_ptr(), x.numel(), iters, F_MUL,
                F_ADD, MUL, ADD[flavour], copies, out.data_ptr())
    intmul_chain_cuda.launches += 1
    return out


intmul_chain_cuda.launches = 0


def full_card_copies(flavour: str, n: int, dev) -> int:
    """Copies of the [8, 128] block that make one full wave on the card."""
    lib, _ = load_kernel()
    return card_copies(lib.probe_intmul_blocks_per_sm, dev,
                       FLAVOUR_IDS[flavour], n)


def intmul_chain(x: torch.Tensor, flavour: str, iters: int) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor.
    No fallback between them."""
    if x.device.type == "cpu":
        return intmul_chain_plain(x, flavour, iters)
    if x.device.type == "cuda":
        return intmul_chain_cuda(x, flavour, iters)[0]
    raise ValueError(f"no intmul_chain for device {x.device}")


def main(argv=None) -> dict:
    """Times the five flavours; returns {flavour: readouts}."""
    p = argparse.ArgumentParser(
        description="P2: integer multiply against add, xor, shift and f32")
    p.add_argument("--iters", type=int, default=ITERS,
                   help=f"chain iterations (default {ITERS:,})")
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    x = make_input(dev)
    ops = args.iters * 8
    print(f"device: {describe(dev)}  ITERS={args.iters}", flush=True)
    results = {}
    for flavour in FLAVOURS:
        ms = best_ms(lambda: intmul_chain(x, flavour, args.iters), dev)
        res = {"ms": ms, "ns_op": ms * 1e6 / ops}
        line = (f"{flavour:10s}: {ms:8.2f} ms  ~{res['ns_op']:6.3f} "
                f"ns/[8x128]-op")
        if dev.type == "cuda":
            copies = full_card_copies(flavour, x.numel(), dev)
            card_ms = best_ms(lambda: intmul_chain_cuda(
                x, flavour, args.iters, copies), dev, 2)
            res.update(card_copies=copies, card_ms=card_ms,
                       card_ns_op=card_ms * 1e6 / (ops * copies))
            line += (f"; full wave ({copies} blocks): {card_ms:8.2f} ms, "
                     f"~{res['card_ns_op']:7.4f} ns/[8x128]-op")
        results[flavour] = res
        print(line, flush=True)
    base = results["f32mul"]
    print("ratio to f32mul: " + ", ".join(
        f"{f} {r['ns_op'] / base['ns_op']:.2f}" + (
            f" (full wave {r['card_ns_op'] / base['card_ns_op']:.2f})"
            if "card_ns_op" in r else "")
        for f, r in results.items()))
    return results


if __name__ == "__main__":
    main()
