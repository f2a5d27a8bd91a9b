"""What the tools share: the ``--device`` argument, timing, the card's
peaks and a kernel's bound, and the launch of a probe kernel through its
plain C entry point."""

from __future__ import annotations

import argparse
import ctypes
import time

import torch


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (default): the CUDA kernels, on the card; cpu: their "
             "plain PyTorch versions")


def describe(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} (CUDA kernels)"
    return "cpu (plain PyTorch versions; times are host times)"


# cycles of the sleep kernel that holds the stream while the host enqueues
# one timed launch (~0.5 ms at the H100's clock, ten times the host's
# enqueue time of a launch)
SLEEP_CYCLES_A_LAUNCH = 1_000_000


# The card's peaks for the bounds (H100 SXM at 700 W): FP32 outside the
# tensor cores, device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FP32 ops over the FP32 rate."""
    tb, to = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def best_ms(fn, dev: torch.device, repeats: int = 5,
            launches: int = 1) -> float:
    """Milliseconds a call of ``fn`` takes when ``launches`` calls run back
    to back, best of ``repeats`` batches, after one warm-up call.  On the
    card, CUDA events around each batch, behind a sleep kernel that holds
    the stream while the host enqueues it: the events then time the device
    and not the host's launch overhead, which exceeds the probes'
    microsecond kernels (``fn`` must not synchronise).  On the CPU, the
    host clock."""
    fn()
    best = float("inf")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            for _ in range(repeats):
                torch.cuda._sleep(SLEEP_CYCLES_A_LAUNCH * launches)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(launches):
                    fn()
                b.record()
                b.synchronize()
                best = min(best, a.elapsed_time(b) / launches)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / launches)
    return best


def call_kernel(entry, what: str, dev: torch.device, *args) -> None:
    """Calls the C entry point ``entry(*args, stream)`` on the current
    stream of ``dev``; raises if it returns a CUDA error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def card_copies(blocks_per_sm, dev: torch.device, *args) -> int:
    """Blocks of one full wave on the card: the SM count times the resident
    blocks a SM, from the C occupancy query ``blocks_per_sm(*args, &n)``."""
    n = ctypes.c_int(0)
    err = blocks_per_sm(*args, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * max(n.value, 1)


def check_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """The device of ``tensors``: all contiguous, on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous on "
                             f"{dev}")
    return dev
