"""P3: the patterns a kernel's design rests on -- loops, gathers, small dots,
trig -- as CUDA kernels on the card.

    python -m raytracinginoneweekendincuda_torch.tools.probe_mosaic \\
        [-v] [--device cuda|cpu]

Port of the JAX package's probe ``tools/probe_mosaic.py``, whose eleven
Pallas kernels asked whether Mosaic could lower each pattern.  Here every
probe is a function of the same name that builds the probe's inputs and
runs them through one of eight kernels of ``csrc/probe_mosaic.cu``; it
prints ``OK`` with the first values (a failure raises), and
``probe_gather_timing`` reports microseconds a gather.  ``-v`` adds each
output's shape and dtype.

Each kernel has a plain PyTorch version beside its CUDA wrapper; a probe
(`Case`) takes the plain version for CPU tensors and the kernel for CUDA
tensors, with no fallback between them.  The dots sum left to right in
f32 on CUDA cores, and so do their plain versions; the gathers are exact
and clamp an index outside the table to its edge (jnp's ``mode="clip"``;
the probes' indices are in range), so a launch needs no host check.
`CASES` lists each probe's inputs and kernel for the tests and
``chip_smoke.py``, with seeded random inputs of the same shapes: the
tool's inputs (ones, constants, zero indices) would let a kernel that
swaps its operands or reads the wrong element pass.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.render import resolve_device
from .common import (
    add_device_argument, best_ms, call_kernel, check_cuda, describe,
)

GATHER_REP = 200      # gathers a probe_gather_timing launch sums
TIMING_CALLS = 50     # launches probe_gather_timing averages over
HOT = 3               # the one-hot probe's winner id
RANDOM_SEED = 0       # the seed of every probe's random inputs


def load_kernel():
    """Build (at first use) and load the P3 kernels; returns (CDLL, build
    record)."""
    from ..utils.cuda_build import load_library

    lib, record = load_library("probe_mosaic")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("while_vector_cond", [p, i, p]),
            ("gather_lane", [p, i, i, p, p]),
            ("gather_rows", [p, i, i, p, i, p]),
            ("gather_sublane", [p, i, i, p, i, p]),
            ("dot_chunks", [p, p, i, i, i, i, p]),
            ("onehot_dot", [p, p, i, i, i, i, p]),
            ("gather_timing", [p, i, i, p, i, i, i, p]),
            ("trig", [p, i, p])):
        fn = getattr(lib, name + "_launch")
        fn.argtypes = args + [p]          # ..., stream
        fn.restype = i
    return lib, record


def _launch(name: str, dev, *args) -> None:
    lib, _ = load_kernel()
    call_kernel(getattr(lib, name + "_launch"), name, dev, *args)


# ---- the kernels: plain version and CUDA wrapper ---------------------------

def while_vector_cond_plain(x):
    v, n = x, 0
    while bool((v < 10.0).any()):
        v, n = v + 1.0, n + 1
    return v + float(n)


def while_vector_cond_cuda(x):
    """x [..] f32 (at most 1024 elements): one block adds 1 to every
    element until none is below 10, then adds the count."""
    dev = check_cuda("while_vector_cond", x)
    if x.dtype != torch.float32 or not 0 < x.numel() <= 1024:
        raise ValueError("while_vector_cond takes 1 to 1024 f32 elements")
    out = torch.empty_like(x)
    _launch("while_vector_cond", dev, x.data_ptr(), x.numel(), out.data_ptr())
    while_vector_cond_cuda.launches += 1
    return out


def gather_lane_plain(t, idx):
    head = t[:, :128] * 0.0 + t[:, :128]
    return torch.gather(head, 1, torch.remainder(idx, 128).long())


def gather_lane_cuda(t, idx):
    """t [rows, >= 128] f32, idx [rows, 128] i32: out[r, j] =
    t[r, idx mod 128], from the row's first 128 lanes in shared memory."""
    dev = check_cuda("gather_lane", t, idx)
    rows = t.shape[0]
    if t.dtype != torch.float32 or t.shape[1] < 128 \
            or idx.dtype != torch.int32 or tuple(idx.shape) != (rows, 128):
        raise ValueError("gather_lane takes t [rows, >=128] f32 and idx "
                         "[rows, 128] i32")
    out = torch.empty((rows, 128), dtype=torch.float32, device=dev)
    _launch("gather_lane", dev, t.data_ptr(), rows, t.shape[1],
            idx.data_ptr(), out.data_ptr())
    gather_lane_cuda.launches += 1
    return out


def gather_rows_plain(t, idx):
    return torch.gather(t, 1, idx.long().clamp(0, t.shape[1] - 1))


def gather_rows_cuda(t, idx):
    """take_along_axis on axis 1: t [rows, width] f32 or i32, idx
    [rows, m] i32 -> [rows, m], an index outside the row clamped to its
    edge.  A row of at most 48 KB is read from shared memory, a wider one
    from global memory."""
    dev = check_cuda("gather_rows", t, idx)
    if t.dtype not in (torch.float32, torch.int32) or t.dim() != 2 \
            or idx.dtype != torch.int32 or idx.dim() != 2 \
            or idx.shape[0] != t.shape[0]:
        raise ValueError("gather_rows takes t [rows, width] f32 or i32 and "
                         "idx [rows, m] i32")
    out = torch.empty(idx.shape, dtype=t.dtype, device=dev)
    _launch("gather_rows", dev, t.data_ptr(), t.shape[0], t.shape[1],
            idx.data_ptr(), idx.shape[1], out.data_ptr())
    gather_rows_cuda.launches += 1
    return out


def gather_sublane_plain(t, idx):
    return torch.gather(t, 0, idx.long().clamp(0, t.shape[0] - 1))


def gather_sublane_cuda(t, idx):
    """take_along_axis on axis 0: t [n_rows, cols] f32 (read from global
    memory, a block a row of idx), idx [rows, cols] i32 -> [rows, cols], an
    index outside the table clamped to its edge."""
    dev = check_cuda("gather_sublane", t, idx)
    if t.dtype != torch.float32 or t.dim() != 2 or idx.dtype != torch.int32 \
            or idx.dim() != 2 or idx.shape[1] != t.shape[1]:
        raise ValueError("gather_sublane takes t [n_rows, cols] f32 and idx "
                         "[rows, cols] i32")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _launch("gather_sublane", dev, t.data_ptr(), t.shape[0], t.shape[1],
            idx.data_ptr(), idx.shape[0], out.data_ptr())
    gather_sublane_cuda.launches += 1
    return out


def dot_chunks_plain(a, b, chunks: int):
    m = a.shape[0] // chunks
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for c in range(chunks):
        ac = a[c * m:(c + 1) * m]
        s = ac[:, 0:1] * b[0:1]
        for k in range(1, a.shape[1]):
            s = s + ac[:, k:k + 1] * b[k:k + 1]
        acc = acc + s
    return acc


def dot_chunks_cuda(a, b, chunks: int):
    """a [chunks*M, K], b [K, N] f32 -> [M, N] = 0 + sum over the chunks of
    a_c . b; every sum left to right, one thread an output, b in shared
    memory."""
    dev = check_cuda("dot_chunks", a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32 \
            or a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] \
            or chunks < 1 or a.shape[0] % chunks:
        raise ValueError("dot_chunks takes a [chunks*M, K] and b [K, N] f32")
    m = a.shape[0] // chunks
    out = torch.empty((m, b.shape[1]), dtype=torch.float32, device=dev)
    _launch("dot_chunks", dev, a.data_ptr(), b.data_ptr(), m, a.shape[1],
            b.shape[1], chunks, out.data_ptr())
    dot_chunks_cuda.launches += 1
    return out


def onehot_dot_plain(w, a, hot: int):
    oh = (w == hot).to(torch.float32)
    s = a[0][:, None] * oh[0][None, :]
    for n in range(1, a.shape[0]):
        s = s + a[n][:, None] * oh[n][None, :]
    return s


def onehot_dot_cuda(w, a, hot: int):
    """w [NP, R] i32, a [NP, C] f32 -> [C, R] = a^T . (w == hot), summed
    over NP left to right; a block a row of the output."""
    dev = check_cuda("onehot_dot", w, a)
    if w.dtype != torch.int32 or a.dtype != torch.float32 or w.dim() != 2 \
            or a.dim() != 2 or w.shape[0] != a.shape[0]:
        raise ValueError("onehot_dot takes w [NP, R] i32 and a [NP, C] f32")
    out = torch.empty((a.shape[1], w.shape[1]), dtype=torch.float32,
                      device=dev)
    _launch("onehot_dot", dev, w.data_ptr(), a.data_ptr(), a.shape[0],
            a.shape[1], w.shape[1], hot, out.data_ptr())
    onehot_dot_cuda.launches += 1
    return out


def gather_timing_plain(t, idx, rep: int, mask: int):
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=t.device)
    for k in range(rep):
        acc = acc + torch.gather(t, 1, ((idx + k) & mask).long())
    return acc


def gather_timing_cuda(t, idx, rep: int, mask: int):
    """t [rows, width] f32 (a row in shared memory), idx [rows, m] i32 ->
    [rows, m] = 0 + sum over k < rep of t[r, (idx + k) & mask]."""
    dev = check_cuda("gather_timing", t, idx)
    if t.dtype != torch.float32 or idx.dtype != torch.int32 \
            or t.dim() != 2 or idx.dim() != 2 or idx.shape[0] != t.shape[0] \
            or not 0 <= mask < t.shape[1]:
        raise ValueError("gather_timing takes t [rows, width] f32, idx "
                         "[rows, m] i32 and a mask below width")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _launch("gather_timing", dev, t.data_ptr(), t.shape[0], t.shape[1],
            idx.data_ptr(), idx.shape[1], rep, mask, out.data_ptr())
    gather_timing_cuda.launches += 1
    return out


def trig_plain(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0)) + torch.atan2(x, 1.0 - x)


def trig_cuda(x):
    """acos(clip(x, -1, 1)) + atan2(x, 1 - x), f32, elementwise."""
    dev = check_cuda("trig", x)
    if x.dtype != torch.float32:
        raise ValueError("trig takes f32")
    out = torch.empty_like(x)
    _launch("trig", dev, x.data_ptr(), x.numel(), out.data_ptr())
    trig_cuda.launches += 1
    return out


WRAPPERS = (while_vector_cond_cuda, gather_lane_cuda, gather_rows_cuda,
            gather_sublane_cuda, dot_chunks_cuda, onehot_dot_cuda,
            gather_timing_cuda, trig_cuda)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0


# ---- the probes' inputs ----------------------------------------------------

class Case(NamedTuple):
    """One probe: its inputs on a device (tensors, then the kernel's
    non-tensor arguments) as the JAX tool makes them, seeded random inputs
    of the same shapes, and the kernel it runs, as its plain version and
    its CUDA wrapper."""
    inputs: Callable
    random: Callable
    plain: Callable
    cuda: Callable

    def dispatch(self, *args):
        """The plain version for CPU tensors, the kernel for CUDA tensors;
        no fallback between them."""
        dev = args[0].device
        if dev.type == "cpu":
            return self.plain(*args)
        if dev.type == "cuda":
            return self.cuda(*args)
        raise ValueError(f"no {self.cuda.__name__} for device {dev}")

    def __call__(self, device="cuda"):
        return self.dispatch(*self.inputs(resolve_device(device)))


def _arange(n, dev, dtype=torch.float32):
    return torch.arange(n, dtype=dtype, device=dev)


def _full(shape, value, dev, dtype=torch.int32):
    return torch.full(shape, value, dtype=dtype, device=dev)


def _while_inputs(dev):
    x = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    x[0, 0] = 5.0
    return (x,)


def _wide_inputs(width: int, rows: int = 1, dtype=torch.float32):
    def inputs(dev):
        t = _arange(rows * width, dev, dtype).reshape(rows, width)
        i = (_arange(128, dev, torch.int32) * (width // 128)).reshape(1, 128)
        return t, i.repeat(rows, 1).contiguous()
    return inputs


def _seeded(make):
    """Random inputs from ``make(rng)`` (numpy arrays, then the kernel's
    non-tensor arguments), ``rng`` seeded with RANDOM_SEED."""
    def inputs(dev):
        out = make(np.random.default_rng(RANDOM_SEED))
        return tuple(torch.from_numpy(a).to(dev)
                     if isinstance(a, np.ndarray) else a for a in out)
    return inputs


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _index(rng, high, *shape):
    return rng.integers(0, high, shape).astype(np.int32)


def _random_table(width: int, rows: int = 1, dtype=torch.float32):
    def make(rng):
        if dtype == torch.int32:
            t = rng.integers(-2**31, 2**31, (rows, width)).astype(np.int32)
        else:
            t = _normal(rng, rows, width)
        return t, _index(rng, width, rows, 128)
    return _seeded(make)


def _wide_name(width: int, rows: int = 1) -> str:
    return (f"gather_wide({width})" if rows == 1
            else f"gather_wide({width}, rows={rows})")


def _wide_case(width: int, rows: int = 1, dtype=torch.float32):
    return Case(_wide_inputs(width, rows, dtype),
                _random_table(width, rows, dtype), gather_rows_plain,
                gather_rows_cuda)


# The random inputs are in range where the JAX probe's are (its indices,
# its one-hot ids), and mixed where the tool's are uniform: values below
# and above the loop's 10, indices over the whole table (gather_lane's over
# two of its 128-lane windows), ids 0-5 around HOT, trig's x over [-2, 2]
# (both sides of the clip and of atan2's pole at 1).
CASES = {
    "while_vector_cond": Case(
        _while_inputs,
        _seeded(lambda rng: (rng.uniform(-5.0, 12.0, (8, 128)).astype(
            np.float32),)),
        while_vector_cond_plain, while_vector_cond_cuda),
    "gather_lane": Case(
        lambda dev: (_arange(8 * 256, dev).reshape(8, 256),
                     _full((8, 128), 7, dev)),
        _seeded(lambda rng: (_normal(rng, 8, 256), _index(rng, 256, 8, 128))),
        gather_lane_plain, gather_lane_cuda),
    "gather_lane_full": Case(
        lambda dev: (_arange(256, dev).reshape(1, 256),
                     (_arange(128, dev, torch.int32) * 2).reshape(1, 128)),
        _random_table(256), gather_rows_plain, gather_rows_cuda),
    "gather_sublane": Case(
        lambda dev: (_arange(256 * 128, dev).reshape(256, 128),
                     _full((8, 128), 3, dev)),
        _seeded(lambda rng: (_normal(rng, 256, 128),
                             _index(rng, 256, 8, 128))),
        gather_sublane_plain, gather_sublane_cuda),
    "dynamic_sublane_slice_dot": Case(
        lambda dev: (torch.ones((512, 16), device=dev),
                     torch.ones((16, 128), device=dev), 4),
        _seeded(lambda rng: (_normal(rng, 512, 16), _normal(rng, 16, 128),
                             4)),
        dot_chunks_plain, dot_chunks_cuda),
    "f32_matmul": Case(
        lambda dev: (torch.ones((128, 16), device=dev),
                     torch.ones((16, 256), device=dev), 1),
        _seeded(lambda rng: (_normal(rng, 128, 16), _normal(rng, 16, 256),
                             1)),
        dot_chunks_plain, dot_chunks_cuda),
    "transposed_onehot_dot": Case(
        lambda dev: (_full((256, 128), 3, dev),
                     torch.ones((256, 32), device=dev), HOT),
        _seeded(lambda rng: (_index(rng, 6, 256, 128), _normal(rng, 256, 32),
                             HOT)),
        onehot_dot_plain, onehot_dot_cuda),
    _wide_name(256): _wide_case(256),
    _wide_name(65536): _wide_case(65536),
    _wide_name(256, 24): _wide_case(256, 24),
    "gather_int32_wide(524288)": _wide_case(524288, dtype=torch.int32),
    "gather_timing": Case(
        lambda dev: (torch.ones((24, 256), device=dev),
                     _full((24, 128), 0, dev), GATHER_REP, 255),
        _seeded(lambda rng: (_normal(rng, 24, 256), _index(rng, 256, 24, 128),
                             GATHER_REP, 255)),
        gather_timing_plain, gather_timing_cuda),
    "trig": Case(
        lambda dev: (torch.full((8, 128), 0.5, device=dev),),
        _seeded(lambda rng: (rng.uniform(-2.0, 2.0, (8, 128)).astype(
            np.float32),)),
        trig_plain, trig_cuda),
}


# ---- the probes, under the JAX tool's names ------------------------------

def probe_while_vector_cond(device="cuda"):
    """A loop whose condition is reduced from a vector (the persistent
    loop's exit): [8, 128] zeros with a 5 -> 20 everywhere, 25 there."""
    return CASES["while_vector_cond"](device)


def probe_gather_lane(device="cuda"):
    return CASES["gather_lane"](device)


def probe_gather_lane_full(device="cuda"):
    """Arbitrary lanes of a [1, 256] table with [1, 128] indices."""
    return CASES["gather_lane_full"](device)


def probe_gather_sublane(device="cuda"):
    return CASES["gather_sublane"](device)


def probe_dynamic_sublane_slice_dot(device="cuda"):
    return CASES["dynamic_sublane_slice_dot"](device)


def probe_f32_matmul(device="cuda"):
    return CASES["f32_matmul"](device)


def probe_transposed_onehot_dot(device="cuda"):
    """[NP, R] one-hot contracted on axis 0 against [NP, C] attrs."""
    return CASES["transposed_onehot_dot"](device)


def probe_gather_wide(width: int, rows: int = 1):
    """take_along_axis from a [rows, width] table with [rows, 128]
    indices, for the tool's widths (256, 65536; 24 rows of 256); returns
    the probe (a function of the device)."""
    return CASES[_wide_name(width, rows)]


def probe_gather_int32_wide(width: int):
    """Image-texture shape: int32 packed texels, a [1, width] table
    (the tool's width 524288); returns the probe."""
    return CASES[f"gather_int32_wide({width})"]


def probe_gather_timing(device="cuda"):
    """Cost of repeated [24, 256]-table gathers (the Perlin access shape):
    GATHER_REP gathers a launch, averaged over TIMING_CALLS back-to-back
    launches."""
    dev = resolve_device(device)
    case = CASES["gather_timing"]
    args = case.inputs(dev)
    out = case.dispatch(*args)
    ms = best_ms(lambda: case.dispatch(*args), dev, repeats=1,
                 launches=TIMING_CALLS)
    where = ("CUDA events" if dev.type == "cuda"
             else "plain version, host clock")
    print(f"     gather [24,256]->[24,128] x{GATHER_REP}: "
          f"{ms * 1e3 / GATHER_REP:.4f} us/gather ({where}, "
          f"{TIMING_CALLS} launches)", flush=True)
    return out


def probe_trig(device="cuda"):
    """arccos / arctan2 (sphere UV, Sphere.h:74-81)."""
    return CASES["trig"](device)


MAIN_PROBES = (
    ("while_vector_cond", probe_while_vector_cond),
    ("trig arccos/atan2", probe_trig),
    ("gather_lane (take_along_axis ax1)", probe_gather_lane),
    ("gather_lane_mismatch [1,256]->[1,128]", probe_gather_wide(256)),
    ("gather_sublane (take_along_axis ax0)", probe_gather_sublane),
    ("dyn_sublane_slice + dot", probe_dynamic_sublane_slice_dot),
    ("f32_matmul_16", probe_f32_matmul),
    ("transposed_onehot_dot", probe_transposed_onehot_dot),
    ("gather_wide_64k", probe_gather_wide(65536)),
    ("gather_wide_512k_i32 (image)", probe_gather_int32_wide(524288)),
    ("gather_rows24 [24,256] (perlin)", probe_gather_wide(256, rows=24)),
    ("gather_timing", probe_gather_timing),
)


def main(argv=None) -> dict:
    """Runs the JAX tool's probes in its order; returns {name: output}."""
    p = argparse.ArgumentParser(
        description="P3: loops, gathers, dots and trig as CUDA kernels")
    p.add_argument("-v", action="store_true",
                   help="also print each output's shape and dtype")
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {describe(dev)}", flush=True)
    outs = {}
    for name, probe in MAIN_PROBES:
        out = probe(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        outs[name] = out
        print(f"OK   {name}: {out.flatten()[:4].cpu().numpy()}"
              + (f"  {tuple(out.shape)} {out.dtype}" if args.v else ""),
              flush=True)
    return outs


if __name__ == "__main__":
    main()
