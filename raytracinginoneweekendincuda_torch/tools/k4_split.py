"""K4's time taken apart on one card: variants of the replay backward,
each timed at the train step's shape against the kernel they come from:

    python -m raytracinginoneweekendincuda_torch.tools.k4_split PARENT

PARENT is a checkout (a ``git archive`` of the commit before K4's
redesign, unpacked).  Its ``csrc/replay_bwd.cu`` gives the variants
``parent*``, built against its own headers; this package's gives the
others.  Each variant is the source with one change, made here by text
replacement (each replacement must match) and written, never kept, to
``build/k4_split/``:

- ``parent``: as it is (one thread a lane, a one-shot grid, the bounce
  states in a run-time-indexed local array, d_rep by global atomics with
  a shuffle sum where a warp's hits share one row);
- ``parent, no d_rep atomics``: every atomic add replaced by an add to a
  register that is stored only if it reaches an impossible value;
- ``parent, states in shared memory``: the states moved to dynamic shared
  memory in this package's [K][9][threads] layout, nothing else;
- ``parent, 128 registers``: ``__launch_bounds__(128, 4)``;
- ``change``: this package's K4 (sums d_rep in shared memory; also timed
  with d_rep in global memory, its other instantiation);
- ``change, no d_rep atomics``, as for the parent;
- ``change, no flush atomics``: the block's final adds of its shared
  d_rep into the global one replaced by a store made only for an
  impossible value, so that the flush's cost shows apart;
- ``change, warp-uniform shuffle sums``: add_row's shared-memory path with
  the parent's shuffle sum where a warp's hits share one row;
- ``change, 320 threads`` / ``448 threads``: other blocks (448 caps the
  registers at 146);
- ``change, texture columns by index``: built against the parent's
  ``replay_bounce.cuh``, whose texture adjoint indexes the table row at
  run time;
- ``change, groups of 4``: the global instantiation's shuffle sum for
  groups of 4 lanes that share a row, not 8.

Inputs: sample 0 of scene 0 at 640x360, K 8, the tape traced by K2
(``kernel_times.replay_times``'s).  Each variant is timed by
``tools/common.best_ms`` (5 batches of 10 launches, best), in two rounds,
the second in the reverse order; it prints each variant's ptxas report
(registers, stack, spills), whether its d_rays and d_bg equal this
package's K4's bit for bit, its d_rep's rel-L2 difference, and one JSON
line.  Needs nvcc and a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import mega2
from ..ops import replay_cuda as rc
from ..ops.render import resolve_device
from ..utils import cuda_build
from ..utils.benchmark import card_line
from . import kernel_times as kt
from .common import best_ms

PKG = "raytracinginoneweekendincuda_torch"
OUT_DIR = os.path.join(os.path.dirname(cuda_build.PKG_DIR), "build",
                       "k4_split")
SINK_END = "  if (sink == 1.2345e30f) d_rep[0] = sink;\n"


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant text not found: {old[:60]!r}")
    return src.replace(old, new)


def _parent_sink(src: str) -> str:
    src = _sub(src, "const float v[replay::REP_COLS]) {",
               "const float v[replay::REP_COLS], float& sink) {")
    src = _sub(src, "if (lead) atomicAdd(d_rep + (size_t)kmax * "
               "replay::REP_COLS + c, x);", "if (lead) sink = sink + x;")
    src = _sub(src, "atomicAdd(d_rep + (size_t)key * replay::REP_COLS + c, "
               "v[c]);", "sink = sink + v[c];")
    src = _sub(src, "add_row(d_rep, key, g.row);",
               "add_row(d_rep, key, g.row, sink);")
    src = _sub(src, "  // reverse sweep\n", "  float sink = 0.0f;\n")
    return _sub(src, "  if (valid) {\n    float* o = d_rays",
                SINK_END + "  if (valid) {\n    float* o = d_rays")


def _parent_smem(src: str, change: str) -> str:
    a = change.index("// Bounce k's start state")
    helpers = change[a:change.index("\n}\n", change.index("get_state")) + 3]
    src = _sub(src, "__device__ __forceinline__ void add_row",
               "constexpr int kStateWords = 9;\n" + helpers
               + "\n__device__ __forceinline__ void add_row")
    src = _sub(src, "  replay::State st[replay::KMAX];",
               "  extern __shared__ float smem_st[];")
    src = _sub(src, "      st[k] = s;",
               "      put_state(smem_st, k, blockDim.x, threadIdx.x, s);")
    src = _sub(src, "      const replay::State s = st[k];",
               "      const replay::State s = get_state(smem_st, k, "
               "blockDim.x, threadIdx.x);")
    return _sub(src, "<<<grid, kBlock, 0,",
                "<<<grid, kBlock, (size_t)params->K * 9 * kBlock * 4,")


def _change_sink(src: str) -> str:
    src = _sub(src, "const float v[replay::REP_COLS]) {",
               "const float v[replay::REP_COLS], float& sink) {")
    src = _sub(src, "          atomicAdd(acc + (size_t)row * replay::REP_COLS"
               " + c, x);", "          sink = sink + x;")
    src = _sub(src, "        atomicAdd(acc + (size_t)key * replay::REP_COLS "
               "+ c, v[c]);", "        sink = sink + v[c];")
    src = _sub(src, "add_row<kSmemRep>(acc, key, g.row);",
               "add_row<kSmemRep>(acc, key, g.row, sink);")
    src = _sub(src, "  extern __shared__ float smem[];\n",
               "  extern __shared__ float smem[];\n  float sink = 0.0f;\n")
    return _sub(src, "  if (kSmemRep) {\n    __syncthreads();\n",
                SINK_END + "  if (kSmemRep) {\n    __syncthreads();\n")


UNIFORM = """template <bool kSmemRep>
__device__ __forceinline__ void add_row(float* acc, int key,
                                        const float v[replay::REP_COLS]) {
  const int kmax = __reduce_max_sync(kFull, key);
  if (kmax < 0) return;
  if (__all_sync(kFull, key < 0 || key == kmax)) {
#pragma unroll
    for (int c = 0; c < replay::REP_COLS; ++c) {
      float x = key >= 0 ? v[c] : 0.0f;
      if (!__any_sync(kFull, x != 0.0f)) continue;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = x + __shfl_xor_sync(kFull, x, off);
      if ((threadIdx.x & 31) == 0)
        atomicAdd(acc + (size_t)kmax * replay::REP_COLS + c, x);
    }
  } else if (key >= 0) {
#pragma unroll
    for (int c = 0; c < replay::REP_COLS; ++c)
      if (v[c] != 0.0f)
        atomicAdd(acc + (size_t)key * replay::REP_COLS + c, v[c]);
  }
}

"""


def _change_uniform(src: str) -> str:
    a = src.index("template <bool kSmemRep>\n__device__ __forceinline__ "
                  "void add_row")
    b = src.index("template <bool kSmemRep>\n__global__")
    return src[:a] + UNIFORM + src[b:]


def parent_variants(parent_src: str, change_src: str) -> dict:
    """{name: (source, whose headers it builds against, its launch's
    signature)} of the parent's kernel."""
    return {
        "parent": (parent_src, "parent", "parent"),
        "parent, no d_rep atomics": (_parent_sink(parent_src), "parent",
                                     "parent"),
        "parent, states in shared memory": (
            _parent_smem(parent_src, change_src), "parent", "parent"),
        "parent, 128 registers": (_sub(
            parent_src, "__launch_bounds__(kBlock)",
            "__launch_bounds__(kBlock, 4)"), "parent", "parent"),
    }


def change_variants(src: str) -> dict:
    """The same for this package's kernel, ``src``."""
    blk = "constexpr int kBlock = 384;"
    return {
        "change": (src, "change", "change"),
        "change, no d_rep atomics": (_change_sink(src), "change", "change"),
        "change, no flush atomics": (_sub(
            src, "if (v != 0.0f) atomicAdd(d_rep + i, v);",
            "if (v == 1.2345e30f) d_rep[i] = v;"), "change", "change"),
        "change, warp-uniform shuffle sums": (_change_uniform(src), "change",
                                              "change"),
        "change, 320 threads": (_sub(src, blk, "constexpr int kBlock = 320;"),
                                "change", "change"),
        "change, 448 threads": (_sub(src, blk, "constexpr int kBlock = 448;"),
                                "change", "change"),
        "change, texture columns by index": (src, "parent", "change"),
        "change, groups of 4": (_sub(src, "constexpr int kGroup = 8;",
                                     "constexpr int kGroup = 4;"),
                                "change", "change"),
    }


def _ptxas(report: str) -> list:
    """(shared | global | -, registers, stack, spill-store bytes) of each
    kernel of a ptxas -v report."""
    return [("shared" if "ILb1E" in m.group(1) else "global"
             if "ILb0E" in m.group(1) else "-", int(m.group(4)),
             int(m.group(2)), int(m.group(3)))
            for m in re.finditer(
                r"Compiling entry function '(\S+)'.*?(\d+) bytes stack "
                r"frame, (\d+) bytes spill stores.*?Used (\d+) registers",
                report, re.S)]


def build(vs: dict, parent_csrc: str) -> dict:
    """Compiles every variant, all at once; {name: (CDLL, ptxas)}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = cuda_build.find_nvcc()

    def one(item):
        i, (name, (src, headers, _)) = item
        path = os.path.join(OUT_DIR, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        inc = parent_csrc if headers == "parent" else cuda_build.CSRC_DIR
        lib = os.path.join(OUT_DIR, f"v{i}.so")
        res = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-I", inc, "-o",
                              lib, path], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{res.stderr[-3000:]}")
        return name, (ctypes.CDLL(lib), res.stdout + res.stderr)

    with ThreadPoolExecutor(len(vs)) as ex:
        return dict(ex.map(one, enumerate(vs.items())))


def main(argv=None) -> dict:
    dev = resolve_device("cuda")
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        raise SystemExit("usage: k4_split PARENT_CHECKOUT")
    parent_csrc = os.path.join(os.path.abspath(args[0]), PKG, "csrc")
    with open(os.path.join(parent_csrc, "replay_bwd.cu")) as f:
        parent_src = f.read()
    with open(os.path.join(cuda_build.CSRC_DIR, "replay_bwd.cu")) as f:
        change_src = f.read()
    vs = {**parent_variants(parent_src, change_src),
          **change_variants(change_src)}
    libs = build(vs, parent_csrc)
    card = card_line()
    print(f"card: {card}", flush=True)
    for name, (_, report) in libs.items():
        print(f"  {name}: " + "; ".join(
            f"{kind} {regs} registers, {stack}-byte stack, {spill} bytes "
            f"spilled" for kind, regs, stack, spill in _ptxas(report)),
            flush=True)

    _, w, h, _, K = kt.K2_SHAPE
    _, start, meta, cfg = kt.train_start(kt.K2_SHAPE)
    tab = mega2.pack_mega2_tables(start, meta, dev)
    fp = mega2.frame_params(start, cfg)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    tape = mega2.trace_tapes_cuda(tab, pix, torch.zeros_like(pix), fp)
    tt, rays, tape, pc, bg, g = kt.replay_inputs(start, meta, tab, fp, pix,
                                                 0, tape, dev)
    rep = tt.rep.detach()
    n = rays.shape[0]
    ref = rc.replay_bwd_cuda(tt, rep, rays, tape, pc, 0, bg, g,
                             t_min=fp.t_min)
    prm = rc._params(tt, rep, bg, n, K, 0, fp.t_min)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P = ctypes.c_void_p
    runs = []
    for name, (lib, _) in libs.items():
        sig = vs[name][2]
        lib.replay_bwd_launch.restype = ctypes.c_int
        lib.replay_bwd_launch.argtypes = [ctypes.POINTER(rc._Params)] + [
            P] * 7 + ([] if sig == "parent" else
                      [P, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]) + [P]
        if sig == "parent":
            runs.append((name, None))
        else:
            threads = int(re.search(r"constexpr int kBlock = (\d+);",
                                    vs[name][0]).group(1))
            runs += [(name, flag) for flag in (1, 0)
                     if not flag or rc.bwd_rep_in_shared(
                         tt.NP, K, rc.bwd_smem_optin(), threads)]

    def call(name, flag):
        lib = libs[name][0]
        d_rep = torch.zeros_like(rep)
        d_rays = torch.empty((n, 7), device=dev)
        d_bg = torch.empty((n, 3), device=dev)
        args = [ctypes.byref(prm), rays.data_ptr(), tape.data_ptr(),
                pc.data_ptr(), g.data_ptr(), d_rays.data_ptr(),
                d_rep.data_ptr(), d_bg.data_ptr()]
        if flag is not None:
            queue = torch.empty(1, dtype=torch.int32, device=dev)
            args += [queue.data_ptr(), flag, (ctypes.c_int * 3)()]
        err = lib.replay_bwd_launch(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return d_rep, d_rays, d_bg

    times, checks = {}, {}
    for order in (runs, runs[::-1]):
        for name, flag in order:
            key = name if flag is None else \
                f"{name} ({'shared' if flag else 'global'} d_rep)"
            d_rep, d_rays, d_bg = call(name, flag)
            checks[key] = {
                "d_rays_d_bg_equal": bool(torch.equal(d_rays, ref[1])
                                          and torch.equal(d_bg, ref[2])),
                "d_rep_rel": float((d_rep - ref[0]).norm()
                                   / ref[0].norm())}
            times.setdefault(key, []).append(
                best_ms(lambda: call(name, flag), dev, 5, 10))
    print(f"  {n} lanes, K {K}, ms (two rounds):", flush=True)
    for key, ms in times.items():
        print(f"  {key}: {statistics.median(ms):.4f} ms {ms}; d_rays / d_bg "
              f"equal {checks[key]['d_rays_d_bg_equal']}, d_rep rel "
              f"{checks[key]['d_rep_rel']:.2e}", flush=True)
    out = {"card": card, "lanes": n, "K": K, "ms": times, "checks": checks,
           "ptxas": {k: _ptxas(r) for k, (_, r) in libs.items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
