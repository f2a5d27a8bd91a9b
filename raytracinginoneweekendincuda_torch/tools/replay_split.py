"""K3's or K4's time taken apart on one card: variants of the replay
forward or backward, each timed at the train step's shape against the
kernel they come from:

    python -m raytracinginoneweekendincuda_torch.tools.replay_split k3 PARENT
    python -m raytracinginoneweekendincuda_torch.tools.replay_split k4 PARENT

PARENT is a checkout (a ``git archive`` of the commit before that
kernel's redesign, unpacked).  Its ``csrc/replay_fwd.cu`` or
``replay_bwd.cu`` gives the variants ``parent*``, built against its own
headers; this package's gives the others.  Each variant is the source
with one change, made here by text replacement (each replacement must
match) and written, never kept, to ``build/replay_split/``.

K3 (``csrc/replay_fwd.cu``):

- ``parent``: as it is (one thread a lane, 128-thread blocks on a
  one-shot grid);
- ``change``: this package's K3 (a persistent grid of 384-thread blocks
  whose threads take lanes one by one from a queue, one flat bounce loop
  each; a warp stops asking once a claim reached the end of the lanes);
- ``change, queue asked after it is empty``: K1's refill, a claim in
  every round that has a thread in need, to the end;
- ``change, warp rounds of 32``: K4's loop shape, each warp taking 32
  lanes a round and running them to their warp's longest path;
- ``change, refill rounds of 32``: the flat loop, but a thread whose
  path ends waits until every thread of its warp needs a lane;
- ``change, 128 threads`` / ``256 threads``: other blocks;
- ``change, 3 blocks a SM``: ``__launch_bounds__(kBlock, 3)`` (56
  registers);
- ``change, rows in shared memory``: each block stages the replay
  table's rows in dynamic shared memory once (float4 copies) and reads
  them there;
- ``change, rays through shared memory``: each refill round's rays read
  by the warp together, coalesced, into a shared buffer.

And the time of zeroing the queue alone (a 4-byte fill), which every K3
launch of ``change`` pays before the kernel.

K4 (``csrc/replay_bwd.cu``):

- ``parent``: as it is (one thread a lane, a one-shot grid, the bounce
  states in a run-time-indexed local array, d_rep by global atomics with
  a shuffle sum where a warp's hits share one row);
- ``parent, no d_rep atomics``: every atomic add replaced by an add to a
  register that is stored only if it reaches an impossible value;
- ``parent, states in shared memory``: the states moved to dynamic shared
  memory in this package's [K][9][threads] layout, nothing else;
- ``parent, 128 registers``: ``__launch_bounds__(128, 4)``;
- ``change``: this package's K4 (each lane-bounce's row cotangent
  written to its own slot, then summed in a fixed order by
  ``ops/replay_cuda.rep_sum``; every K4 variant of this package is timed
  with that sum);
- ``change, no row stores``: the slots' row stores made only for an
  impossible value, so that their cost shows apart;
- ``change, 320 threads`` / ``448 threads``: other blocks (448 caps the
  registers at 146);
- ``change, texture columns by index``: built against the parent's
  ``replay_bounce.cuh``, whose texture adjoint indexes the table row at
  run time.

Inputs: sample 0 of scene 0 at 640x360, K 8, the tape traced by K2
(``kernel_times.replay_times``'s).  Each variant is timed by
``tools/common.best_ms`` (5 batches of 10 launches, best), in two rounds,
the second in the reverse order; it prints each variant's ptxas report
(registers, stack, spills) and one JSON line, and for K3 whether each
variant's radiance equals the parent's bit for bit and its launch shape,
for K4 whether its d_rays and d_bg equal this package's K4's bit for bit
and its d_rep's rel-L2 difference.  Needs nvcc and a CUDA device.
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
                       "replay_split")
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


ROW_STORE = "        if (key >= 0) {\n          float* o = rows"


def k4_parent_variants(parent_src: str, change_src: str) -> dict:
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


def k4_change_variants(src: str) -> dict:
    """The same for this package's kernel, ``src``."""
    blk = "constexpr int kBlock = 384;"
    return {
        "change": (src, "change", "change"),
        "change, no row stores": (_sub(
            src, ROW_STORE, "        if (key >= 0 && g.row[0] == 1.2345e30f)"
            " {\n          float* o = rows"), "change", "change"),
        "change, 320 threads": (_sub(src, blk, "constexpr int kBlock = 320;"),
                                "change", "change"),
        "change, 448 threads": (_sub(src, blk, "constexpr int kBlock = 448;"),
                                "change", "change"),
        "change, texture columns by index": (src, "parent", "change"),
    }


# ---- K3 ----------------------------------------------------------------

K3_KERNEL_HEAD = """__global__ void __launch_bounds__(kBlock)
replay_fwd_kernel(const replay::Params p, const float* __restrict__ rays,
                  const int* __restrict__ tape,
                  const int* __restrict__ pix_ctr,
                  float* __restrict__ out, unsigned* __restrict__ queue) {
"""

K3_WARP_ROUNDS = K3_KERNEL_HEAD + """  while (true) {
    unsigned base = 0u;
    if ((threadIdx.x & 31) == 0) base = atomicAdd(queue, 32u);
    base = __shfl_sync(kFull, base, 0);
    if (base >= (unsigned)p.n) break;
    const unsigned lane = base + (threadIdx.x & 31);
    if (lane < (unsigned)p.n) {
      const float* q = rays + 7 * (size_t)lane;
      replay::State s;
      s.o = replay::V3{q[0], q[1], q[2]};
      s.d = replay::V3{q[3], q[4], q[5]};
      const float tm = q[6];
      s.thr[0] = s.thr[1] = s.thr[2] = 1.0f;
      const uint32_t pc = (uint32_t)pix_ctr[lane];
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < p.K; ++k) {
        replay::Rec r;
        float dacc[3];
        const bool alive = replay::bounce_fwd(
            p, tape[(size_t)k * p.n + lane], tm, pc, k, s, r, dacc);
        acc[0] = acc[0] + dacc[0];
        acc[1] = acc[1] + dacc[1];
        acc[2] = acc[2] + dacc[2];
        if (!alive) break;
      }
      out[3 * (size_t)lane + 0] = acc[0];
      out[3 * (size_t)lane + 1] = acc[1];
      out[3 * (size_t)lane + 2] = acc[2];
    }
  }
}

}  // namespace
"""


def _k3_warp_rounds(src: str) -> str:
    a = src.index(K3_KERNEL_HEAD)
    b = src.index("}  // namespace\n")
    return src[:a] + K3_WARP_ROUNDS + src[b + len("}  // namespace\n"):]


def _k3_smem_rows(src: str) -> str:
    src = _sub(src, K3_KERNEL_HEAD, K3_KERNEL_HEAD + """\
  extern __shared__ float4 rep_rows4[];
  {
    const int words = p.np_rows * replay::REP_COLS;
    const float4* g4 = reinterpret_cast<const float4*>(p.rep);
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x)
      rep_rows4[i] = __ldg(g4 + i);
    float* rows = reinterpret_cast<float*>(rep_rows4);
    for (int i = (words / 4) * 4 + threadIdx.x; i < words; i += blockDim.x)
      rows[i] = p.rep[i];
  }
  __syncthreads();
  replay::Params ps = p;
  ps.rep = reinterpret_cast<const float*>(rep_rows4);
""")
    src = _sub(src, "replay::bounce_fwd(p, tape", "replay::bounce_fwd(ps, tape")
    src = _sub(src, "persistent::queue_threads(p.n, kBlock), 0,",
               "persistent::queue_threads(p.n, kBlock),\n"
               "                                 4 * replay::REP_COLS * "
               "p.np_rows,")
    return _sub(src, "<<<shape[0], shape[1], 0, st>>>",
                "<<<shape[0], shape[1], shape[2], st>>>")


def _k3_smem_rays(src: str) -> str:
    src = _sub(src, "  const int wl = threadIdx.x & 31;\n",
               "  const int wl = threadIdx.x & 31;\n"
               "  __shared__ float ray_buf[kBlock / 32][7 * 32];\n"
               "  float* wray = ray_buf[threadIdx.x >> 5];\n")
    src = _sub(src, "      if (need) {\n        lane = base +", """\
      {
        const unsigned end = min(base + (unsigned)__popc(want),
                                 (unsigned)p.n);
        const int words = base < end ? 7 * (int)(end - base) : 0;
        for (int i = wl; i < words; i += 32)
          wray[i] = rays[7 * (size_t)base + i];
        __syncwarp();
      }
      if (need) {
        lane = base +""")
    src = _sub(src, "const float* q = rays + 7 * (size_t)lane;",
               "const float* q = wray + 7 * (lane - base);")
    return _sub(src, "    if (!__any_sync(kFull, !done)) break;\n",
                "    __syncwarp();\n"
                "    if (!__any_sync(kFull, !done)) break;\n")


def _k3_rounds_of_32(src: str) -> str:
    src = _sub(src, "    const bool need = !done && k >= p.K;\n",
               "    const bool need = !done && __all_sync(kFull, done || "
               "k >= p.K);\n")
    return _sub(src, "    if (done) continue;\n",
                "    if (done || k >= p.K) continue;\n")


def _k3_ask_when_empty(src: str) -> str:
    return _sub(src, """\
      unsigned base = (unsigned)p.n;
      if (!drained) {
        const int leader = __ffs(want) - 1;
        if (wl == leader) base = atomicAdd(queue, (unsigned)__popc(want));
        base = __shfl_sync(kFull, base, leader);
        drained = base + (unsigned)__popc(want) >= (unsigned)p.n;
      }
""", """\
      const int leader = __ffs(want) - 1;
      unsigned base = 0u;
      if (wl == leader) base = atomicAdd(queue, (unsigned)__popc(want));
      base = __shfl_sync(kFull, base, leader);
""")


def k3_parent_variants(parent_src: str) -> dict:
    """{name: (source, whose headers it builds against, its launch's
    signature)} of the parent's K3."""
    return {"parent": (parent_src, "parent", "parent")}


def k3_change_variants(src: str) -> dict:
    """The same for this package's K3, ``src``."""
    blk = "constexpr int kBlock = 384;"
    return {
        "change": (src, "change", "change"),
        "change, queue asked after it is empty": (_k3_ask_when_empty(src),
                                                  "change", "change"),
        "change, warp rounds of 32": (_k3_warp_rounds(src), "change",
                                      "change"),
        "change, refill rounds of 32": (_k3_rounds_of_32(src), "change",
                                        "change"),
        "change, 128 threads": (_sub(src, blk, "constexpr int kBlock = 128;"),
                                "change", "change"),
        "change, 256 threads": (_sub(src, blk, "constexpr int kBlock = 256;"),
                                "change", "change"),
        "change, 3 blocks a SM": (_sub(src, "__launch_bounds__(kBlock)",
                                       "__launch_bounds__(kBlock, 3)"),
                                  "change", "change"),
        "change, rows in shared memory": (_k3_smem_rows(src), "change",
                                          "change"),
        "change, rays through shared memory": (_k3_smem_rays(src), "change",
                                               "change"),
    }


# ---- both -----------------------------------------------------------------

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


def _inputs(dev):
    """K3 / K4's inputs at the step's shape: (tt, rep, rays, tape, pc, bg,
    g, t_min)."""
    _, w, h, _, _ = kt.K2_SHAPE
    _, start, meta, cfg = kt.train_start(kt.K2_SHAPE)
    tab = mega2.pack_mega2_tables(start, meta, dev)
    fp = mega2.frame_params(start, cfg)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    tape = mega2.trace_tapes_cuda(tab, pix, torch.zeros_like(pix), fp)
    tt, rays, tape, pc, bg, g = kt.replay_inputs(start, meta, tab, fp, pix,
                                                 0, tape, dev)
    return tt, tt.rep.detach(), rays, tape, pc, bg, g, fp.t_min


def _k3_runs(libs: dict, vs: dict, dev):
    """(runs [(name, None)], call(name, flag) -> (radiance, shape),
    reference radiance: the parent's), and prints the queue's zeroing."""
    tt, rep, rays, tape, pc, bg, _, t_min = _inputs(dev)
    n, K = rays.shape[0], tape.shape[0]
    prm = rc._params(tt, rep, bg, n, K, 0, t_min)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P = ctypes.c_void_p
    for name, (lib, _) in libs.items():
        lib.replay_fwd_launch.restype = ctypes.c_int
        lib.replay_fwd_launch.argtypes = [ctypes.POINTER(rc._Params)] + [
            P] * 4 + ([] if vs[name][2] == "parent" else
                      [P, ctypes.POINTER(ctypes.c_int)]) + [P]

    def call(name, flag):
        out = torch.empty((n, 3), device=dev)
        args = [ctypes.byref(prm), rays.data_ptr(), tape.data_ptr(),
                pc.data_ptr(), out.data_ptr()]
        shape = (ctypes.c_int * 3)()
        if vs[name][2] != "parent":
            queue = torch.empty(1, dtype=torch.int32, device=dev)
            args += [queue.data_ptr(), shape]
        err = libs[name][0].replay_fwd_launch(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out, tuple(shape)

    queue = torch.empty(1, dtype=torch.int32, device=dev)
    print(f"  zeroing the queue alone: "
          f"{best_ms(queue.zero_, dev, 5, 10):.5f} ms", flush=True)
    return [(name, None) for name in libs], call, call("parent", None)[0]


def _k4_runs(libs: dict, vs: dict, dev):
    """The same for K4; the reference is this package's K4's output.  A
    variant of this package returns the slots' sum (`rc.rep_sum`)."""
    tt, rep, rays, tape, pc, bg, g, t_min = _inputs(dev)
    n, K = rays.shape[0], tape.shape[0]
    ref = rc.replay_bwd_cuda(tt, rep, rays, tape, pc, 0, bg, g, t_min=t_min)
    prm = rc._params(tt, rep, bg, n, K, 0, t_min)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P = ctypes.c_void_p
    for name, (lib, _) in libs.items():
        lib.replay_bwd_launch.restype = ctypes.c_int
        lib.replay_bwd_launch.argtypes = [ctypes.POINTER(rc._Params)] + (
            [P] * 7 if vs[name][2] == "parent" else
            [P] * 9 + [ctypes.POINTER(ctypes.c_int)]) + [P]

    def call(name, _flag):
        lib = libs[name][0]
        d_rays = torch.empty((n, 7), device=dev)
        d_bg = torch.empty((n, 3), device=dev)
        args = [ctypes.byref(prm), rays.data_ptr(), tape.data_ptr(),
                pc.data_ptr(), g.data_ptr(), d_rays.data_ptr()]
        if vs[name][2] == "parent":
            d_rep = torch.zeros_like(rep)
            args += [d_rep.data_ptr(), d_bg.data_ptr()]
        else:
            keys = torch.empty((K, n), dtype=torch.int32, device=dev)
            rows = torch.empty((K, n, rc.REP_COLS), device=dev)
            queue = torch.empty(1, dtype=torch.int32, device=dev)
            args += [d_bg.data_ptr(), rows.data_ptr(), keys.data_ptr(),
                     queue.data_ptr(), (ctypes.c_int * 3)()]
        err = lib.replay_bwd_launch(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        if vs[name][2] != "parent":
            d_rep = rc.rep_sum(keys, rows, tt.NP)
        return d_rep, d_rays, d_bg

    return [(name, None) for name in libs], call, ref


def _k3_check(got, ref) -> dict:
    out, shape = got
    return {"radiance_equal": bool(torch.equal(out, ref)),
            "shape": list(shape)}


def _k4_check(got, ref) -> dict:
    d_rep, d_rays, d_bg = got
    return {"d_rays_d_bg_equal": bool(torch.equal(d_rays, ref[1])
                                      and torch.equal(d_bg, ref[2])),
            "d_rep_rel": float((d_rep - ref[0]).norm() / ref[0].norm())}


KERNELS = {
    "k3": ("replay_fwd.cu", k3_parent_variants, k3_change_variants,
           _k3_runs, _k3_check),
    "k4": ("replay_bwd.cu", k4_parent_variants, k4_change_variants,
           _k4_runs, _k4_check),
}


def main(argv=None) -> dict:
    dev = resolve_device("cuda")
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2 or args[0] not in KERNELS:
        raise SystemExit("usage: replay_split k3|k4 PARENT_CHECKOUT")
    fname, parent_vs, change_vs, make_runs, check = KERNELS[args[0]]
    parent_csrc = os.path.join(os.path.abspath(args[1]), PKG, "csrc")
    with open(os.path.join(parent_csrc, fname)) as f:
        parent_src = f.read()
    with open(os.path.join(cuda_build.CSRC_DIR, fname)) as f:
        change_src = f.read()
    vs = {**(parent_vs(parent_src, change_src) if args[0] == "k4"
             else parent_vs(parent_src)), **change_vs(change_src)}
    libs = build(vs, parent_csrc)
    card = card_line()
    print(f"card: {card}", flush=True)
    for name, (_, report) in libs.items():
        print(f"  {name}: " + "; ".join(
            f"{kind} {regs} registers, {stack}-byte stack, {spill} bytes "
            f"spilled" for kind, regs, stack, spill in _ptxas(report)),
            flush=True)

    runs, call, ref = make_runs(libs, vs, dev)
    times, checks = {}, {}
    for order in (runs, runs[::-1]):
        for name, flag in order:
            checks[name] = check(call(name, flag), ref)
            times.setdefault(name, []).append(
                best_ms(lambda: call(name, flag), dev, 5, 10))
    print(f"  {args[0].upper()} at the step's shape, ms (two rounds):",
          flush=True)
    for key, ms in times.items():
        print(f"  {key}: {statistics.median(ms):.5f} ms {ms}; "
              f"{json.dumps(checks[key])}", flush=True)
    out = {"card": card, "kernel": args[0], "ms": times, "checks": checks,
           "ptxas": {k: _ptxas(r) for k, (_, r) in libs.items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
