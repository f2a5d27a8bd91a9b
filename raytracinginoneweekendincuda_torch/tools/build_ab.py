"""K1-K6 and P3 of several checkouts of the package, built alike, compared
as code and by their outputs, and timed in one call:

    python -m raytracinginoneweekendincuda_torch.tools.build_ab \
        CHECKOUT [CHECKOUT ...] [--order 0,1,1,0]

Each CHECKOUT is a directory that holds the package (a ``git archive`` of
a commit, unpacked).  For each entry of ``--order`` (default: the first
checkout, the others forward, the others back, the first again -- P C C P
for two), the checkout's package is copied into ``build/ab/work/``, the
same directory for every run; its ``csrc/mega2_render.cu``,
``mega2_trace.cu``, ``replay_fwd.cu``, ``replay_bwd.cu``,
``mega_bounces.cu``, ``closest_geo.cu`` and ``probe_mosaic.cu`` are
compiled by the checkout's own nvcc command (``utils/cuda_build``), once
more to PTX, all at once, and put where that package loads its cached
builds; then ``tools/kernel_times.py`` of this package runs on it.

Then each kernel of the checkout run first is matched with the kernel of
each other checkout run that has the same template arguments followed
only by ``false`` (the instantiation without an option added later, such
as the chunk cull), and the stretches in which their PTX (names, the hash
that names an anonymous namespace, which follows the build's directory,
virtual registers and labels normalised away) and SASS (register numbers
normalised away) differ are counted; a checkout built twice is also
compared with itself.  And for each output hash of kernel_times (a
kernel's output on one frame or pool), whether every run gave the hash of
the checkout run first.  Prints one JSON line: the runs in order, each
with kernel_times' result, the code comparisons and the output check.
Needs nvcc, cuobjdump and a CUDA device.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from ..ops.render import resolve_device
from ..utils import cuda_build

PKG = "raytracinginoneweekendincuda_torch"
KERNELS = ("mega2_render", "mega2_trace", "replay_fwd", "replay_bwd",
           "mega_bounces", "closest_geo", "probe_mosaic")
# the kernel functions of a source whose names are not <source>_kernel
FUNCTIONS = {"probe_mosaic": ("while_vector_cond", "gather_lane",
                              "gather_rows", "gather_sublane", "dot_chunks",
                              "onehot_dot", "gather_timing", "trig")}
WORK = os.path.join(os.path.dirname(cuda_build.PKG_DIR), "build", "ab",
                    "work")
KERNEL_TIMES = os.path.join(cuda_build.PKG_DIR, "tools", "kernel_times.py")


def _run(cmd: list, **kw) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed:\n{res.stderr[-4000:]}")
    return res.stdout


def build(checkout: str) -> dict:
    """Copies ``checkout``'s package into WORK (emptied first), compiles
    KERNELS as that package's ``cuda_build`` would, to its cache, and to
    PTX.  Returns {name: {"ptx": text, "sass": text}}."""
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, PKG), os.path.join(WORK, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=WORK)
    query = ("import json; from raytracinginoneweekendincuda_torch.utils "
             "import cuda_build as c; print(json.dumps([c.BUILD_DIR, "
             "c._source_hash(), c.NVCC_FLAGS]))")
    build_dir, digest, flags = json.loads(
        _run([sys.executable, "-c", query], env=env, cwd=WORK))
    os.makedirs(build_dir, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")

    def one(name: str) -> dict:
        src = os.path.join(WORK, PKG, "csrc", name + ".cu")
        lib = os.path.join(build_dir, f"{name}_{digest}.so")
        ptx = os.path.join(build_dir, name + ".ptx")
        _run([nvcc, *flags, "-o", lib, src], cwd=WORK)
        _run([nvcc, *flags[:flags.index("-shared")], "-ptx", "-o", ptx, src],
             cwd=WORK)
        with open(ptx) as f:
            return {"ptx": f.read(), "sass": _run([cuobjdump, "-sass", lib])}

    with ThreadPoolExecutor(len(KERNELS)) as ex:
        return dict(zip(KERNELS, ex.map(one, KERNELS)))


def _key(mangled: str):
    """(kernel name, template arguments as '0' / '1') of a mangled name."""
    names = [f for k in KERNELS for f in FUNCTIONS.get(k, (k,))]
    m = re.search(r"((?:%s)_kernel)(I((?:Lb[01]E)+)E)?" % "|".join(names),
                  mangled)
    return m.group(1), tuple(re.findall(r"Lb([01])E", m.group(3) or ""))


def ptx_kernels(text: str) -> dict:
    out = {}
    for m in re.finditer(r"\.entry (\S+)\((.*?)\n\}\n", text, re.S):
        body = m.group(2).replace(m.group(1), "KERNEL")
        body = re.sub(r"%[a-zA-Z]+\d+", "%v", body)
        body = re.sub(r"\$L__BB\d+_\d+", "$L", body)
        body = re.sub(r"__local_depot\d+", "__local_depot", body)
        body = re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__", body)
        out[_key(m.group(1))] = [ln.strip() for ln in body.splitlines()
                                 if ln.strip()]
    return out


def sass_kernels(text: str) -> dict:
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(_key(m.group(1)), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if m and cur is not None:
            cur.append(re.sub(r"\bU?R\d+\b|\bU?P\d\b", "R", m.group(1)))
    return out


def stretches(a: list, b: list) -> int:
    """Stretches of lines in which ``a`` and ``b`` differ."""
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    return sum(op[0] != "equal" for op in sm.get_opcodes())


def compare(base: dict, other: dict) -> dict:
    """For each kernel of ``base``, its match in ``other`` and the
    differing stretches of their PTX and SASS."""
    out = {}
    for name in KERNELS:
        kinds = {k: (f(base[name][k]), f(other[name][k]))
                 for k, f in (("ptx", ptx_kernels), ("sass", sass_kernels))}
        for key in kinds["sass"][0]:
            match = [k for k in kinds["sass"][1]
                     if k[0] == key[0] and k[1][:len(key[1])] == key[1]
                     and set(k[1][len(key[1]):]) <= {"0"}]
            if not match:
                continue
            label = f"{key[0]}<{','.join(key[1])}>"
            rec = {"matched": f"{key[0]}<{','.join(match[0][1])}>"}
            for kind, (a, b) in kinds.items():
                rec[kind + "_stretches"] = stretches(a[key], b[match[0]])
                rec[kind + "_lines"] = [len(a[key]), len(b[match[0]])]
            out[label] = rec
    return out


def same_outputs(runs: list) -> dict:
    """For each output hash (a ``*_sha256`` key) of the first run, whether
    every run that reports it gave the same hash."""
    return {k: all(r.get(k, v) == v for r in runs)
            for k, v in runs[0].items() if k.endswith("_sha256")}


def main(argv=None) -> dict:
    resolve_device("cuda")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--order", default=None)
    args = ap.parse_args(argv)
    n = len(args.checkouts)
    order = ([int(x) for x in args.order.split(",")] if args.order else
             [0, *range(1, n), *range(n - 1, 0, -1), 0])
    code, runs, rebuilt = {}, [], {}
    for i in order:
        built = build(os.path.abspath(args.checkouts[i]))
        if i in code:
            rebuilt[i] = all(built[k]["sass"] == code[i][k]["sass"]
                             for k in KERNELS)
        code.setdefault(i, built)
        res = subprocess.run([sys.executable, KERNEL_TIMES],
                             capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=WORK))
        if res.returncode != 0:
            raise RuntimeError(f"kernel_times failed on {i}:\n"
                               f"{res.stderr[-4000:]}")
        runs.append({"checkout": i,
                     **json.loads(res.stdout.strip().splitlines()[-1])})
        print(f"run {len(runs)}: checkout {i} done", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    out = {"checkouts": args.checkouts, "order": order, "runs": runs,
           "rebuilt_sass_identical": rebuilt,
           "outputs_equal_first": same_outputs(runs),
           "code_vs_first": {str(i): compare(code[order[0]], code[i])
                             for i in sorted(code) if i != order[0]}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
