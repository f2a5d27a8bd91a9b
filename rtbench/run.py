"""The benchmark of the PyTorch / CUDA port: one run of one cell.

    python -m rtbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  A run finds the cell's files by the names in
``BENCHMARK.json`` (`spec`), builds the cell's driver, warms up its
shapes (set-up), measures a closed-loop window of ``--seconds``, and then,
with the program's state freed, compares what the window produced with
the plain reference (``correct``).  With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read from one profiled window.  The last line of standard output is one
JSON object; the compared numbers and their limits end standard error.
A run needs as many CUDA devices as the cell asks for; without them it
exits with code 2 and prints no result.

``setup_s`` runs from the process's start (``/proc/self/stat``; 10 ms
steps) to the window's start; standard error gives its parts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracinginoneweekendincuda_tpu")


def process_start() -> float:
    """The ``time.perf_counter()`` reading of this process's start (of
    this import where /proc cannot say)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


T_START = process_start()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: str | None = None, device: str = "cuda",
         out=None) -> int:
    """One run; returns the exit code.  ``device="cpu"`` skips the look
    for a card and runs the program's plain versions (tests only)."""
    args = parse(argv)
    out = out or sys.stdout
    import torch

    from rtbench import spec, trace
    from rtbench.check import judge, lines
    marks = [("imports", time.perf_counter())]

    cell = spec.load_cell(args.workload, **({"root": root} if root else {}))
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"rtbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    if device == "cuda":
        torch.cuda.init()
        torch.cuda.synchronize()
    marks.append(("CUDA context", time.perf_counter()))
    drv = spec.driver(cell).Driver(cell, args.seed, device,
                                   traced=bool(args.trace))
    marks.append(("program and scene", time.perf_counter()))
    drv.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    tracer = trace.Tracer(bool(args.trace))
    with tracer.window():
        t0 = drv.window(args.seconds)
    setup_s = t0 - T_START
    prev = T_START
    parts = []
    for what, t in marks:
        parts.append(f"{what} {t - prev:.3f}")
        prev = t
    print(f"rtbench: set-up {setup_s:.3f} s: " + ", ".join(parts),
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    ref_world = spec.reference_scene(cell)
    metrics = {}
    if not args.trace:
        e2e = {**drv.end_to_end(t0), "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    drv.release()
    t_ref = time.perf_counter()
    correct, checked = judge(drv.readings(ref_world), cell.limits)
    correct = correct and drv.failed == 0
    print(f"rtbench: {cell.name} seed {args.seed}: {drv.attempted} items, "
          "reference "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    res = {}
    if args.trace:
        t_count = time.perf_counter()
        counts = drv.count(ref_world)
        print(f"rtbench: counts in {time.perf_counter() - t_count:.2f} s: "
              + json.dumps(counts), file=sys.stderr)
        win = tracer.result(counts)
        for m in cell.per_layer:
            v = spec.metric_reader(cell, m["name"]).read(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        res = {"busy_s": win.busy_s(), "window_s": win.window_s}
        breakdown = {"device_ops": win.top_ops(), "idle_gaps": win.idle_gaps()}
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips, "memory_peak_bytes": peak, **res}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0, **res}
    line = {"correct": bool(correct), "attempted": drv.attempted,
            "failed": drv.failed, "metrics": metrics, "device": dev}
    if args.trace:
        line["breakdown"] = breakdown
    line["check"] = checked
    for text in lines(checked):
        print(text, file=sys.stderr)
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
