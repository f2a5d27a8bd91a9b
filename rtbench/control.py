"""The control of a cell's comparison.

The control is the reference computed in the precision below the
configuration's (bfloat16 for float32) put in the program's place, on
the pixels and frames that a run with the same seed compares.  Its
readings set the upper end of each limit (``limits/<workload>.json``),
and it has to come out not correct.

    python -m rtbench.control --workload <name> --seeds 1,2,3 [--frames N]

``--frames``: the frames a window holds (the frames compared are drawn
among them).  Prints one JSON line a seed.  The benchmark's runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rtbench import spec
from rtbench.check import judge

LOWER = {"float32": torch.bfloat16}


def control(workload: str, seed: int, frames: int = 20, *,
            root: str | None = None, device: str = "cuda") -> dict:
    cell = spec.load_cell(workload, **({"root": root} if root else {}))
    readings = spec.driver(cell).Sample(cell, seed, device).readings(
        [None] * frames, spec.reference_scene(cell),
        low=LOWER[cell.config["dtype"]])
    correct, checked = judge(readings, cell.limits)
    return {"workload": workload, "seed": seed, "correct": correct,
            "check": checked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(control(args.workload, int(s), args.frames)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
