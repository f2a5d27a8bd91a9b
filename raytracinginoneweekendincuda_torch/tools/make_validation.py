"""Writes ``VALIDATION_TORCH.json``, the port's on-card validation record:
runs both validators in this process -- `validate_gpu` (the card against
the CPU build, the pinned frame hashes, the north star, the oracle) and
`validate_replay_gpu` (K3 / K4 against the XLA replay) -- and merges their
metrics with the date, the card's name and power limit, and the torch and
CUDA versions.  Section 3 of `validate_gpu` pins the card's frame hashes
against the record it replaces (``--hash-intended REASON`` accepts a
change).  Prints the record as one JSON line; exits non-zero unless both
validators pass.  Needs a CUDA device.

    python -m raytracinginoneweekendincuda_torch.tools.make_validation \
        [--out PATH] [--hash-intended REASON]
"""

from __future__ import annotations

import argparse
import datetime
import json

import torch

from ..ops.render import resolve_device
from ..utils.benchmark import device_line
from . import validate_gpu, validate_replay_gpu


def make_record(device="cuda", *, out: str = validate_gpu.RECORD,
                intended: str = "") -> dict:
    """Both validators' metrics merged into one record, written to
    ``out``; section 3 pins the hashes of the record it replaces."""
    dev = resolve_device(device)
    engines = validate_gpu.validate(dev, intended=intended)
    replay = validate_replay_gpu.validate(dev)
    doc = {
        "date": datetime.date.today().isoformat(),
        "card": device_line(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "engines_vs_cpu": engines,
        "replay_vs_xla": replay,
        "ok": bool(engines["ok"]) and bool(replay["ok"]),
    }
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=validate_gpu.RECORD,
                    help="where to write the record (default "
                         "VALIDATION_TORCH.json at the repository's root)")
    ap.add_argument("--hash-intended", default="", metavar="REASON",
                    help="accept a change of the card's frame hashes, "
                         "recording REASON")
    args = ap.parse_args(argv)
    doc = make_record("cuda", out=args.out, intended=args.hash_intended)
    print(json.dumps(doc))
    print(f"wrote {args.out}: ok={doc['ok']}")
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
