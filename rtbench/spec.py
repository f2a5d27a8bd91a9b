"""Finds a cell's files by the names in ``BENCHMARK.json``.

- configuration: the ``file`` of its ``configs`` entry (JSON);
- traffic mix: ``<base>/traffic/<traffic>.json``, read by the driver its
  ``"driver"`` key names (``<base>/drivers/<driver>.py``);
- limits of the comparison that decides ``correct``:
  ``<base>/limits/<workload>.json``;
- per-layer metric: ``<base>/metrics/<metric>.py``, a reader with
  ``read(window) -> float | None``;
- reference scene: ``<base>/reference/scenes/<scene>.py``.

``base`` is this folder unless a caller gives another, so that a cell, a
mix or a metric is added as files and entries, with no edit to a file
that is here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BASE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BASE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list
    base: str = BASE


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: str = ROOT, base: str | None = None) -> Cell:
    """The workload ``name`` of ``<root>/BENCHMARK.json`` with its files;
    raises KeyError for an unknown name."""
    base = base or os.path.join(root, "rtbench")
    bench = load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}[name]
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    return Cell(
        name=name, chips=int(wl["chips"]),
        config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(base, "traffic", wl["traffic"] + ".json")),
        limits=_json(os.path.join(base, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        base=base)


def load_module(path: str, name: str):
    """Imports the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    """The driver module the cell's traffic mix names."""
    d = cell.traffic["driver"]
    return load_module(os.path.join(cell.base, "drivers", d + ".py"),
                       f"rtbench_driver_{d}")


def metric_reader(cell: Cell, metric: str):
    """The reader ``<base>/metrics/<metric>.py`` of a per-layer metric."""
    return load_module(os.path.join(cell.base, "metrics", metric + ".py"),
                       "rtbench_metric_" + metric.replace(".", "_"))


def reference_scene(cell: Cell):
    """The reference's World of the cell's scene."""
    scene = cell.config["scene"]
    return load_module(
        os.path.join(cell.base, "reference", "scenes", scene + ".py"),
        f"rtbench.reference.scenes.{scene}").world()
