"""A configuration, a traffic mix, a per-layer metric and a cell are
added as new files and new entries, with no edit to a file that is
there, and the harness finds them by name."""

import io
import json
import os

from rtbench import spec
from rtbench.run import main


def add_cell(root: str) -> str:
    base = os.path.join(root, "rtbench")
    with open(os.path.join(base, "configs", "bouncing_spheres.json")) as f:
        cfg = json.load(f)
    cfg.update(width=16, height=8)
    with open(os.path.join(base, "configs", "small_spheres.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(base, "traffic", "one_sample.json"), "w") as f:
        json.dump({"driver": "render_loop", "spp": 1,
                   "check": {"frames": 1, "pixels": 16},
                   "lane_count": {"stride": 2, "samples": 1}}, f)
    with open(os.path.join(base, "metrics", "frames_counted.py"), "w") as f:
        f.write("def read(win):\n    return float(win.counts['frames'])\n")
    name = "small_spheres.one_sample"
    with open(os.path.join(base, "limits", name + ".json"), "w") as f:
        json.dump({"u8_mean_abs": 0.05, "pixels_off_pct": 0.5,
                   "frames_missing": 0}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "small_spheres", "source": "test",
                             "file": "rtbench/configs/small_spheres.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "small_spheres",
                               "traffic": "one_sample", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append(name)
    bench["per_layer"].append({"name": "frames_counted", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "rays_per_s",
                               "workloads": [name]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return name


def test_files_in_a_temporary_folder_are_found_by_name(tiny_root):
    name = add_cell(tiny_root)
    cell = spec.load_cell(name, root=tiny_root)
    assert cell.config["width"] == 16
    assert cell.traffic["spp"] == 1
    assert [m["name"] for m in cell.end_to_end] == ["rays_per_s", "setup_s"]
    assert "frames_counted" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader(cell, "frames_counted").read(
        type("W", (), {"counts": {"frames": 3}})) == 3.0
    assert len(spec.reference_scene(cell).spheres) == 484


def test_a_new_cell_runs_end_to_end_with_its_new_metric(tiny_root):
    name = add_cell(tiny_root)
    buf = io.StringIO()
    assert main(["--workload", name, "--seed", "7", "--seconds", "0.2",
                 "--trace", "1"], root=tiny_root, device="cpu", out=buf) == 0
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["frames_counted"]["value"] == line["attempted"]
