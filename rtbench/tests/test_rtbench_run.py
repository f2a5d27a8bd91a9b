"""Whole runs at a tiny size on the CPU through the program's plain
path: the last line's shape, and `correct` false under each fault a
render cell can have."""

import io
import json

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.ops import render as port_render
from rtbench.run import main

CELLS = ("book1_final.final_render", "bouncing_spheres.preview")


def run(root, workload, seed=2**31 + 5, trace=0, seconds=0.3):
    buf = io.StringIO()
    rc = main(["--workload", workload, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], root=root,
              device="cpu", out=buf)
    assert rc == 0
    return json.loads(buf.getvalue().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_last_line_end_to_end(tiny_root, workload):
    line = run(tiny_root, workload)
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    names = set(line["metrics"])
    assert names == ({"rays_per_s", "setup_s", "frame_p95_ms"}
                     if workload.endswith("preview")
                     else {"rays_per_s", "frame_s", "setup_s"})
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["check"]) == {"u8_mean_abs", "pixels_off_pct",
                                  "frames_missing"}


def test_last_line_traced(tiny_root):
    line = run(tiny_root, "bouncing_spheres.preview", trace=1)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # the CPU has no device trace: its readers find nothing and say so
    assert line["metrics"] == {}


def test_same_seed_same_inputs(tiny_root):
    a = run(tiny_root, "bouncing_spheres.preview", seed=99)
    b = run(tiny_root, "bouncing_spheres.preview", seed=99)
    assert a["check"] == b["check"]


def broken(kind):
    real = port_render.render
    state = {}

    def render(scene, meta, cfg, **kw):
        img = real(scene, meta, cfg, **kw)
        if kind == "stale":        # the first frame, returned unchanged
            return state.setdefault("first", img)
        img = img.copy()
        h = img.shape[0]
        if kind == "half":         # half of the frame left out
            img[h // 2:] = 0
        elif kind == "altered":    # an answer altered where it is made
            img[: h // 4] = np.minimum(img[: h // 4].astype(int) + 9, 255)
        return img
    return render


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, kind,
                                            workload):
    monkeypatch.setattr(port_render, "render", broken(kind))
    line = run(tiny_root, workload, seed=31337)
    assert line["correct"] is False


def test_no_card_no_result(tiny_root, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    rc = main(["--workload", CELLS[1], "--seed", "1", "--seconds", "1"],
              root=tiny_root, out=buf)
    assert rc != 0 and buf.getvalue() == ""
