"""Fixtures of the benchmark's CPU tests: one torch thread, and a copy of
the benchmark at a tiny size in a temporary root."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

RTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(RTBENCH)
TINY = {"width": 24, "height": 16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root holding BENCHMARK.json and a copy of rtbench/ whose
    configurations and mixes are cut to a few pixels and samples."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(RTBENCH, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for p in (tmp_path / "rtbench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(TINY)
        p.write_text(json.dumps(c))
    for p in (tmp_path / "rtbench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(spp=2, check={"frames": 2, "pixels": 96},
                 lane_count={"stride": 4, "samples": 1})
        p.write_text(json.dumps(t))
    return str(tmp_path)


def gpu_device():
    """The card, or a skip: decided inside a test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
