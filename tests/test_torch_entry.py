"""PyTorch port: entry points, device dispatch and the JAX-free import."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops.render import render
from raytracinginoneweekendincuda_torch.utils import cli
from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py as a module (main not
    run), import neither jax nor anything of the JAX package."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import raytracinginoneweekendincuda_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                                pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke',\n"
        "                                              'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.startswith(\n"
        "    ('jax', 'raytracinginoneweekendincuda_tpu'))]\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 20, r.stdout


def test_cli_cpu_writes_ppm(tmp_path):
    out = tmp_path / "scene4.ppm"
    rc = cli.main(["--scene", "4", "--width", "16", "--height", "8",
                   "--spp", "2", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[:3] == ["P3", "16 8", "255"]
    px = np.array([[int(v) for v in ln.split()] for ln in lines[3:]])
    assert px.shape == (16 * 8, 3)
    assert px.min() >= 0 and px.max() <= 255 and px.any()


def test_cli_cuda_without_card_raises():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--scene", "4", "--width", "16", "--height", "8",
                  "--spp", "1", "--out", os.devnull])


def test_cli_rejects_unported_flags():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--cpu"])
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--engine", "bruteforce"])


def test_dispatch_on_cpu_tensors_leaves_launch_counter():
    scene, meta = compile_scene(scenes.build_scene(4), 16, 8,
                                dtype=np.float32)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1,
                       engine="mega2")
    tab = mega2.pack_mega2_tables(scene, meta, "cpu")
    before = mega2.render_radiance_cuda.launches
    out = mega2.render_radiance(tab, torch.arange(16, dtype=torch.int32),
                                mega2.frame_params(scene, cfg))
    assert out.shape == (16, 3) and out.dtype == torch.float32
    assert mega2.render_radiance_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    scene, meta = compile_scene(scenes.build_scene(4), 16, 8,
                                dtype=np.float32)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1)
    tab = mega2.pack_mega2_tables(scene, meta, "cpu")
    before = mega2.render_radiance_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        mega2.render_radiance_cuda(tab, torch.arange(4, dtype=torch.int32),
                                   mega2.frame_params(scene, cfg))
    with pytest.raises(ValueError, match="no mega2 render"):
        mega2.render_radiance(tab, torch.arange(4, device="meta"),
                              mega2.frame_params(scene, cfg))
    assert mega2.render_radiance_cuda.launches == before


def test_render_unported_engine_raises():
    scene, meta = compile_scene(scenes.build_scene(4), 16, 8,
                                dtype=np.float32)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1,
                       engine="bruteforce")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render(scene, meta, cfg, device="cpu")


def test_render_u8_and_orientation():
    """u8 output is 256 * clip(gamma image, 0, 0.999) of the float image,
    rows top-down (row 0 = top scanline)."""
    scene, meta = compile_scene(scenes.build_scene(4), 16, 8,
                                dtype=np.float32)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=2,
                       engine="mega2")
    img = render(scene, meta, cfg, device="cpu")
    u8 = render(scene, meta, cfg, device="cpu", out_u8=True)
    assert u8.dtype == np.uint8 and u8.shape == (8, 16, 3)
    np.testing.assert_array_equal(
        u8, (np.float32(256.0) * np.clip(img, np.float32(0.0),
                                         np.float32(0.999))).astype(np.uint8))
    tab = mega2.pack_mega2_tables(scene, meta, "cpu")
    bottom_left = mega2.render_radiance(
        tab, torch.tensor([0], dtype=torch.int32),
        mega2.frame_params(scene, cfg))
    np.testing.assert_array_equal(
        img[-1, 0], np.sqrt(bottom_left[0].double().numpy() / 2)
        .astype(np.float32))


def test_benchmark_without_card_raises():
    _no_card()
    from raytracinginoneweekendincuda_torch.utils import benchmark

    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(["--width", "16", "--height", "8", "--spp", "1"])


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the build says so; it never falls back."""
    from raytracinginoneweekendincuda_torch.utils import cuda_build

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
