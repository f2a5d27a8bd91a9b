"""PyTorch port: entry points, device dispatch and the JAX-free import."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops.render import ENGINES, render
from raytracinginoneweekendincuda_torch.utils import cli
from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401

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
        "tools = {pkg.__name__ + '.tools.' + t for t in\n"
        "         ('probe_pair', 'probe_intmul', 'probe_mosaic')}\n"
        "assert tools <= set(names), names\n"
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
    # 41 modules, the XLA engine family's (core/vecmath, ops/hit, shade,
    # textures, perlin, integrator, dispatch, wavefront, pallas_hit, mega)
    # and the probe tools' (tools/, common, probe_pair, probe_intmul,
    # probe_mosaic) among them
    assert int(r.stdout.split()[-1]) >= 41, r.stdout


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


@pytest.mark.parametrize("engine", ("bruteforce", "wavefront",
                                    "wavefront_pallas", "mega"))
def test_cli_cpu_xla_engines(engine, tmp_path):
    """The XLA-family engines render through the CLI on the CPU (scene 4,
    16x8@1) and agree with the default engine's frame to a u8 step."""
    out = tmp_path / f"{engine}.ppm"
    ref = tmp_path / "mega2.ppm"
    base = ["--scene", "4", "--width", "16", "--height", "8", "--spp", "1",
            "--device", "cpu"]
    assert cli.main([*base, "--engine", engine, "--out", str(out)]) == 0
    assert cli.main([*base, "--out", str(ref)]) == 0
    a, b = (np.array([[int(v) for v in ln.split()]
                      for ln in f.read_text().splitlines()[3:]])
            for f in (out, ref))
    assert a.shape == (16 * 8, 3) and np.abs(a - b).max() <= 1


@pytest.mark.parametrize("engine", ("bruteforce", "mega", "bvh",
                                    "wavefront_bvh"))
def test_cli_cuda_engine_without_card_raises(engine):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--scene", "4", "--width", "16", "--height", "8",
                  "--spp", "1", "--engine", engine, "--out", os.devnull])


@pytest.mark.parametrize("entry", ("init_state", "split_params",
                                   "params_from_numpy", "derive_replay",
                                   "replay_table"))
def test_entry_points_have_no_cpu_default(entry):
    """The training entry points run on the card unless asked for the CPU:
    without a device argument they raise where there is no card, and make
    no CPU tensor.  ``derive_replay`` takes its device explicitly;
    ``replay_table`` takes its device from the tables it is given."""
    import inspect

    from raytracinginoneweekendincuda_torch.ops import replay
    from raytracinginoneweekendincuda_torch.parallel import train
    from raytracinginoneweekendincuda_torch.scene.compiler import (
        compile_scene as tcompile,
    )
    from raytracinginoneweekendincuda_torch.models import scenes as tscenes

    _no_card()
    if entry == "derive_replay":
        param = inspect.signature(replay.derive_replay).parameters["device"]
        assert param.default is inspect.Parameter.empty
        return
    if entry == "replay_table":
        assert "device" not in inspect.signature(
            replay.replay_table).parameters
        return
    scene, _ = tcompile(tscenes.build_scene(4), 8, 8, dtype=np.float32)
    arrays = train.params_to_numpy(train.split_params(scene, "cpu"))
    calls = {
        "init_state": lambda: train.init_state(
            scene, lambda ps: torch.optim.Adam(ps, lr=0.1)),
        "split_params": lambda: train.split_params(scene),
        "params_from_numpy": lambda: train.params_from_numpy(arrays),
    }
    made = []
    real_leaf = train._leaf
    train._leaf = lambda x, device: made.append(real_leaf(x, device))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()
    finally:
        train._leaf = real_leaf
    assert made == []


@pytest.mark.parametrize("tool", ("probe_pair", "probe_intmul",
                                  "probe_mosaic", "lane_share",
                                  "kernel_times", "build_ab", "replay_split"))
def test_probe_tools_without_card_raise(tool):
    """The probe tools and ``lane_share`` run on the card unless given
    ``--device cpu`` (tests/test_torch_probes.py runs the probes so);
    ``kernel_times``, ``build_ab`` and ``replay_split`` run only on the
    card."""
    import importlib

    _no_card()
    mod = importlib.import_module(
        f"raytracinginoneweekendincuda_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_cli_cuda_without_card_raises():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--scene", "4", "--width", "16", "--height", "8",
                  "--spp", "1", "--out", os.devnull])


def test_cli_rejects_unported_flags():
    """``--cpu`` (the port's ``--device cpu``) is not ported; ``--sharded``
    and ``--profile DIR`` (a torch.profiler trace) are."""
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--cpu"])
    assert cli.build_parser().parse_args(["--profile", "trace"]).profile \
        == "trace"
    assert cli.build_parser().parse_args(["--sharded"]).sharded


def test_cli_profile_writes_trace(tmp_path):
    """``--profile DIR`` writes a torch.profiler Chrome trace of the render
    into DIR."""
    import json

    trace = tmp_path / "trace"
    assert cli.main(["--scene", "4", "--width", "16", "--height", "8",
                     "--spp", "1", "--device", "cpu", "--profile",
                     str(trace), "--out", str(tmp_path / "p.ppm")]) == 0
    doc = json.loads((trace / "render.trace.json").read_text())
    assert doc["traceEvents"]
    assert (tmp_path / "p.ppm").read_text().startswith("P3\n16 8\n255")


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
                       engine="raster")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render(scene, meta, cfg, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_render_differentiable_matches(engine):
    """``differentiable=True`` runs the scan-form loop on ``bruteforce``,
    whose frame equals the ``while`` form's; the other engines have one
    loop each and ignore the flag, as in the JAX package."""
    scene, meta = compile_scene(scenes.build_scene(4), 16, 8,
                                dtype=np.float32)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1,
                       engine=engine)
    want = render(scene, meta, cfg, device="cpu")
    got = render(scene, meta, cfg.with_(differentiable=True), device="cpu")
    assert got.shape == (8, 16, 3) and got.any()
    np.testing.assert_array_equal(got, want)


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


def test_custom_scene_without_card_raises():
    """The example renders on the card unless given ``--device cpu``."""
    _no_card()
    from raytracinginoneweekendincuda_torch.examples import custom_scene

    with pytest.raises(RuntimeError, match="no CUDA device"):
        custom_scene.main(["--width", "16", "--height", "9", "--spp", "1",
                           "--out", os.devnull])


def test_cli_float64_bvh_engines_on_cpu(tmp_path):
    """``--dtype float64`` is taken by the plain PyTorch engines, the BVH
    ones among them, and refused by the kernels' engines."""
    base = ["--scene", "4", "--width", "8", "--height", "4", "--spp", "1",
            "--device", "cpu", "--dtype", "float64"]
    for engine in ("bvh", "wavefront_bvh"):
        assert cli.main([*base, "--engine", engine,
                         "--out", str(tmp_path / f"{engine}.ppm")]) == 0
    with pytest.raises(SystemExit, match="float64"):
        cli.main([*base, "--engine", "mega", "--out", os.devnull])


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
