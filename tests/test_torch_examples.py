"""PyTorch port: the examples' ``main`` on the CPU: the train-step
examples at one step each (a smoke run of the general train step end to
end: target render, step, output; one step is too few to converge, so
each example's own convergence check reports it), and ``custom_scene``
against the JAX example's frame."""

import numpy as np
import pytest

from raytracinginoneweekendincuda_torch.examples import (
    custom_scene, inverse_render, recover_geometry,
)
from torch_threads import one_torch_thread  # noqa: F401


def test_inverse_render_one_step(tmp_path, capsys):
    """Writes its three frames; not converged after one step (rc 1)."""
    assert inverse_render.main(["--steps", "1", "--device", "cpu",
                                "--out", str(tmp_path)]) == 1
    for name in ("target", "init", "recovered"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0
    err = capsys.readouterr().err
    loss = float(err.split("loss ")[1].split()[0])
    assert np.isfinite(loss) and loss > 0


def test_recover_geometry_one_step(capsys):
    """One step moves the center toward the truth; the example's own
    assert (err1 < 0.5 err0) fires, as it must this early."""
    with pytest.raises(AssertionError, match="failed to converge"):
        recover_geometry.main(["--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    err0 = float(out.split("initial center error: ")[1].split()[0])
    err1 = float(out.split("center err ")[1].split()[0])
    assert np.isfinite(err1) and err1 < err0


def _ppm_pixels(path):
    lines = path.read_text().splitlines()
    assert lines[:3] == ["P3", "16 9", "255"]
    return np.array([[int(v) for v in ln.split()] for ln in lines[3:]])


def test_custom_scene_matches_jax_example(tmp_path, capsys):
    """The port's ``custom_scene`` on the CPU at 16x9@1 against the JAX
    example's PPM at the same size, under the noise-scene bounds of
    ``ROADMAP.md``'s north star (marble sphere, fog, lens and motion blur;
    XLA's and PyTorch's transcendentals differ by ulps): more than 90% of
    pixels within 1e-2 and a mean difference below 2e-2."""
    import importlib.util
    import os

    size = ["--width", "16", "--height", "9", "--spp", "1"]
    assert custom_scene.main([*size, "--device", "cpu", "--out",
                              str(tmp_path / "port.ppm")]) == 0
    assert "on cpu" in capsys.readouterr().out
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "custom_scene.py")
    spec = importlib.util.spec_from_file_location("jax_custom_scene", path)
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    assert jax_example.main([*size, "--out", str(tmp_path / "jax.ppm")]) == 0
    got, want = (_ppm_pixels(tmp_path / f"{n}.ppm") / 255.0
                 for n in ("port", "jax"))
    assert got.any()
    diff = np.abs(got - want).max(-1)
    assert (diff <= 1e-2).mean() > 0.9 and np.abs(got - want).mean() < 2e-2
