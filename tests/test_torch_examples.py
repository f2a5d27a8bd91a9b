"""PyTorch port: the examples' ``main`` on the CPU at one step each (a
smoke run of the general train step end to end: target render, step,
output).  One step is too few to converge, so each example's own
convergence check reports it."""

import numpy as np
import pytest

from raytracinginoneweekendincuda_torch.examples import (
    inverse_render, recover_geometry,
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
