"""PyTorch port: replay gradients (torch autograd through ``replay_plain``,
the plain version of kernel K4) against ``jax.grad`` of the JAX package's
XLA replay, and against central finite differences of the port's own
primal, as ``tests/test_pallas_replay.py`` and ``tests/test_replay.py``
check the Pallas and XLA replays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.parallel import train as ttrain
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops import replay as rp
from torch_probe_scenes import (
    H, W, marble_probe, media_probe, port_trace_case, port_trace_replay,
)
from test_torch_replay import T_MIN, jax_case, port_replay
from torch_threads import one_torch_thread  # noqa: F401

K = 2
EPS = 1e-3


def _wgt(n, scale):
    return torch.arange(n * 3, dtype=torch.float32).reshape(-1, 3) * scale


def test_tex_grad_matches_jax_replay_on_quads():
    """Scene 4: d(sum(w * radiance)) / d(tex_c0) of the port against
    ``jax.grad`` of the XLA replay on the same tape (rtol 1e-4, atol 1e-4
    of the largest entry: both sum f32 products in their own order)."""
    (js, jm, tape, o, d, t, pc), port = jax_case(
        jscenes.build_scene(4), tscenes.build_scene(4), K)
    wgt = _wgt(W * H, 1e-2)

    def L(tex):
        sc = js._replace(tex_c0=tex)
        return (rp.replay(sc, jm, tape, o, d, t, pc, jnp.uint32(0),
                          max_bounces=K, t_min=T_MIN)
                * jnp.asarray(wgt.numpy())).sum()

    want = np.asarray(jax.grad(L)(js.tex_c0))
    tex = torch.tensor(np.asarray(port["scene"].tex_c0), requires_grad=True)
    (port_replay(port, scene=port["scene"]._replace(tex_c0=tex))
     * wgt).sum().backward()
    got = tex.grad.numpy()
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _fd(fn, v0):
    return (fn(v0 + EPS) - fn(v0 - EPS)) / (2 * EPS)


def _grad_and_fd(case, field, idx, wgt):
    """(autograd, central FD) of sum(wgt * radiance) in one scene entry."""
    base = np.asarray(getattr(case["scene"], field), np.float32)

    def with_value(v):
        arr = torch.tensor(base)
        arr[idx] = v
        return arr

    leaf = torch.tensor(base, requires_grad=True)
    loss = (port_trace_replay(case, scene=case["scene"]._replace(
        **{field: leaf})) * wgt).sum()
    loss.backward()

    def L(v):
        with torch.no_grad():
            sc = case["scene"]._replace(**{field: with_value(v)})
            return float((port_trace_replay(case, scene=sc) * wgt).sum())

    return float(leaf.grad[idx]), _fd(L, float(base[idx]))


def test_scene0_grads_fd_finite_and_zero_ray_cotangents():
    """Scene 0 (spheres, checker, moving spheres, lens): the tex_c0
    gradient matches central FD of the port's primal; every trainable
    leaf's gradient is finite; the ray / time cotangents are exactly zero
    (the taped radiance is piecewise constant in geometry there)."""
    case = port_trace_case(tscenes.build_scene(0), K)
    wgt = _wgt(W * H, 1e-3)
    g, fd = _grad_and_fd(case, "tex_c0", (0, 1), wgt)
    assert np.isfinite(g) and abs(g) > 0.0
    np.testing.assert_allclose(g, fd, rtol=5e-2)

    params = ttrain.split_params(case["scene"], "cpu")
    rays = case["rays"].clone().requires_grad_(True)
    bg = params["camera"].background
    out = port_trace_replay(case, scene=ttrain.merge_params(case["scene"],
                                                            params),
                            rays=rays, bg=bg)
    (out * wgt).sum().backward()
    for leaf in ttrain.parameter_list(params):
        assert leaf.grad is None or torch.isfinite(leaf.grad).all()
    assert float(bg.grad.abs().max()) > 0.0
    assert rays.grad is None or (rays.grad == 0).all()


def _smooth_lanes(case, field, idx):
    """Lanes whose central FD in one scene entry converges: the FD at EPS
    and at EPS / 10 agree to 2%.  Marble turbulence has octaves down to
    1/128 of a unit, and a grazing bounce moves the next hit point ~100x
    faster than the sphere, so on a few lanes no f32 FD step resolves the
    derivative; those lanes have no FD reference to hold a gradient to."""
    base = np.asarray(getattr(case["scene"], field), np.float32)

    def out(v):
        arr = torch.tensor(base)
        arr[idx] = v
        with torch.no_grad():
            return port_trace_replay(
                case, scene=case["scene"]._replace(**{field: arr})).sum(1)

    v0 = float(base[idx])
    fd = [(out(v0 + e) - out(v0 - e)) / (2 * e) for e in (EPS, EPS / 10)]
    return (fd[0] - fd[1]).abs() <= 0.02 * torch.maximum(
        fd[0].abs(), fd[1].abs()) + 1e-3


@pytest.mark.parametrize("probe,k,field,idx", [
    ("marble", 4, "sph_c0", (0, 2)),
    ("media", K, "tex_c0", "medium 0"),
    ("media", K, "tex_c0", "medium 1"),
])
def test_probe_grads_match_fd(probe, k, field, idx):
    """Marble probe (tests/test_replay.py): a sphere-centre gradient
    through the continuous marble texture (4 bounces: sphere, marble
    ground, sky), over the lanes where FD converges (at least 90%).
    Media probe (tests/test_pallas_replay.py): the albedo of a
    sphere-boundary and a box-boundary medium.  Each nonzero and within 5%
    of central FD of the port's own primal (f32)."""
    case = port_trace_case(marble_probe() if probe == "marble"
                           else media_probe(), k)
    if isinstance(idx, str):
        m = int(idx.split()[1])
        mat = int(np.asarray(case["scene"].med_mat)[m])
        idx = (int(np.asarray(case["scene"].mat_tex)[mat]), 1)
    wgt = torch.ones((W * H, 3))
    if probe == "marble":
        smooth = _smooth_lanes(case, field, idx)
        assert smooth.float().mean() >= 0.9
        wgt = wgt * smooth[:, None]
    g, fd = _grad_and_fd(case, field, idx, wgt)
    assert np.isfinite(g) and abs(g) > 0.0, g
    np.testing.assert_allclose(g, fd, rtol=5e-2)
