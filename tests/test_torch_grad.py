"""PyTorch port: gradients of the scan-form integrator
(``ops/integrator.trace(differentiable=True)``: every bounce under
``torch.utils.checkpoint``), mirroring tests/test_grad.py on its probe
scene in f64 (12x8, spp 4, K 6): torch autograd against central finite
differences with the JAX test's bounds, every leaf against ``jax.grad`` of
the JAX package's scan form, determinism and finiteness.

The marble ground turns geometry into smooth radiance (tests/test_grad.py
explains why the probe needs it); every case asserts its finite difference
is nonzero.  The port runs eagerly, so the camera-origin case and the four
that tests/test_grad.py marks slow for their compile time run here."""

import jax
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.ops.hit import scene_tensors
from raytracinginoneweekendincuda_torch.ops.integrator import trace
from raytracinginoneweekendincuda_torch.ops.raygen import generate_rays
from raytracinginoneweekendincuda_torch.parallel import train as ttrain
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_tpu.parallel import train as jtrain
from test_grad import _image_sum as jax_image_sum
from test_grad import _probe_scene as jax_probe_scene
from torch_probe_scenes import SEED, marble_probe
from torch_threads import one_torch_thread  # noqa: F401

W, H, SPP, BOUNCES, T_MIN = 12, 8, 4, 6, 1e-3
FD_H = 1e-6     # tests/test_grad.py: the marble's curvature needs h this small


def image_sum(st, meta, differentiable=True):
    """Sum of the linear radiance of a tensor scene, samples averaged."""
    pix = torch.arange(W * H)
    acc = 0.0
    for s in range(SPP):
        o, d, t, pc = generate_rays(st.camera, pix, s, W, H, SEED)
        acc = acc + trace(st, meta, o, d, t, pc, s, max_bounces=BOUNCES,
                          t_min=T_MIN, differentiable=differentiable)
    return (acc / SPP).sum()


@pytest.fixture(scope="module")
def probe():
    return tcompile(marble_probe(), W, H, dtype=np.float64)


def port_grads(scene, meta) -> dict:
    """d(image_sum)/d(every leaf of split_params), as numpy (zeros where
    autograd reaches no path)."""
    params = ttrain.split_params(scene, "cpu")
    image_sum(ttrain.merge_params(scene_tensors(scene, "cpu"), params),
              meta).backward()
    g = lambda p: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
    out = {f: g(params[f]) for f in ttrain.DIFF_SCENE_FIELDS}
    out["camera"] = type(params["camera"])(*[g(p) for p in params["camera"]])
    return out


@pytest.fixture(scope="module")
def grads(probe):
    return port_grads(*probe)


def fd(scene, meta, edit) -> float:
    """Central difference of image_sum: ``edit(scene, delta)`` returns the
    scene with the parameter moved by ``delta``."""
    with torch.no_grad():
        up, down = (float(image_sum(scene_tensors(edit(scene, h), "cpu"),
                                    meta, differentiable=False))
                    for h in (FD_H, -FD_H))
    return (up - down) / (2 * FD_H)


@pytest.mark.parametrize("field,idx", [
    ("sph_c0", (0, 0)),         # diffuse sphere center x
    ("tex_c0", (0, 1)),         # albedo green channel
    ("sph_c0", (0, 2)),         # center z
    ("sph_rad", (0,)),          # radius
    ("mat_fuzz", (1,)),         # metal fuzz
    ("mat_ior", (2,)),          # dielectric IOR
])
def test_scene_param_grads_match_fd(probe, grads, field, idx):
    scene, meta = probe

    def edit(sc, delta):
        arr = np.array(getattr(sc, field))
        arr[idx] += delta
        return sc._replace(**{field: arr})

    g_fd = fd(scene, meta, edit)
    assert abs(g_fd) > 1e-6, f"{field}[{idx}]: vacuous probe (FD ~ 0)"
    np.testing.assert_allclose(grads[field][idx], g_fd, rtol=5e-3,
                               atol=1e-5, err_msg=f"{field}[{idx}]")


def test_camera_origin_grad_matches_fd(probe, grads):
    """tests/test_grad.py's camera case: the origin moved alone along x."""
    scene, meta = probe

    def edit(sc, delta):
        cam = sc.camera._replace(origin=np.asarray(sc.camera.origin)
                                 + np.array([delta, 0.0, 0.0]))
        return sc._replace(camera=cam)

    g_fd = fd(scene, meta, edit)
    assert abs(g_fd) > 1e-6, "vacuous camera probe"
    np.testing.assert_allclose(grads["camera"].origin[0], g_fd, rtol=5e-3,
                               atol=1e-4)


def test_every_leaf_matches_jax_grad(grads):
    """Every leaf's gradient against ``jax.grad`` of the JAX package's
    scan form on tests/test_grad.py's own scene and objective (one jit
    over the whole parameter dict), rtol 1e-6."""
    js, jm = jax_probe_scene()
    want = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jax_image_sum(jtrain.merge_params(js, p), jm)))(
            jtrain.split_params(js)))
    for f in ttrain.DIFF_SCENE_FIELDS:
        np.testing.assert_allclose(grads[f], want[f], rtol=1e-6, err_msg=f)
    for f, a, b in zip(want["camera"]._fields, grads["camera"],
                       want["camera"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
    assert np.abs(grads["sph_c0"]).max() > 0 and \
        np.abs(grads["tex_c0"]).max() > 0


def test_grad_is_deterministic(probe, grads):
    again = port_grads(*probe)
    for f in ttrain.DIFF_SCENE_FIELDS:
        np.testing.assert_array_equal(again[f], grads[f], err_msg=f)
    for a, b in zip(again["camera"], grads["camera"]):
        np.testing.assert_array_equal(a, b)


def test_every_grad_is_finite(grads):
    for f in ttrain.DIFF_SCENE_FIELDS:
        assert np.isfinite(grads[f]).all(), f
    for f, g in zip(grads["camera"]._fields, grads["camera"]):
        assert np.isfinite(g).all(), f
