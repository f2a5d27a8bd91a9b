"""PyTorch port: counter RNG and camera rays against the JAX package.

pcg4d runs on int32 tensors in the port (no uint32 arithmetic on CPU
torch) and must be bit-exact against ``core/rng.py`` on numpy uint32.
Rays must be bit-identical to JAX ``generate_rays`` for the pinhole scenes
(1-9); scene 0 has a thin lens, whose disk sample goes through sin/cos,
and PyTorch's and XLA's CPU sin/cos differ by an ulp or two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.core import rng as trng
from raytracinginoneweekendincuda_torch.core.samplers import sqrt_f32
from raytracinginoneweekendincuda_torch.ops import raygen as traygen
from raytracinginoneweekendincuda_tpu.core import rng as jrng
from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.ops.raygen import generate_rays
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene


def _words(n, seed):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, 2 ** 32, n, dtype=np.uint32) for _ in range(4)]


def test_pcg4d_and_unit_bit_exact_vs_numpy():
    words = _words(100_000, 0)
    with np.errstate(over="ignore"):
        want = jrng.pcg4d(*words)
    got = trng.pcg4d(*[torch.from_numpy(w.view(np.int32)) for w in words])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(trng.as_uint32(a), b)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(
            trng.unit(a).numpy(), jrng._to_unit_float(b, np.float32))


def test_uniform4_matches_numpy_streams():
    """uniform4 keyed like raygen/scatter: (seed ^ pix, sample, stream,
    slot), with stream words above 2^31 as well."""
    n = 4096
    pix = np.arange(n, dtype=np.uint32) ^ np.uint32(1984)
    for stream in (jrng.CAMERA_STREAM, jrng.SCATTER_STREAM | 7,
                   jrng.MEDIUM_STREAM | 3, 0xFFFFFFF0):
        for slot in (0, 2):
            with np.errstate(over="ignore"):
                want = jrng.uniform4(
                    pix, np.full(n, 5, np.uint32),
                    np.full(n, stream, np.uint32),
                    np.full(n, slot, np.uint32), float_dtype=np.float32)
            got = trng.uniform4(torch.from_numpy(pix.view(np.int32)), 5,
                                trng.to_word(stream), slot)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b)


def test_sqrt_f32_is_correctly_rounded():
    x = np.random.default_rng(3).random(200_000, dtype=np.float32) * 100
    np.testing.assert_array_equal(sqrt_f32(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def _rays(sid, sample):
    W, H = 24, 12
    scene, _ = compile_scene(scenes.build_scene(sid), W, H, dtype=np.float32)
    pix = np.arange(W * H, dtype=np.int32)
    jo, jd, jt, jc = generate_rays(scene.camera, jnp.asarray(pix), sample,
                                   W, H, 1984)
    to, td, tt, tc = traygen.generate_rays(
        traygen.camera_tuple(scene.camera), torch.from_numpy(pix), sample,
        W, H, 1984)
    np.testing.assert_array_equal(trng.as_uint32(tc), np.asarray(jc))
    return ((np.asarray(jo), to.numpy()), (np.asarray(jd), td.numpy()),
            (np.asarray(jt), tt.numpy()))


@pytest.mark.parametrize("sid", range(1, 10))
def test_rays_bit_identical_pinhole(sid):
    for sample in (0, 1):
        for want, got in _rays(sid, sample):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_rays_lens_and_motion_within_ulps():
    for sample in (0, 1):
        for want, got in _rays(0, sample):
            np.testing.assert_array_max_ulp(got, want, maxulp=4)


@pytest.mark.parametrize("sid", range(10))
def test_camera_tensor_rays_equal_tuple_rays(sid):
    """generate_rays on a CameraParams of tensors (the gradient path) gives
    the tuple camera's rays bit for bit, with per-lane sample ids, and
    carries gradients to the camera leaves."""
    from raytracinginoneweekendincuda_torch.core.camera import CameraParams
    from raytracinginoneweekendincuda_torch.models import scenes as tscenes
    from raytracinginoneweekendincuda_torch.scene.compiler import (
        compile_scene as tcompile,
    )

    W, H = 24, 12
    scene, _ = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float32)
    cam = CameraParams(*[torch.tensor(np.asarray(x), requires_grad=True)
                         for x in scene.camera])
    pix = torch.arange(W * H, dtype=torch.int32)
    samp = torch.arange(W * H, dtype=torch.int32) % 3
    want = traygen.generate_rays(traygen.camera_tuple(scene.camera), pix,
                                 samp, W, H, 1984)
    got = traygen.generate_rays(cam, pix, samp, W, H, 1984)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
    (got[0].sum() + 2.0 * got[1].sum() + 3.0 * got[2].sum()).backward()
    assert float(cam.origin.grad.abs().sum()) > 0.0
    assert float(cam.lower_left.grad.abs().sum()) > 0.0
