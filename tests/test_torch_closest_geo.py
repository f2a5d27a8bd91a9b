"""PyTorch port: kernel K6's plain version (``ops/pallas_hit.closest_geo_plain``)
against the JAX package's Pallas kernel ``pallas_closest_geo`` in interpret
mode, and the geometry packer against the JAX packer.

Rays: the camera rays of a 24x16 frame, then random rays from points near
the camera (numpy seed 1984), the same ``ray_pack`` and tables for both.

Tolerance: ``prim`` (mapped to global scene ids) equal on at least 99.9% of
lanes; ``t`` bit-equal wherever the winner is a quad or nothing.  On a
sphere winner ``t`` agrees to 2e-4 relative: XLA's CPU backend contracts
the interpret-mode kernel's ``b*b - a*cc`` and the dot products into FMAs,
which K6 (built with ``--fmad=false``) and its plain version do not, and
the discriminant's cancellation near tangency magnifies that rounding.
The same sphere formulas evaluated op by op in ``jax.numpy`` (nothing to
contract) match the port bit for bit on every (ray, sphere) pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops import pallas_hit as tph
from raytracinginoneweekendincuda_torch.ops.raygen import (
    camera_tuple, generate_rays,
)
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops import pallas_hit as jph
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from torch_threads import one_torch_thread  # noqa: F401

W, H, T_MIN, N_RAYS = 24, 16, 1e-3, 1024


def ray_pack(scene) -> np.ndarray:
    """[1024, 8] f32 (the Pallas kernel's 512-ray tiles): the camera rays
    of sample 0, then random rays."""
    n = W * H
    o, d, tm, _ = generate_rays(camera_tuple(scene.camera),
                                torch.arange(n, dtype=torch.int32), 0, W, H,
                                1984)
    cam = np.concatenate([o.numpy(), d.numpy(), tm.numpy()[:, None],
                          np.zeros((n, 1), np.float32)], axis=1)
    rs = np.random.default_rng(1984)
    m = N_RAYS - n
    org = np.asarray(scene.camera.origin, np.float64) \
        + rs.normal(0.0, 0.5, (m, 3))
    dirs = rs.normal(0.0, 1.0, (m, 3))
    rnd = np.concatenate([org, dirs, rs.uniform(0.0, 1.0, (m, 1)),
                          np.zeros((m, 1))], axis=1)
    return np.concatenate([cam, rnd]).astype(np.float32)


def global_ids(prim: np.ndarray, s_pad: int, n_spheres: int) -> np.ndarray:
    """Padded-table ids -> compiled-scene ids (make_pallas_hit_fn's map)."""
    g = np.where(prim >= s_pad, prim - s_pad + n_spheres, prim)
    return np.where(prim < 0, -1, g)


@pytest.mark.parametrize("sid", (0, 4, 8, 9))
def test_plain_matches_pallas_interpret(sid):
    scene, meta = jcompile(jscenes.build_scene(sid), W, H, dtype=np.float32)
    sph, quad = (np.array(t) for t in jph.pack_geometry(scene))
    rays = ray_pack(scene)
    jt, jp = (np.asarray(x) for x in jph.pallas_closest_geo(
        rays, sph, quad, t_min=T_MIN, interpret=True))
    pt, pp = tph.closest_geo(torch.from_numpy(rays), torch.from_numpy(sph),
                             torch.from_numpy(quad), T_MIN)
    assert pt.dtype == torch.float32 and pp.dtype == torch.int32
    pt, pp = pt.numpy(), pp.numpy()
    S = scene.sph_c0.shape[0]
    same = global_ids(pp, sph.shape[1], S) == global_ids(jp, sph.shape[1], S)
    assert same.mean() >= 0.999
    assert (jp >= 0).mean() > 0.15   # the rays do hit things
    not_sphere = same & ((jp < 0) | (jp >= sph.shape[1]))
    np.testing.assert_array_equal(pt[not_sphere], jt[not_sphere])
    np.testing.assert_allclose(pt[same], jt[same], rtol=2e-4)


def _sphere_t_jnp(rays, sph, t_min):
    """The Pallas kernel's sphere formulas (pallas_hit.py:122-136) over all
    (ray, sphere) pairs, op by op in jax.numpy: [B, S_pad] t or 1e30."""
    R = jnp.asarray(rays)
    row = lambda r: jnp.asarray(sph[r:r + 1])
    ox, oy, oz = R[:, 0:1], R[:, 1:2], R[:, 2:3]
    dx, dy, dz = R[:, 3:4], R[:, 4:5], R[:, 5:6]
    a = dx * dx + dy * dy + dz * dz
    frac = (R[:, 6:7] - row(6)) * row(7)
    ocx = ox - (row(0) + frac * row(3))
    ocy = oy - (row(1) + frac * row(4))
    ocz = oz - (row(2) + frac * row(5))
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - row(8) * row(8)
    disc = b * b - a * cc
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    r1 = (-b - sq) * inv_a
    r2 = (-b + sq) * inv_a
    t_c = jnp.where(r1 > t_min, r1, r2)
    ok = (disc > 0.0) & (t_c > t_min) & (row(9) > 0.5)
    return np.asarray(jnp.where(ok, t_c, 1e30))


@pytest.mark.parametrize("sid", (0, 9))
def test_sphere_pairs_equal_op_by_op_jax(sid):
    scene, _ = jcompile(jscenes.build_scene(sid), W, H, dtype=np.float32)
    sph, quad = (np.array(t) for t in jph.pack_geometry(scene))
    rays = ray_pack(scene)
    t = tph.sphere_quad_t(
        torch.from_numpy(rays[:, 0:3]), torch.from_numpy(rays[:, 3:6]),
        torch.from_numpy(rays[:, 6]), torch.from_numpy(sph),
        torch.from_numpy(quad), float(np.float32(T_MIN)), tph.SPH_ACTIVE,
        tph.QUAD_ACTIVE)
    np.testing.assert_array_equal(t[:, :sph.shape[1]].numpy(),
                                  _sphere_t_jnp(rays, sph, T_MIN))


@pytest.mark.parametrize("sid", (0, 9))
def test_port_packer_matches_jax(sid):
    """Same layout and padding; values within f32 rounding (the JAX packer
    takes |n| as pow(x, 0.5), the port as a correctly rounded sqrt); the
    winners of the camera rays agree."""
    jscene, _ = jcompile(jscenes.build_scene(sid), W, H, dtype=np.float32)
    tscene, _ = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float32)
    jsph, jquad = (np.array(t) for t in jph.pack_geometry(jscene))
    tsph, tquad = tph.pack_geometry(tscene, "cpu")
    np.testing.assert_array_equal(tsph.numpy(), jsph)
    np.testing.assert_allclose(tquad.numpy(), jquad, rtol=1e-6, atol=1e-6)
    rays = torch.from_numpy(ray_pack(tscene))
    _, pj = tph.closest_geo_plain(rays, torch.from_numpy(jsph),
                                  torch.from_numpy(jquad), T_MIN)
    _, pt = tph.closest_geo_plain(rays, tsph, tquad, T_MIN)
    assert (pj == pt).float().mean() >= 0.999


def test_pack_geometry_shapes():
    """Mirror of tests/test_pallas.py::test_pack_geometry_shapes."""
    scene, meta = tcompile(tscenes.final_scene(), 8, 8)
    sph, quad = tph.pack_geometry(scene, "cpu")
    assert sph.shape[0] == 10 and sph.shape[1] % 128 == 0
    assert quad.shape[0] == 13 and quad.shape[1] % 128 == 0
    # active rows mask exactly the real primitives
    assert int(sph[9].sum()) == meta.n_spheres
    assert int(quad[12].sum()) == meta.n_quads


def test_dispatch_and_wrapper_refusals():
    """CPU tensors take the plain version and leave K6's launch count;
    the CUDA wrapper refuses CPU tensors; other devices raise."""
    scene, _ = tcompile(tscenes.build_scene(4), 8, 8)
    sph, quad = tph.pack_geometry(scene, "cpu")
    rays = torch.from_numpy(ray_pack(scene))
    before = tph.closest_geo_cuda.launches
    tph.closest_geo(rays, sph, quad, T_MIN)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tph.closest_geo_cuda(rays, sph, quad, T_MIN)
    with pytest.raises(ValueError, match="no closest_geo"):
        tph.closest_geo(rays.to("meta"), sph, quad, T_MIN)
    assert tph.closest_geo_cuda.launches == before
