"""``sphere_field`` built through the JAX package's scene API (not a test
module).

The JAX package has no such scene and stays as it is, so this helper
repeats the code of ``raytracinginoneweekendincuda_torch/models/scenes.py::
sphere_field`` over the JAX package's classes; the tests first check that
both packages compile it to equal arrays.
"""

import numpy as np

from raytracinginoneweekendincuda_tpu.core.camera import Camera
from raytracinginoneweekendincuda_tpu.models.scenes import SKY
from raytracinginoneweekendincuda_tpu.scene.api import (
    Dielectric, Lambertian, Metal, SceneDesc, Sphere,
)


def jax_sphere_field(n: int = 10_000, seed: int = 1984) -> SceneDesc:
    rs = np.random.default_rng(seed)
    desc = SceneDesc()
    desc.add(Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian((0.5, 0.5, 0.5))))
    side = int(np.ceil(np.sqrt(n)))
    for k in range(n):
        c = (0.5 * (k % side - side / 2) + 0.3 * rs.random(), 0.15,
             0.5 * (k // side - side / 2) + 0.3 * rs.random())
        u = rs.random()
        if u < 0.8:
            mat = Lambertian(tuple(rs.random(3) * rs.random(3)))
        elif u < 0.95:
            mat = Metal(tuple(0.5 + 0.5 * rs.random(3)), 0.5 * rs.random())
        else:
            mat = Dielectric(1.5)
        c2 = (c[0], c[1] + 0.2 * rs.random(), c[2]) if u < 0.3 else None
        desc.add(Sphere(c, 0.15, mat, center2=c2))
    desc.camera = Camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=30.0,
                         aperture=0.1, focus_dist=10.0, time0=0.0,
                         time1=1.0, background=SKY)
    return desc


def assert_compiled_equal(js, jm, ts, tm) -> None:
    """The two packages' compiled scenes: array-equal arrays (camera field
    by field) and equal metadata."""
    assert ts._fields == js._fields
    for name in js._fields:
        a, b = getattr(js, name), getattr(ts, name)
        pairs = ([(f"camera.{f}", getattr(a, f), getattr(b, f))
                  for f in a._fields] if name == "camera"
                 else [(name, a, b)])
        for label, x, y in pairs:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, label
            np.testing.assert_array_equal(y, x, err_msg=label)
    assert vars(tm) == vars(jm)


def compiled_fields(n: int, w: int, h: int):
    """``sphere_field(n)`` compiled by both packages at w x h, checked
    equal: (JAX scene, JAX meta, port scene, port meta)."""
    from raytracinginoneweekendincuda_torch.models import scenes
    from raytracinginoneweekendincuda_torch.scene.compiler import (
        compile_scene as tcompile,
    )
    from raytracinginoneweekendincuda_tpu.scene.compiler import (
        compile_scene as jcompile,
    )

    js, jm = jcompile(jax_sphere_field(n), w, h, dtype=np.float32)
    ts, tm = tcompile(scenes.sphere_field(n), w, h, dtype=np.float32)
    assert_compiled_equal(js, jm, ts, tm)
    return js, jm, ts, tm


# A rounding hit of the f32 sphere test, and the cull that skips it.  The
# ray is a path's state deep inside the large world's 1000-unit ground
# sphere (``sphere_field()`` at 1440x720@10, pixel 619850, sample 7,
# before bounce 5): origin, direction, time.  Its f32 quadratic against
# the small sphere ROUNDING_SPHERE cancels |oc|^2 ~ 3.2e6 against b^2 and
# reports a hit at t 1558.73, before the ground at 1558.97, though in f64
# the ray passes 0.209 from the centre, outside the radius 0.15.  Without
# the cull that sphere wins; with it, its chunk's box, which the ray does
# not meet before the ground, is skipped and the ground wins.
ROUNDING_RAY = np.array([-596.0383, -1643.3672, 480.4342, 0.3751682,
                         1.0540242, -0.2984054, 0.31353772], np.float32)
ROUNDING_SPHERE = tuple(float(np.float32(x))
                        for x in (-11.210961342, 0.150000006, 15.005868912))


def rounding_world(api, camera_cls):
    """The ground, 63 small spheres far from the ray, and ROUNDING_SPHERE
    last (scene sphere 64), so that it is alone in the second 64-row chunk
    (the ground sorts first, then Morton order puts it after the others)."""
    desc = api.SceneDesc()
    grey = api.Lambertian((0.5, 0.5, 0.5))
    desc.add(api.Sphere((0.0, -1000.0, 0.0), 1000.0, grey))
    for i in range(63):
        desc.add(api.Sphere((i - 31.0, 0.15, -100.0), 0.15, grey))
    desc.add(api.Sphere(ROUNDING_SPHERE, 0.15, grey))
    desc.camera = camera_cls(lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                             vfov=30.0, time0=0.0, time1=1.0)
    return desc


def jax_rounding_winner() -> int:
    """The scene id that the JAX package's mega2 trace kernel (Pallas
    interpret mode, one bounce) records for ROUNDING_RAY in
    ``rounding_world``; its cull follows MEGA2_DENSE_MAX and
    MEGA2_CULL_MIN_CHUNKS, read when the package is imported."""
    import jax.numpy as jnp

    from raytracinginoneweekendincuda_tpu.ops import mega2 as jm2
    from raytracinginoneweekendincuda_tpu.scene import api as japi
    from raytracinginoneweekendincuda_tpu.scene.compiler import (
        compile_scene as jcompile,
    )

    scene, meta = jcompile(rounding_world(japi, Camera), 8, 4,
                           dtype=np.float32)
    (sph, quad, attr, coef, cull_s, cull_q, perm, vec, img, img_key,
     mu_key, med, remap) = jm2.mega2_tables(scene, meta)
    N = jm2.TILE_RAYS
    rays = np.zeros((7, N), np.float32)
    rays[5] = 1.0                    # padding lanes: a unit-z direction
    rays[:, 0] = ROUNDING_RAY
    pix = np.full((1, N), -1, np.int32)
    pix[0, 0] = 0
    tape = jm2._trace_span_impl(
        jnp.asarray(pix), jnp.zeros((2, N), jnp.float32), sph, quad, attr,
        coef, cull_s, cull_q, perm, vec, img, remap,
        jnp.zeros((1, N), jnp.int32), meta=meta,
        med_key=tuple(tuple(float(x) for x in row) for row in med),
        cam_key=jm2._cam_tuple(scene.camera), img_key=img_key,
        mu_key=mu_key, width=8, height=4, seed=1984, max_bounces=1,
        t_min=float(np.float32(1e-3)),
        background=tuple(float(x) for x in
                         np.asarray(scene.camera.background)),
        interpret=True, rays=jnp.asarray(rays))
    return int(np.asarray(tape)[0, 0])
