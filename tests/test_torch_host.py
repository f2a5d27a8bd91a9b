"""The port's own host layer (scene API, compiler, Perlin tables, scenes,
camera, image I/O) against the JAX package's: the same scene must compile
to array-equal ``SceneArrays`` and an equal ``SceneMeta``, and the PPM
writer must write the same bytes."""

import numpy as np
import pytest

import torch_texture_scenes as tex
from raytracinginoneweekendincuda_torch.core import camera as tcam
from raytracinginoneweekendincuda_torch.core import image as timage
from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.scene import api as tapi
from raytracinginoneweekendincuda_torch.scene import compiler as tcomp
from raytracinginoneweekendincuda_tpu.core import camera as jcam
from raytracinginoneweekendincuda_tpu.core import image as jimage
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.scene import api as japi
from raytracinginoneweekendincuda_tpu.scene import compiler as jcomp


def _ramp(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x / (w - 1), y / (h - 1), (x + y) / (w + h - 2)], -1)
    return np.round(img * 255.0) / 255.0


def _by_hand(api, cam):
    """Two images, two Perlin tables and a box medium, built through the
    given package's API."""
    desc = api.SceneDesc()
    desc.add(
        api.Sphere((-2.2, 0, 0), 1.0,
                   api.Lambertian(api.ImageTexture(_ramp(12, 20)))),
        api.Sphere((2.2, 0, 0), 1.0,
                   api.Lambertian(api.ImageTexture(_ramp(9, 14)))),
        api.Sphere((0, -1000, 0), 999.0,
                   api.Lambertian(api.NoiseTexture(4.0, table_seed=0))),
        api.Sphere((0, 2.5, 0), 0.8,
                   api.Lambertian(api.NoiseTexture(2.0, table_seed=7))),
        api.ConstantMedium(api.Box((0.1, -0.5, -2.0), (1.1, 0.5, -1.0),
                                   api.Lambertian((1, 1, 1))),
                           0.7, (0.2, 0.5, 0.9)),
    )
    desc.camera = cam.Camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0),
                             vfov=40.0, background=(0.70, 0.80, 1.00))
    return desc


CASES = [*[("scene", sid) for sid in range(10)], ("book1_final", None),
         ("by_hand", None), *[("texture", n) for n in sorted(tex.SCENES)]]


def _desc(pkg_scenes, api, cam, kind, sid):
    if kind == "scene":
        return pkg_scenes.build_scene(sid)
    if kind == "book1_final":
        return pkg_scenes.book1_final()
    if kind == "texture":
        return tex.SCENES[sid](api, cam)
    return _by_hand(api, cam)


@pytest.mark.parametrize("kind,sid", CASES)
def test_compile_scene_matches_jax(kind, sid):
    jdesc = _desc(jscenes, japi, jcam, kind, sid)
    tdesc = _desc(tscenes, tapi, tcam, kind, sid)
    js, jm = jcomp.compile_scene(jdesc, 24, 12, dtype=np.float32)
    ts, tm = tcomp.compile_scene(tdesc, 24, 12, dtype=np.float32)
    assert type(ts).__module__.startswith("raytracinginoneweekendincuda_torch")
    assert ts._fields == js._fields
    for name in js._fields:
        a, b = getattr(js, name), getattr(ts, name)
        if name == "camera":
            assert b._fields == a._fields
            pairs = [(f"camera.{f}", getattr(a, f), getattr(b, f))
                     for f in a._fields]
        else:
            pairs = [(name, a, b)]
        for label, x, y in pairs:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, label
            np.testing.assert_array_equal(y, x, err_msg=label)
    assert vars(tm) == vars(jm)
    if kind == "by_hand":
        assert tm.n_images == 2 and tm.n_noise == 2 and tm.n_media == 1


def test_write_ppm_bytes_match(tmp_path):
    rs = np.random.default_rng(7)
    img = rs.uniform(-0.1, 1.1, (5, 7, 3)).astype(np.float32)
    jp, tp = tmp_path / "j.ppm", tmp_path / "t.ppm"
    jimage.write_ppm(str(jp), img)
    timage.write_ppm(str(tp), img)
    assert tp.read_bytes() == jp.read_bytes()


def test_default_asset_is_the_repo_asset():
    assert timage.default_asset("earthmap.jpg") == \
        jimage.default_asset("earthmap.jpg")
