"""Texture-gate scenes of ``tests/test_mega2_textures.py`` for the PyTorch
port's tests (not a test module): several images, an image on a quad and
on box faces, and two Perlin tables.  Each builder takes the scene API
module and the camera module of the package that builds it, so a test can
build the same scene through the JAX package and through the port, and the
card's tests can build it where JAX is absent."""

import numpy as np

SKY = (0.70, 0.80, 1.00)


def _bytes(img):
    """Quantize to the byte grid the texel planes store."""
    return np.round(img * 255.0) / 255.0


def _img_a():
    h, w = 12, 20
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x / (w - 1), y / (h - 1), (x + y) / (w + h - 2)], -1)
    return _bytes(np.ascontiguousarray(img))


def _img_b():
    h, w = 9, 14
    y, x = np.mgrid[0:h, 0:w]
    c = ((x // 3 + y // 3) % 2).astype(np.float64)
    return _bytes(np.ascontiguousarray(np.stack([c, 1.0 - c, 0.5 * c], -1)))


def two_images_and_image_on_quad(api, cam):
    desc = api.SceneDesc()
    desc.add(
        api.Sphere((-2.2, 0, 0), 1.0,
                   api.Lambertian(api.ImageTexture(_img_a()))),
        api.Sphere((2.2, 0, 0), 1.0,
                   api.Lambertian(api.ImageTexture(_img_b()))),
        api.Quad((-2, -2, -2), (4, 0, 0), (0, 4, 0),
                 api.Lambertian(api.ImageTexture(_img_a()))),
    )
    desc.camera = cam.Camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0),
                             vfov=40.0, background=SKY)
    return desc


def two_noise_tables(api, cam):
    desc = api.SceneDesc()
    desc.add(
        api.Sphere((0, -1000, 0), 1000.0,
                   api.Lambertian(api.NoiseTexture(4.0, table_seed=0))),
        api.Sphere((0, 2, 0), 2.0,
                   api.Lambertian(api.NoiseTexture(2.0, table_seed=7))),
    )
    desc.camera = cam.Camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                             vfov=20.0, background=SKY)
    return desc


def image_on_box_face(api, cam):
    desc = api.SceneDesc()
    desc.add(
        api.Box((-1, -1, -1), (1, 1, 1),
                api.Lambertian(api.ImageTexture(_img_a()))),
        api.Quad((-3, -3, -3), (6, 0, 0), (0, 0, 6),
                 api.Lambertian((0.5, 0.5, 0.5))),
        api.Sphere((0, 5, 2), 1.0, api.DiffuseLight((4.0, 4.0, 4.0))),
    )
    desc.camera = cam.Camera(lookfrom=(4, 3, 6), lookat=(0, 0, 0),
                             vfov=40.0, background=SKY)
    return desc


SCENES = {
    "two_images_and_image_on_quad": two_images_and_image_on_quad,
    "two_noise_tables": two_noise_tables,
    "image_on_box_face": image_on_box_face,
}
