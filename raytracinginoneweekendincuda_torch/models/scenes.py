"""The ten reference scenes (kernel.cu:199-517), built on the declarative API.

Scene ids match the reference's `sceneId` switch (kernel.cu:578-589):

  0 bouncing_spheres   1 checkered_spheres   2 earth          3 perlin_spheres
  4 quads              5 simple_light        6 cornell_box    7 cornell_box_boxes
  8 cornell_smoke      9 final_scene

Randomized layouts (scenes 0 and 9) follow the reference's construction
*order and distributions* (kernel.cu:211-258, 443-508) with a host RNG —
per-draw parity with the device curand stream is neither feasible nor needed
(the reference's own layout already differs from the book's for the same
reason).

The port's own copy of ``raytracinginoneweekendincuda_tpu/models/scenes.py`` (same
arithmetic; only the package it lives in differs), plus ``sphere_field``, a
synthetic world of 10,000 spheres on which the card's tests hold the render
kernels to their plain versions.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import Camera
from ..core.image import default_asset, load_texture_image
from ..scene.api import (
    Box,
    CheckerTexture,
    ConstantMedium,
    Dielectric,
    DiffuseLight,
    Group,
    ImageTexture,
    Lambertian,
    Metal,
    NoiseTexture,
    Quad,
    RotateY,
    SceneDesc,
    SolidColor,
    Sphere,
    Translate,
)

SCENE_NAMES = {
    0: "bouncing_spheres",
    1: "checkered_spheres",
    2: "earth",
    3: "perlin_spheres",
    4: "quads",
    5: "simple_light",
    6: "cornell_box",
    7: "cornell_box_boxes",
    8: "cornell_smoke",
    9: "final_scene",
}

BLACK = (0.0, 0.0, 0.0)
SKY = (0.70, 0.80, 1.00)  # kernel.cu:197


def _checker():
    # kernel.cu:203-206
    return CheckerTexture(0.32, SolidColor((0.2, 0.3, 0.1)), SolidColor((0.9, 0.9, 0.9)))


def bouncing_spheres(seed: int = 1984) -> SceneDesc:
    """Book-1 final scene + motion blur + checker ground (kernel.cu:199-258)."""
    rs = np.random.default_rng(seed)
    rnd = lambda: float(rs.random())
    desc = SceneDesc()
    desc.add(Sphere((0.0, -1000.0, -1.0), 1000.0, Lambertian(_checker())))
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rnd()
            center = np.array([a + 0.9 * rnd(), 0.2, b + 0.9 * rnd()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                c2 = center + np.array([0.0, 0.5 * rnd(), 0.0])
                albedo = (rnd() * rnd(), rnd() * rnd(), rnd() * rnd())
                desc.add(Sphere(tuple(center), 0.2, Lambertian(albedo), center2=tuple(c2)))
            elif choose < 0.95:
                albedo = (0.5 * (1 + rnd()), 0.5 * (1 + rnd()), 0.5 * (1 + rnd()))
                desc.add(Sphere(tuple(center), 0.2, Metal(albedo, 0.5 * rnd())))
            else:
                desc.add(Sphere(tuple(center), 0.2, Dielectric(1.5)))
    desc.add(
        Sphere((0.0, 1.0, 0.0), 1.0, Dielectric(1.5)),
        Sphere((-4.0, 1.0, 0.0), 1.0, Lambertian((0.4, 0.2, 0.1))),
        Sphere((4.0, 1.0, 0.0), 1.0, Metal((0.7, 0.6, 0.5), 0.0)),
    )
    desc.camera = Camera(
        lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=30.0, aperture=0.1,
        focus_dist=10.0, time0=0.0, time1=1.0, background=SKY,
    )
    return desc


def checkered_spheres() -> SceneDesc:
    """Two big checker spheres sharing one texture (kernel.cu:259-274)."""
    mat = Lambertian(_checker())
    desc = SceneDesc()
    desc.add(Sphere((0, -10, 0), 10.0, mat), Sphere((0, 10, 0), 10.0, mat))
    desc.camera = Camera(lookfrom=(13, 2, 3), vfov=20.0, background=SKY)
    return desc


def earth(image_path: str | None = None) -> SceneDesc:
    """Image-textured globe (kernel.cu:275-286)."""
    img = load_texture_image(image_path or default_asset("earthmap.jpg"))
    desc = SceneDesc()
    desc.add(Sphere((0, 0, 0), 2.0, Lambertian(ImageTexture(img))))
    desc.camera = Camera(lookfrom=(0, 0, 12), vfov=20.0, background=SKY)
    return desc


def perlin_spheres() -> SceneDesc:
    """Marble ground + marble ball, shared noise texture (kernel.cu:287-299)."""
    pertext = NoiseTexture(4.0, table_seed=0)
    mat = Lambertian(pertext)
    desc = SceneDesc()
    desc.add(Sphere((0, -1000, 0), 1000.0, mat), Sphere((0, 2, 0), 2.0, mat))
    desc.camera = Camera(lookfrom=(13, 2, 3), vfov=20.0, background=SKY)
    return desc


def quads() -> SceneDesc:
    """Five colored parallelograms (kernel.cu:300-320)."""
    desc = SceneDesc()
    desc.add(
        Quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), Lambertian((1.0, 0.2, 0.2))),
        Quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), Lambertian((0.2, 1.0, 0.2))),
        Quad((3, -2, 1), (0, 0, 4), (0, 4, 0), Lambertian((0.2, 0.2, 1.0))),
        Quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), Lambertian((1.0, 0.5, 0.0))),
        Quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), Lambertian((0.2, 0.8, 0.8))),
    )
    desc.camera = Camera(lookfrom=(0, 0, 9), vfov=80.0, background=SKY)
    return desc


def simple_light() -> SceneDesc:
    """Marble spheres lit by quad + sphere emitters, black sky
    (kernel.cu:321-340)."""
    pertext = NoiseTexture(4.0, table_seed=0)
    mat = Lambertian(pertext)
    light = DiffuseLight((4.0, 4.0, 4.0))
    desc = SceneDesc()
    desc.add(
        Sphere((0, -1000, 0), 1000.0, mat),
        Sphere((0, 2, 0), 2.0, mat),
        Sphere((0, 7, 0), 2.0, light),
        Quad((3, 1, -2), (2, 0, 0), (0, 2, 0), light),
    )
    desc.camera = Camera(
        lookfrom=(26, 3, 6), lookat=(0, 2, 0), vfov=20.0, background=BLACK
    )
    return desc


def _cornell_walls(light_q, light_u, light_v, light_color):
    red = Lambertian((0.65, 0.05, 0.05))
    white = Lambertian((0.73, 0.73, 0.73))
    green = Lambertian((0.12, 0.45, 0.15))
    light = DiffuseLight(light_color)
    walls = [
        Quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green),
        Quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red),
        Quad(light_q, light_u, light_v, light),
    ]
    return walls, white, red, green


def cornell_box() -> SceneDesc:
    """Empty Cornell box (kernel.cu:341-362)."""
    walls, white, _, _ = _cornell_walls((343, 554, 332), (-130, 0, 0), (0, 0, -105), (15.0, 15.0, 15.0))
    desc = SceneDesc()
    desc.add(*walls)
    desc.add(
        Quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white),
        Quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white),
        Quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white),
    )
    desc.camera = Camera(
        lookfrom=(278, 278, -800), lookat=(278, 278, 0), vfov=40.0, background=BLACK
    )
    return desc


def cornell_box_boxes() -> SceneDesc:
    """Cornell box with two rotated/translated boxes (kernel.cu:363-398)."""
    desc = cornell_box()
    white = Lambertian((0.73, 0.73, 0.73))
    desc.add(
        Translate(RotateY(Box((0, 0, 0), (165, 330, 165), white), 15.0), (265, 0, 295)),
        Translate(RotateY(Box((0, 0, 0), (165, 165, 165), white), -18.0), (130, 0, 65)),
    )
    return desc


def cornell_smoke() -> SceneDesc:
    """Two boxes as dark smoke / white fog volumes (kernel.cu:399-435)."""
    walls, white, _, _ = _cornell_walls((113, 554, 127), (330, 0, 0), (0, 0, 305), (7.0, 7.0, 7.0))
    desc = SceneDesc()
    desc.add(*walls)
    desc.add(
        Quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white),
        Quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white),
        Quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white),
    )
    desc.add(
        ConstantMedium(
            Translate(RotateY(Box((0, 0, 0), (165, 330, 165)), 15.0), (265, 0, 295)),
            0.01, (0.0, 0.0, 0.0),
        ),
        ConstantMedium(
            Translate(RotateY(Box((0, 0, 0), (165, 165, 165)), -18.0), (130, 0, 65)),
            0.01, (1.0, 1.0, 1.0),
        ),
    )
    desc.camera = Camera(
        lookfrom=(278, 278, -800), lookat=(278, 278, 0), vfov=40.0, background=BLACK
    )
    return desc


def final_scene(seed: int = 1984, image_path: str | None = None) -> SceneDesc:
    """Everything at once (kernel.cu:436-517, the book's Listing 74)."""
    rs = np.random.default_rng(seed)
    rnd = lambda: float(rs.random())
    desc = SceneDesc()

    # 20x20 ground boxes with random heights in [1, 101)
    ground = Lambertian((0.48, 0.83, 0.53))
    w = 100.0
    for bi in range(20):
        for bj in range(20):
            x0 = -1000.0 + bi * w
            z0 = -1000.0 + bj * w
            desc.add(Box((x0, 0.0, z0), (x0 + w, 1.0 + 100.0 * rnd(), z0 + w), ground))

    desc.add(Quad((123, 554, 147), (300, 0, 0), (0, 0, 265), DiffuseLight((7.0, 7.0, 7.0))))
    desc.add(
        Sphere((400, 400, 200), 50.0, Lambertian((0.7, 0.3, 0.1)), center2=(430, 400, 200))
    )
    desc.add(
        Sphere((260, 150, 45), 50.0, Dielectric(1.5)),
        Sphere((0, 150, 145), 50.0, Metal((0.8, 0.8, 0.9), 1.0)),
    )
    # blue subsurface ball: visible glass shell + interior medium
    desc.add(Sphere((360, 150, 145), 70.0, Dielectric(1.5)))
    desc.add(ConstantMedium(Sphere((360, 150, 145), 70.0, Dielectric(1.5)), 0.2, (0.2, 0.4, 0.9)))
    # planet-wide thin mist
    desc.add(ConstantMedium(Sphere((0, 0, 0), 5000.0, Dielectric(1.5)), 1.0e-4, (1.0, 1.0, 1.0)))

    img = load_texture_image(image_path or default_asset("earthmap.jpg"))
    desc.add(Sphere((400, 200, 400), 100.0, Lambertian(ImageTexture(img))))
    desc.add(Sphere((220, 280, 300), 80.0, Lambertian(NoiseTexture(0.2, table_seed=0))))

    white = Lambertian((0.73, 0.73, 0.73))
    cluster = Group(
        [
            Sphere((165.0 * rnd(), 165.0 * rnd(), 165.0 * rnd()), 10.0, white)
            for _ in range(1000)
        ]
    )
    desc.add(Translate(RotateY(cluster, 15.0), (-100, 270, 395)))

    desc.camera = Camera(
        lookfrom=(478, 278, -600), lookat=(278, 278, 0), vfov=40.0,
        time0=0.0, time1=1.0, background=BLACK,
    )
    return desc


_FACTORIES = {
    0: bouncing_spheres,
    1: checkered_spheres,
    2: earth,
    3: perlin_spheres,
    4: quads,
    5: simple_light,
    6: cornell_box,
    7: cornell_box_boxes,
    8: cornell_smoke,
    9: final_scene,
}


def build_scene(scene_id: int, **kw) -> SceneDesc:
    """Scene factory keyed by the reference's sceneId (kernel.cu:578-589)."""
    return _FACTORIES[scene_id](**kw)


def book1_final(seed: int = 1984) -> SceneDesc:
    """BASELINE.json configs[1]: the Book-1 final scene — ~500 random
    static spheres (Lambertian/Metal/Dielectric), solid diffuse ground,
    defocus camera, vfov 20.  Same placement stream as `bouncing_spheres`
    (the reference's scene 0, kernel.cu:199-258) with Book 1's statics: no
    motion, no checker, no shutter."""
    rs = np.random.default_rng(seed)
    rnd = lambda: float(rs.random())
    desc = SceneDesc()
    desc.add(Sphere((0.0, -1000.0, -1.0), 1000.0, Lambertian((0.5, 0.5, 0.5))))
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rnd()
            center = np.array([a + 0.9 * rnd(), 0.2, b + 0.9 * rnd()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                rnd()  # Book-2's bounce draw, kept so placements match
                albedo = (rnd() * rnd(), rnd() * rnd(), rnd() * rnd())
                desc.add(Sphere(tuple(center), 0.2, Lambertian(albedo)))
            elif choose < 0.95:
                albedo = (0.5 * (1 + rnd()), 0.5 * (1 + rnd()), 0.5 * (1 + rnd()))
                desc.add(Sphere(tuple(center), 0.2, Metal(albedo, 0.5 * rnd())))
            else:
                desc.add(Sphere(tuple(center), 0.2, Dielectric(1.5)))
    desc.add(
        Sphere((0.0, 1.0, 0.0), 1.0, Dielectric(1.5)),
        Sphere((-4.0, 1.0, 0.0), 1.0, Lambertian((0.4, 0.2, 0.1))),
        Sphere((4.0, 1.0, 0.0), 1.0, Metal((0.7, 0.6, 0.5), 0.0)),
    )
    desc.camera = Camera(
        lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=20.0, aperture=0.1,
        focus_dist=10.0, background=SKY,
    )
    return desc


def book1_basic() -> SceneDesc:
    """BASELINE.json configs[0]: Lambertian sphere + ground, gradient sky."""
    desc = SceneDesc()
    desc.add(
        Sphere((0, 0, -1), 0.5, Lambertian((0.5, 0.5, 0.5))),
        Sphere((0, -100.5, -1), 100.0, Lambertian((0.5, 0.5, 0.5))),
    )
    desc.camera = Camera(
        lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=90.0, focus_dist=1.0, background=SKY
    )
    return desc


def sphere_field(n: int = 10_000, seed: int = 1984) -> SceneDesc:
    """The large world: ``n`` small random spheres (Lambertian 80%, metal
    15%, glass 5%, some moving) on a 0.5-unit grid over a ground sphere,
    seen as scene 0 is: a world of far more rows than any reference scene,
    for holding the render kernels to their plain versions at that size."""
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
