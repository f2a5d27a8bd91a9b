"""The reference's scene 9, Book 2's final scene (kernel.cu:436-517, the
book's final listing): 400 ground boxes of random heights, a quad light
under a black sky, a moving sphere, a glass and a fuzzy metal sphere, a
glass ball holding a dense blue medium (its boundary a second sphere, as
kernel.cu:472-478 duplicates it), a planet-wide mist, the earth, a Perlin
marble sphere and 1,000 white spheres under RotateY(15) and Translate.

The random draws (the boxes' heights, then the cluster's centres) come
from numpy's default_rng(1984) in the order the reference draws them from
curand; the earth image is ``assets/earthmap.jpg`` of the checkout."""

from __future__ import annotations

import os

import numpy as np

from ..book2.world import (
    ASSETS, Box, Instance, Medium, Noise, Quad, Sphere, World, dielectric,
    diffuse_light, lambertian, load_image, metal,
)
from ..world import Camera

EARTH = os.path.join(ASSETS, "earthmap.jpg")


def world(seed: int = 1984, image_path: str | None = None) -> World:
    rs = np.random.default_rng(seed)
    rnd = lambda: float(rs.random())
    hittables = []
    ground = lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            x0, z0 = -1000.0 + i * 100.0, -1000.0 + j * 100.0
            hittables.append(Box((x0, 0.0, z0),
                                 (x0 + 100.0, 1.0 + 100.0 * rnd(),
                                  z0 + 100.0), ground))
    hittables.append(Quad((123.0, 554.0, 147.0), (300.0, 0.0, 0.0),
                          (0.0, 0.0, 265.0), diffuse_light((7.0, 7.0, 7.0))))
    hittables += [
        Sphere((400.0, 400.0, 200.0), 50.0, lambertian((0.7, 0.3, 0.1)),
               center2=(430.0, 400.0, 200.0)),
        Sphere((260.0, 150.0, 45.0), 50.0, dielectric(1.5)),
        Sphere((0.0, 150.0, 145.0), 50.0, metal((0.8, 0.8, 0.9), 1.0)),
        Sphere((360.0, 150.0, 145.0), 70.0, dielectric(1.5)),
        Medium(Sphere((360.0, 150.0, 145.0), 70.0, dielectric(1.5)), 0.2,
               (0.2, 0.4, 0.9)),
        Medium(Sphere((0.0, 0.0, 0.0), 5000.0, dielectric(1.5)), 1.0e-4,
               (1.0, 1.0, 1.0)),
        Sphere((400.0, 200.0, 400.0), 100.0,
               lambertian(load_image(image_path or EARTH))),
        Sphere((220.0, 280.0, 300.0), 80.0, lambertian(Noise(0.2, 0))),
    ]
    white = lambertian((0.73, 0.73, 0.73))
    cluster = tuple(Sphere((165.0 * rnd(), 165.0 * rnd(), 165.0 * rnd()),
                           10.0, white) for _ in range(1000))
    hittables.append(Instance(cluster, 15.0, (-100.0, 270.0, 395.0)))
    camera = Camera(lookfrom=(478.0, 278.0, -600.0),
                    lookat=(278.0, 278.0, 0.0), vfov=40.0, aperture=0.0,
                    focus_dist=10.0, time0=0.0, time1=1.0,
                    background=(0.0, 0.0, 0.0))
    return World(hittables, camera)
