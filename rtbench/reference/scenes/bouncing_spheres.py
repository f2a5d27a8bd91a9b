"""The reference's scene 0 (kernel.cu:199-258): Book 1's final scene with
the small lambertian spheres moving up over the shutter [0, 1] and a
checker ground, defocus camera, vfov 30."""

from __future__ import annotations

import numpy as np

from ..world import (
    DIELECTRIC, LAMBERTIAN, METAL, Camera, Checker, Sphere, World,
)

CHECKER = Checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))   # kernel.cu:203


def world(seed: int = 1984) -> World:
    rs = np.random.default_rng(seed)
    rnd = lambda: float(rs.random())
    spheres = [Sphere((0.0, -1000.0, -1.0), 1000.0, LAMBERTIAN,
                      checker=CHECKER)]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rnd()
            center = np.array([a + 0.9 * rnd(), 0.2, b + 0.9 * rnd()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                c2 = center + np.array([0.0, 0.5 * rnd(), 0.0])
                albedo = (rnd() * rnd(), rnd() * rnd(), rnd() * rnd())
                spheres.append(Sphere(tuple(center), 0.2, LAMBERTIAN,
                                      albedo=albedo, center2=tuple(c2)))
            elif choose < 0.95:
                albedo = (0.5 * (1 + rnd()), 0.5 * (1 + rnd()),
                          0.5 * (1 + rnd()))
                spheres.append(Sphere(tuple(center), 0.2, METAL,
                                      albedo=albedo, fuzz=0.5 * rnd()))
            else:
                spheres.append(Sphere(tuple(center), 0.2, DIELECTRIC,
                                      ior=1.5))
    spheres += [
        Sphere((0.0, 1.0, 0.0), 1.0, DIELECTRIC, ior=1.5),
        Sphere((-4.0, 1.0, 0.0), 1.0, LAMBERTIAN, albedo=(0.4, 0.2, 0.1)),
        Sphere((4.0, 1.0, 0.0), 1.0, METAL, albedo=(0.7, 0.6, 0.5),
               fuzz=0.0),
    ]
    camera = Camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=30.0,
                    aperture=0.1, focus_dist=10.0, time0=0.0, time1=1.0)
    return World(spheres, camera)
