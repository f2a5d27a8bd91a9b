"""Book 1's final scene: 484 static spheres (lambertian, metal,
dielectric) on a grey ground, defocus camera, vfov 20.  The placement
stream of the reference's scene 0 (kernel.cu:199-258) with Book 1's
statics: no motion, no checker, no shutter."""

from __future__ import annotations

import numpy as np

from ..world import DIELECTRIC, LAMBERTIAN, METAL, Camera, Sphere, World


def world(seed: int = 1984) -> World:
    rs = np.random.default_rng(seed)
    rnd = lambda: float(rs.random())
    spheres = [Sphere((0.0, -1000.0, -1.0), 1000.0, LAMBERTIAN,
                      albedo=(0.5, 0.5, 0.5))]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rnd()
            center = np.array([a + 0.9 * rnd(), 0.2, b + 0.9 * rnd()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                rnd()       # the moving scene's bounce draw, kept
                albedo = (rnd() * rnd(), rnd() * rnd(), rnd() * rnd())
                spheres.append(Sphere(tuple(center), 0.2, LAMBERTIAN,
                                      albedo=albedo))
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
    camera = Camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=20.0,
                    aperture=0.1, focus_dist=10.0)
    return World(spheres, camera)
