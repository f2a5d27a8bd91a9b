"""The benchmark's plain reference for Book 2 worlds (*Ray Tracing: The
Next Week*, kernel.cu:436-517 of the reference CUDA repository): quads,
boxes (MakeBox), moving spheres, instances, constant media, image and
Perlin textures, and diffuse lights, traced in plain PyTorch in the op
order of the port's plain K1 version, so that it can be held to the
port's frames path by path.

It imports nothing of either package of the repository and takes nothing
that the program made: it builds its worlds from the published scenes
(`world.py`, `../scenes/`), decodes the earth image itself, and keeps its
own copy of the Perlin table generator.  It reuses the Book 1 reference's
camera (`../world.py::Camera`, `../tracer.py::camera_rays`, `to_u8`) and
counter RNG (`../rng.py`).  Copies taken at port commit
9ffa69c3c03932ed590ed26d5f5b18b188be7409: the Perlin table generator of
``scene/perlin.py``, the instance folding of ``scene/compiler.py`` and the
op order of ``ops/mega2.py``'s plain bounce (``_closest_quads``,
``_closest_boxes``, ``_media``, ``_perlin_*``, ``_image_tex``,
``_scatter``).  `bvh.py` builds and walks the reference CUDA repository's
own BVH over the world's top-level hittables to count its work, the
yardstick of K1's roofline on these worlds (`roofline/k1_world.py`).  All
of it is part of the yardstick: only a change to the benchmark edits it.
"""
