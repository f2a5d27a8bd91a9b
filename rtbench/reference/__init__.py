"""The benchmark's plain reference: a path tracer for sphere worlds in
plain PyTorch, written against the published algorithm of *Ray Tracing in
One Weekend* (kernel.cu of the reference CUDA repository) in the op order
of the port's plain K1 version, so that it can be held to the port's
frames path by path.

It imports nothing of either package of the repository and takes nothing
that the program made: it builds its own scenes (`scenes/`), camera,
counter RNG and sphere tables from the same published settings.  Those
files began as copies taken at port commit
f5f430408f621517b545c0351449e6c34668eb84 (the scene builders of
``models/scenes.py``, the camera of ``core/camera.py``, the pcg4d hash of
``core/rng.py`` and the sphere subset of ``ops/mega2.py``'s plain
bounce).  `bvh.py` builds and walks the reference CUDA repository's own
BVH to count its work, the yardstick of K1's roofline.  All of it is part
of the yardstick: only a change to the benchmark edits it.
"""
