"""PyTorch + CUDA port of the path tracer ``raytracinginoneweekendincuda_tpu``.

The JAX package beside this one is the reference.  This package carries
its own copies of the JAX package's numpy host layer (scene description,
scene compiler, Perlin tables, camera, image I/O, render config), so both
packages compile a scene to the same ``SceneArrays``; the device code here
is plain PyTorch plus hand-written CUDA kernels for the NVIDIA Hopper card
(``csrc/``).

Module names mirror the JAX package (``core/``, ``models/``, ``ops/``,
``parallel/``, ``scene/``, ``utils/``).  This package imports ``torch`` and
never ``jax`` nor anything of ``raytracinginoneweekendincuda_tpu``.
"""

__version__ = "0.1.0"
