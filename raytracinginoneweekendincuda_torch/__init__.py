"""PyTorch + CUDA port of the path tracer ``raytracinginoneweekendincuda_tpu``.

The JAX package beside this one is the reference.  This package imports
its JAX-free host layer (scene description, scene compiler, camera, image
I/O, render config) as it is, so both packages compile a scene to the same
``SceneArrays``; the device code here is plain PyTorch plus hand-written
CUDA kernels for the NVIDIA Hopper card (``csrc/``).

Module names mirror the JAX package (``core/``, ``ops/``, ``utils/``).
This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
