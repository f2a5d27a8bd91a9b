"""The host layer this port shares with the JAX package, re-exported.

These modules of ``raytracinginoneweekendincuda_tpu`` are numpy-only and
import no JAX: the scene description API, the scene compiler, the ten
reference scenes, the camera, image I/O and the render config.  The port
uses them as they are, so both packages compile a scene to the same
``SceneArrays``.  Import them from here.
"""

from raytracinginoneweekendincuda_tpu.core.image import (  # noqa: F401
    default_asset, load_texture_image, write_png, write_ppm,
)
from raytracinginoneweekendincuda_tpu.core.rng import (  # noqa: F401
    CAMERA_STREAM, MEDIUM_STREAM, SCATTER_STREAM,
)
from raytracinginoneweekendincuda_tpu.core.rng import (  # noqa: F401
    pcg4d as pcg4d_numpy,
)
from raytracinginoneweekendincuda_tpu.models.scenes import (  # noqa: F401
    SCENE_NAMES, build_scene,
)
from raytracinginoneweekendincuda_tpu.scene import api  # noqa: F401
from raytracinginoneweekendincuda_tpu.scene.compiler import (  # noqa: F401
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_METAL, MED_BOX, TEX_CHECKER, TEX_IMAGE, TEX_NOISE, SceneArrays,
    SceneMeta, compile_scene,
)
from raytracinginoneweekendincuda_tpu.utils.config import (  # noqa: F401
    RenderConfig, reference_samples_for_scene,
)
