"""Primary-ray generation (Camera::GetRay + per-pixel jitter).

Port of ``raytracinginoneweekendincuda_tpu/ops/raygen.py::generate_rays``
in the op order of the mega2 kernel's ``raygen``, which mirrors it step
for step.  Pixel ids are ``j*W + i`` with ``j`` counting up from the
bottom row; the RNG key is ``pix_ctr = uint32(pix) ^ seed``.

The camera is either `camera_tuple` (python floats: the render path) or a
``CameraParams`` of 0-d / [3] f32 tensors (the gradient path: the rays are
then differentiable in every camera leaf).  Both forms run the same ops
in the same order, so they give bit-identical rays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.camera import CameraParams
from ..core.samplers import unit_disk


def camera_tuple(camera) -> tuple:
    """(origin 3, lower_left 3, horizontal 3, vertical 3, u 3, v 3,
    lens_radius, time0, time1) as python floats (the JAX package's
    ``_cam_tuple``)."""
    vals = []
    for name in ("origin", "lower_left", "horizontal", "vertical", "u", "v"):
        vals.extend(float(x) for x in getattr(camera, name))
    for name in ("lens_radius", "time0", "time1"):
        vals.append(float(getattr(camera, name)))
    return tuple(vals)


def pixel_counter(pix: torch.Tensor, seed: int) -> torch.Tensor:
    """``uint32(pix) ^ seed`` as int32 words."""
    return pix.to(torch.int32) ^ rng.to_word(seed)


def _camera_scalars(cam: CameraParams) -> tuple:
    """The 21 `camera_tuple` entries as 0-d tensors of ``cam``'s leaves
    (differentiable), the shutter interval as ``time1 - time0`` in f32."""
    vals = []
    for name in ("origin", "lower_left", "horizontal", "vertical", "u", "v"):
        vals.extend(getattr(cam, name).unbind(0))
    return (*vals, cam.lens_radius, cam.time0, cam.time1 - cam.time0)


def generate_rays(cam, pix: torch.Tensor, sample, width: int,
                  height: int, seed: int):
    """Camera rays for int pixel ids ``pix`` [B] at ``sample`` (int or [B]).

    ``cam`` is `camera_tuple` (f32 rays) or a ``CameraParams`` of 0-d / [3]
    tensors on ``pix``'s device (rays in the camera's dtype, f32 or f64).
    Returns (origin [B,3], direction [B,3], time [B], pix_ctr [B] int32)."""
    dev = pix.device
    if isinstance(cam, CameraParams):
        dtype = cam.origin.dtype
        (c_ox, c_oy, c_oz, llx, lly, llz, hx, hy, hz, vx, vy, vz,
         ux, uy, uz, cvx, cvy, cvz, lens_r, tm0, shutter) = \
            _camera_scalars(cam)
    else:
        dtype = torch.float32
        (c_ox, c_oy, c_oz, llx, lly, llz, hx, hy, hz, vx, vy, vz,
         ux, uy, uz, cvx, cvy, cvz, lens_r, tm0, tm1) = cam
        shutter = float(np.float32(tm1) - np.float32(tm0))
    pix_ctr = pixel_counter(pix, seed)
    ju, jv, l1, l2 = rng.uniform4(pix_ctr, sample, rng.CAMERA_STREAM, 0,
                                  dtype)
    tu = rng.uniform4(pix_ctr, sample, rng.CAMERA_STREAM + 1, 0, dtype)[0]
    pix64 = pix.to(torch.int64)
    i_f = (pix64 % width).to(dtype)
    j_f = (pix64 // width).to(dtype)
    # divide by a device tensor: a python-scalar divisor lets the CUDA
    # kernel multiply by its reciprocal instead
    w_t = torch.tensor(float(width), dtype=dtype, device=dev)
    h_t = torch.tensor(float(height), dtype=dtype, device=dev)
    s = (i_f + ju) / w_t
    t = (j_f + jv) / h_t
    dcos, dsin = unit_disk(l1, l2)
    rd0 = lens_r * dcos
    rd1 = lens_r * dsin
    offx = ux * rd0 + cvx * rd1
    offy = uy * rd0 + cvy * rd1
    offz = uz * rd0 + cvz * rd1
    origin = torch.stack([c_ox + offx, c_oy + offy, c_oz + offz], dim=-1)
    direction = torch.stack([
        llx + s * hx + t * vx - c_ox - offx,
        lly + s * hy + t * vy - c_oy - offy,
        llz + s * hz + t * vz - c_oz - offz,
    ], dim=-1)
    time = tm0 + tu * shutter
    return origin, direction, time, pix_ctr
