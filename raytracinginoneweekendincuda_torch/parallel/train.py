"""Differentiable rendering: the single-device mega2 train step.

Port of ``make_train_step_mega2`` of
``raytracinginoneweekendincuda_tpu/parallel/train.py`` for one device, with
``torch.optim`` in place of optax.  Parameters are a plain dict of leaf
tensors (the scene's float leaves in `DIFF_SCENE_FIELDS`, plus ``camera``
as a ``CameraParams`` of tensors); `merge_params` overlays them on a scene
whose other leaves stay numpy.

One step runs in two phases, as the JAX step does:

1. the tape: the mega2 tables are packed on the host from the detached
   parameters, and the trace (kernel K2 on the card) records the winners
   of every (pixel, sample) lane in one launch, in the trace's own row
   space;
2. the gradient: `replay.replay_table` (the merged table, permuted into
   kernel row order), then per sample the camera rays (``generate_rays``
   on the camera tensors) and the replay (K3 forward, K4 backward on the
   card), the MSE loss in linear radiance over ``3 * B``, ``backward()``
   and the optimizer step.

The sharded step of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.camera import CameraParams
from ..ops.mega2 import (
    frame_params, mega2_kernel_id_space, mega2_tapes, pack_mega2_tables,
)
from ..ops.raygen import generate_rays
from ..ops.replay import replay_table
from ..ops.render import resolve_device
from ..ops.replay_cuda import replay
from ..scene.compiler import SceneArrays, SceneMeta
from ..utils.config import RenderConfig

# Float leaves a user can optimize (the JAX package's list).
DIFF_SCENE_FIELDS = (
    "sph_c0", "sph_dc", "sph_rad",        # sphere geometry
    "quad_q", "quad_u", "quad_v",         # quad frames
    "mat_fuzz", "mat_ior",                # material scalars
    "tex_c0", "tex_c1",                   # albedo / emission colors
)


def _leaf(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device,
                        requires_grad=True)


def params_from_numpy(arrays: dict, device="cuda") -> dict:
    """Parameters from numpy arrays: ``arrays`` maps each name of
    `DIFF_SCENE_FIELDS` to an array and ``"camera"`` to a
    ``CameraParams``-shaped tuple of arrays (the JAX package's
    ``split_params`` output, converted with ``np.asarray``).  Returns f32
    leaf tensors on ``device`` (the card unless the caller asks for the
    CPU) that require grad."""
    device = resolve_device(device)
    params = {f: _leaf(arrays[f], device) for f in DIFF_SCENE_FIELDS}
    params["camera"] = CameraParams(*[_leaf(x, device)
                                      for x in arrays["camera"]])
    return params


def split_params(scene: SceneArrays, device="cuda") -> dict:
    """scene -> parameter dict (the differentiable leaves, camera
    included), as fresh leaf tensors on ``device``."""
    arrays = {f: getattr(scene, f) for f in DIFF_SCENE_FIELDS}
    arrays["camera"] = scene.camera
    return params_from_numpy(arrays, device)


def params_to_numpy(params: dict) -> dict:
    """Detached numpy copy of a parameter dict (same structure)."""
    out = {f: params[f].detach().cpu().numpy() for f in DIFF_SCENE_FIELDS}
    out["camera"] = CameraParams(*[x.detach().cpu().numpy()
                                   for x in params["camera"]])
    return out


def merge_params(scene: SceneArrays, params: dict) -> SceneArrays:
    """``scene`` with the parameter leaves substituted."""
    kw = {f: params[f] for f in DIFF_SCENE_FIELDS}
    return scene._replace(camera=params["camera"], **kw)


def parameter_list(params: dict) -> list:
    """The leaf tensors of a parameter dict, in a fixed order."""
    return [params[f] for f in DIFF_SCENE_FIELDS] + list(params["camera"])


class TrainState(NamedTuple):
    params: dict
    optimizer: torch.optim.Optimizer
    step: int


def init_state(scene: SceneArrays, make_optimizer: Callable,
               device="cuda", params: dict | None = None) -> TrainState:
    """Fresh parameters of ``scene`` on ``device`` (or the given
    ``params``, on their own device) and the optimizer
    ``make_optimizer(parameter_list)`` over them, e.g.
    ``lambda ps: torch.optim.Adam(ps, lr=0.05)``."""
    if params is None:
        params = split_params(scene, device)
    return TrainState(params, make_optimizer(parameter_list(params)), 0)


def make_train_step_mega2(scene: SceneArrays, meta: SceneMeta,
                          cfg: RenderConfig):
    """The two-phase train step for one device (see the module notes).

    Returns ``step(state, pix, target, mark=None) -> (state, loss)``:
    ``pix`` [B] pixel ids (any order), ``target`` [B, 3] linear radiance on
    the parameters' device.  The device is the parameters'.  ``mark``, if
    given, is called with "pack", "trace", "forward", "backward" and
    "update" as each phase ends (the step's callers time phases with it),
    and inside the forward with "derive" once (the replay table) and
    "raygen" and "replay" once a sample (the camera rays; K3 and the
    sum), so that the forward's last part, "forward", is the loss.
    """
    spp = cfg.samples_per_pixel
    W, H = cfg.width, cfg.height
    no_mark = lambda _name: None

    def step(state: TrainState, pix, target: torch.Tensor, mark=None):
        mark = mark or no_mark
        params = state.params
        dev = params["tex_c0"].device
        # phase 1: winner tapes from the detached parameters (kernel rows)
        sc_np = merge_params(scene, params_to_numpy(params))
        tab = pack_mega2_tables(sc_np, meta, dev)
        t_min = frame_params(sc_np, cfg).t_min
        mark("pack")
        tapes = mega2_tapes(sc_np, meta, pix, spp, width=W, height=H,
                            max_bounces=cfg.max_bounces, t_min=cfg.t_min,
                            seed=cfg.seed, id_space="kernel", device=dev,
                            tab=tab)                     # [spp, K, B]
        pix = torch.as_tensor(np.asarray(pix, np.int32), device=dev)
        B = pix.shape[0]
        mark("trace")

        # phase 2: the loss through the replay, its gradient, the update
        state.optimizer.zero_grad(set_to_none=True)
        sc = merge_params(scene, params)
        tt = replay_table(sc, meta, tab,
                          kernel_space=mega2_kernel_id_space(tab, meta))
        img = torch.zeros((B, 3), dtype=torch.float32, device=dev)
        mark("derive")
        for s in range(spp):
            o, d, tm, pc = generate_rays(sc.camera, pix, s, W, H, cfg.seed)
            rays = torch.cat([o, d, tm[:, None]], dim=1)
            mark("raygen")
            img = img + replay(tt, rays, tapes[s], pc, s,
                               sc.camera.background, t_min=t_min)
            mark("replay")
        diff = img / spp - target
        loss = (diff * diff).sum() / (3.0 * B)
        mark("forward")
        loss.backward()
        mark("backward")
        state.optimizer.step()
        mark("update")
        return TrainState(params, state.optimizer, state.step + 1), \
            loss.detach()

    return step
