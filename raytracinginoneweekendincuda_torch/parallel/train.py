"""Differentiable rendering: the single-device train steps.

Port of ``raytracinginoneweekendincuda_tpu/parallel/train.py`` for one
device, with ``torch.optim`` in place of optax.  Parameters are a plain
dict of leaf tensors (the scene's float leaves in `DIFF_SCENE_FIELDS`,
plus ``camera`` as a ``CameraParams`` of tensors); `merge_params` overlays
them on a scene.  Two steps, each the MSE in linear radiance over
``3 * B``, ``backward()`` and the optimizer step:

* `make_train_step`, the general step (JAX ``make_train_step``): per
  sample the camera rays and the differentiable trace of the XLA path, in
  the scene's dtype: engine ``taped`` (``ops/replay.py``: the winner tape
  of the search without gradients, then the replay) or ``scan``
  (``ops/integrator.trace(differentiable=True)``: the search itself under
  per-bounce checkpoints, the gradient oracle).  Any ``hit_fn`` of the
  integrator plugs in here.  Its mesh form (JAX's ``shard_map`` over
  pixels and samples) is not ported yet (``ROADMAP.md`` queue 1 item 4).
* `make_train_step_mega2`, the mega2 step (JAX ``make_train_step_mega2``),
  f32, in two phases as the JAX step:

  1. the tape: the mega2 tables are packed on the host from the detached
     parameters, and the trace (kernel K2 on the card) records the
     winners of every (pixel, sample) lane in one launch, in the trace's
     own row space;
  2. the gradient: `replay.replay_table` (the merged table, permuted into
     kernel row order), then per sample the camera rays (``generate_rays``
     on the camera tensors) and the replay (K3 forward, K4 backward on the
     card).

The sharded steps of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.camera import CameraParams
from ..ops import replay_cuda
from ..ops.hit import scene_tensors
from ..ops.integrator import trace
from ..ops.mega2 import (
    frame_params, mega2_kernel_id_space, mega2_tapes, pack_mega2_tables,
)
from ..ops.raygen import generate_rays
from ..ops.replay import generate_tape, replay, replay_table
from ..ops.render import resolve_device
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
    """A fresh leaf that requires grad: f64 stays f64 (the f64 scenes of
    the XLA step), any other float becomes f32."""
    a = np.asarray(x)
    a = a.astype(np.float64 if a.dtype == np.float64 else np.float32)
    return torch.tensor(a, device=device, requires_grad=True)


def params_from_numpy(arrays: dict, device="cuda") -> dict:
    """Parameters from numpy arrays: ``arrays`` maps each name of
    `DIFF_SCENE_FIELDS` to an array and ``"camera"`` to a
    ``CameraParams``-shaped tuple of arrays (the JAX package's
    ``split_params`` output, converted with ``np.asarray``).  Returns leaf
    tensors on ``device`` (the card unless the caller asks for the CPU)
    that require grad, f64 where the array is f64, else f32."""
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


ENGINES = ("auto", "taped", "scan")


def make_train_step(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                    engine: str = "auto"):
    """The general train step for one device (see the module notes).

    Returns ``step(state, scene_rest, pix, target, mark=None) -> (state,
    loss)``: ``scene_rest`` a scene (numpy leaves; `merge_params`
    overlays the parameters on it, typically ``scene`` itself), ``pix``
    [B] pixel ids, ``target`` [B, 3] linear radiance on the parameters'
    device, where the step runs.  ``engine``: ``taped`` (the default of
    ``auto``) or ``scan``; anything else raises ``ValueError``.  ``mark``,
    if given, is called with "tape" (the camera rays and the tapes of all
    samples; taped only), "forward" (the traces and the loss), "backward"
    and "update" as each phase ends.

    The step repeats bit for bit on the card, as the JAX step does: its
    gradient sums the winner rows' lanes with `hit.read_rows`, whose
    backward adds in an order fixed by the data (``index_select``'s own
    backward, ``index_add_``, adds with atomics in a different order on
    each run, and Adam amplifies that over many steps)."""
    del scene                # the JAX signature's; the step reads scene_rest
    if engine not in ENGINES:
        raise ValueError(f"unknown differentiable engine: {engine!r}")
    taped = engine != "scan"
    spp = cfg.samples_per_pixel
    W, H = cfg.width, cfg.height
    kw = dict(max_bounces=cfg.max_bounces, t_min=cfg.t_min)
    no_mark = lambda _name: None

    def step(state: TrainState, scene_rest: SceneArrays, pix, target,
             mark=None):
        mark = mark or no_mark
        params = state.params
        dev = params["tex_c0"].device
        state.optimizer.zero_grad(set_to_none=True)
        sc = merge_params(scene_tensors(scene_rest, dev), params)
        pix = torch.as_tensor(np.asarray(pix, np.int32), device=dev)
        B = pix.shape[0]
        rays = [generate_rays(sc.camera, pix, s, W, H, cfg.seed)
                for s in range(spp)]
        if taped:
            with torch.no_grad():    # integer tapes: no graph of the search
                tapes = [generate_tape(sc, meta, o.detach(), d.detach(),
                                       tm.detach(), pc, s, **kw)[0]
                         for s, (o, d, tm, pc) in enumerate(rays)]
            mark("tape")
        acc = torch.zeros((B, 3), dtype=sc.camera.origin.dtype, device=dev)
        for s, (o, d, tm, pc) in enumerate(rays):
            if taped:
                acc = acc + replay(sc, meta, tapes[s], o, d, tm, pc, s, **kw)
            else:
                acc = acc + trace(sc, meta, o, d, tm, pc, s,
                                  differentiable=True, **kw)
        diff = acc / spp - target
        loss = (diff * diff).sum() / (3.0 * B)
        mark("forward")
        loss.backward()
        mark("backward")
        state.optimizer.step()
        mark("update")
        return TrainState(params, state.optimizer, state.step + 1), \
            loss.detach()

    return step


def make_train_step_mega2(scene: SceneArrays, meta: SceneMeta,
                          cfg: RenderConfig):
    """The two-phase mega2 train step for one device (see the module
    notes).

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
            img = img + replay_cuda.replay(tt, rays, tapes[s], pc, s,
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
