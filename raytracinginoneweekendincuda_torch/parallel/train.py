"""Differentiable rendering: the train steps, on one device or a mesh.

Port of ``raytracinginoneweekendincuda_tpu/parallel/train.py``, with
``torch.optim`` in place of optax.  Parameters are a plain dict of leaf
tensors (the scene's float leaves in `DIFF_SCENE_FIELDS`, plus ``camera``
as a ``CameraParams`` of tensors); `merge_params` overlays them on a
scene.  Two steps, each the MSE in linear radiance over ``3 * B``,
``backward()`` and the optimizer step:

* `make_train_step`, the general step (JAX ``make_train_step``): per
  sample the camera rays and the differentiable trace of the XLA path, in
  the scene's dtype: engine ``taped`` (``ops/replay.py``: the winner tape
  of the search without gradients, then the replay) or ``scan``
  (``ops/integrator.trace(differentiable=True)``: the search itself under
  per-bounce checkpoints, the gradient oracle).  Any ``hit_fn`` of the
  integrator plugs in here.
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

The mesh forms (``mesh=``, a `parallel/render.Mesh`; JAX's ``shard_map``
step and ``_make_train_step_mega2_sharded``).  Every rank of a (px, sp)
mesh holds the same parameters and optimizer, and in a step

  1. takes its contiguous slice of ``pix`` and ``target`` (B must be
     divisible by n_px) and sums its radiance over its sample window
     ``j * spp/n_sp ..``, with autograd (the mega2 form packs the tables
     itself from the replicated parameters and traces its own tapes, with
     K2 keyed on that window);
  2. all-reduces a detached copy of the sum over sp, forms ``diff =
     col / spp - target``, and the loss with the px sum over ``denom =
     3 * B_local * n_px``;
  3. back-propagates ``sum(diff^2) / denom`` into its own sum only: the
     collective's result enters the graph as a constant, so the MSE chain
     rule is the local one, ``2 * diff / (spp * denom)``, and no gradient
     flows through the collective (in the JAX package's round 4,
     differentiating through the sample psum scaled every gradient by
     n_sp);
  4. all-reduces every leaf's gradient over the world and steps its
     optimizer: the same sums and the same Adam, so the ranks' parameters
     stay equal.

On one device (``mesh=None``) the same code runs on a mesh of one rank,
where no collective is called, and its arithmetic is the one-device
step's, op for op.  Not ported: JAX's ``_commit_replicated`` and the
step's ``cache`` of compiled variants (XLA sharding and retrace plumbing;
the port's K2 takes its tables at run time, with no compile-time
statics).
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
from . import render as prender

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


def _resolve_mesh(mesh, cfg: RenderConfig):
    """(n_px, n_sp, i, j, spp_local) of a step on ``mesh`` (None: one
    device, the 1x1 mesh)."""
    n_px, n_sp = (1, 1) if mesh is None else mesh.dims
    i, j = (0, 0) if mesh is None else mesh.coord
    spp = cfg.samples_per_pixel
    if spp % n_sp != 0:
        raise ValueError(f"spp={spp} must be divisible by sample shards "
                         f"{n_sp}")
    return n_px, n_sp, i, j, spp // n_sp


def _local_batch(pix, target, n_px: int, i: int):
    """Px shard i's contiguous slice of the batch: (pix [B_local] numpy
    int32, target [B_local, 3])."""
    pix = np.asarray(pix, np.int32)
    B = pix.shape[0]
    if B % n_px != 0:
        raise ValueError(f"batch of {B} pixels not divisible by the px "
                         f"shards {n_px}")
    b = B // n_px
    return pix[i * b:(i + 1) * b], target[i * b:(i + 1) * b]


def _mesh_loss(mesh, acc: torch.Tensor, target: torch.Tensor, spp: int):
    """(this rank's loss to back-propagate, the step's loss) of the
    radiance sum ``acc`` [B_local, 3] over this rank's samples: the sum
    over sp enters as a detached constant (the module notes, step 2-3)."""
    n_px, n_sp = (1, 1) if mesh is None else mesh.dims
    col = acc
    if n_sp > 1:
        tot = prender.all_reduce(acc.detach().clone(), mesh.sp_group)
        col = acc + (tot - acc.detach())
    diff = col / spp - target
    local = (diff * diff).sum() / (3.0 * target.shape[0] * n_px)
    loss = local.detach()
    if n_px > 1:
        loss = prender.all_reduce(loss.clone(), mesh.px_group)
    return local, loss


def _all_reduce_grads(mesh, params: dict) -> None:
    """Every leaf's gradient summed over the mesh's ranks, in place (one
    all-reduce of the flattened gradients; a leaf the graph did not reach
    adds zeros)."""
    if mesh is None or mesh.dims == (1, 1):
        return
    leaves = parameter_list(params)
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = prender.all_reduce(torch.cat([p.grad.reshape(-1)
                                         for p in leaves]), None)
    for p, g in zip(leaves, torch.split(flat, [p.numel() for p in leaves])):
        p.grad.copy_(g.view_as(p))


def make_train_step(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                    engine: str = "auto", mesh=None):
    """The general train step (see the module notes), on one device or on
    this rank of ``mesh``.

    Returns ``step(state, scene_rest, pix, target, mark=None) -> (state,
    loss)``: ``scene_rest`` a scene (numpy leaves; `merge_params`
    overlays the parameters on it, typically ``scene`` itself), ``pix``
    [B] pixel ids, ``target`` [B, 3] linear radiance on the parameters'
    device, where the step runs (on a mesh every rank passes the whole
    batch and takes its slice).  ``engine``: ``taped`` (the default of
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
    n_px, _, i, j, spp_local = _resolve_mesh(mesh, cfg)
    samples = range(j * spp_local, (j + 1) * spp_local)
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
        pix, target = _local_batch(pix, target, n_px, i)
        pix = torch.as_tensor(pix, device=dev)
        B = pix.shape[0]
        rays = [generate_rays(sc.camera, pix, s, W, H, cfg.seed)
                for s in samples]
        if taped:
            with torch.no_grad():    # integer tapes: no graph of the search
                tapes = [generate_tape(sc, meta, o.detach(), d.detach(),
                                       tm.detach(), pc, s, **kw)[0]
                         for s, (o, d, tm, pc) in zip(samples, rays)]
            mark("tape")
        acc = torch.zeros((B, 3), dtype=sc.camera.origin.dtype, device=dev)
        for k, (s, (o, d, tm, pc)) in enumerate(zip(samples, rays)):
            if taped:
                acc = acc + replay(sc, meta, tapes[k], o, d, tm, pc, s, **kw)
            else:
                acc = acc + trace(sc, meta, o, d, tm, pc, s,
                                  differentiable=True, **kw)
        local, loss = _mesh_loss(mesh, acc, target, spp)
        mark("forward")
        local.backward()
        _all_reduce_grads(mesh, params)
        mark("backward")
        state.optimizer.step()
        mark("update")
        return TrainState(params, state.optimizer, state.step + 1), loss

    return step


def make_train_step_mega2(scene: SceneArrays, meta: SceneMeta,
                          cfg: RenderConfig, mesh=None):
    """The two-phase mega2 train step (see the module notes), on one
    device or on this rank of ``mesh``.

    Returns ``step(state, pix, target, mark=None) -> (state, loss)``:
    ``pix`` [B] pixel ids (any order), ``target`` [B, 3] linear radiance on
    the parameters' device (on a mesh every rank passes the whole batch
    and takes its slice).  The device is the parameters'.  ``mark``, if
    given, is called with "pack", "trace", "forward", "backward" and
    "update" as each phase ends (the step's callers time phases with it),
    and inside the forward with "derive" once (the replay table) and
    "raygen" and "replay" once a sample (the camera rays; K3 and the
    sum), so that the forward's last part, "forward", is the loss.
    """
    spp = cfg.samples_per_pixel
    n_px, _, i, j, spp_local = _resolve_mesh(mesh, cfg)
    samp0 = j * spp_local
    W, H = cfg.width, cfg.height
    no_mark = lambda _name: None

    def step(state: TrainState, pix, target: torch.Tensor, mark=None):
        mark = mark or no_mark
        params = state.params
        dev = params["tex_c0"].device
        pix, target = _local_batch(pix, target, n_px, i)
        # phase 1: winner tapes from the detached parameters (kernel rows)
        sc_np = merge_params(scene, params_to_numpy(params))
        tab = pack_mega2_tables(sc_np, meta, dev)
        t_min = frame_params(sc_np, cfg).t_min
        mark("pack")
        tapes = mega2_tapes(sc_np, meta, pix, spp_local, width=W, height=H,
                            max_bounces=cfg.max_bounces, t_min=cfg.t_min,
                            seed=cfg.seed, id_space="kernel", device=dev,
                            tab=tab, samp0=samp0)    # [spp_local, K, B]
        pix = torch.as_tensor(pix, device=dev)
        B = pix.shape[0]
        mark("trace")

        # phase 2: the loss through the replay, its gradient, the update
        state.optimizer.zero_grad(set_to_none=True)
        sc = merge_params(scene, params)
        tt = replay_table(sc, meta, tab,
                          kernel_space=mega2_kernel_id_space(tab, meta))
        img = torch.zeros((B, 3), dtype=torch.float32, device=dev)
        mark("derive")
        for k in range(spp_local):
            s = samp0 + k
            o, d, tm, pc = generate_rays(sc.camera, pix, s, W, H, cfg.seed)
            rays = torch.cat([o, d, tm[:, None]], dim=1)
            mark("raygen")
            img = img + replay_cuda.replay(tt, rays, tapes[k], pc, s,
                                           sc.camera.background, t_min=t_min)
            mark("replay")
        local, loss = _mesh_loss(mesh, img, target, spp)
        mark("forward")
        local.backward()
        _all_reduce_grads(mesh, params)
        mark("backward")
        state.optimizer.step()
        mark("update")
        return TrainState(params, state.optimizer, state.step + 1), loss

    return step
