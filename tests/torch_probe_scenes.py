"""Probe scenes and the port-only replay set-up of the PyTorch port's
replay tests (not a test module; imports no JAX, so the card's tests can
use it): the K2-plain tape in kernel rows of sample 0, the rays and
counters, and ``replay_plain`` over them."""

import numpy as np
import torch

from raytracinginoneweekendincuda_torch.core.camera import Camera as TCamera
from raytracinginoneweekendincuda_torch.ops import mega2 as tmega2
from raytracinginoneweekendincuda_torch.ops import replay as trp
from raytracinginoneweekendincuda_torch.ops.raygen import generate_rays
from raytracinginoneweekendincuda_torch.scene import api as tapi
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig

W, H, T_MIN, SEED = 16, 12, 1e-3, 1984


def marble_probe():
    """tests/test_replay.py's probe: lambertian, metal and dielectric
    spheres over a marble ground."""
    desc = tapi.SceneDesc()
    desc.add(
        tapi.Sphere((0.0, 0.0, -1.0), 0.5, tapi.Lambertian((0.6, 0.3, 0.2))),
        tapi.Sphere((-1.0, 0.0, -1.0), 0.45, tapi.Metal((0.8, 0.8, 0.8), 0.3)),
        tapi.Sphere((1.0, 0.0, -1.0), 0.45, tapi.Dielectric(1.5)),
        tapi.Sphere((0.0, -100.5, -1.0), 100.0,
                    tapi.Lambertian(tapi.NoiseTexture(2.0, table_seed=3))),
    )
    desc.camera = TCamera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=90.0,
                          focus_dist=1.0, background=(0.7, 0.8, 1.0))
    return desc


def media_probe():
    """tests/test_pallas_replay.py's probe: a sphere and a box constant
    medium in front of a large light."""
    desc = tapi.SceneDesc()
    desc.add(
        tapi.ConstantMedium(tapi.Sphere((-0.6, 0.0, -1.5), 0.5,
                                        tapi.Lambertian((1, 1, 1))),
                            0.7, (0.8, 0.4, 0.2)),
        tapi.ConstantMedium(tapi.Box((0.1, -0.5, -2.0), (1.1, 0.5, -1.0),
                                     tapi.Lambertian((1, 1, 1))),
                            0.7, (0.2, 0.5, 0.9)),
        tapi.Quad((-4.0, -4.0, -4.0), (8.0, 0.0, 0.0), (0.0, 8.0, 0.0),
                  tapi.DiffuseLight((5.0, 5.0, 5.0))),
    )
    desc.camera = TCamera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=90.0,
                          focus_dist=1.0, background=(0.0, 0.0, 0.0))
    return desc


def port_trace_case(desc, k, w=W, h=H, device="cpu"):
    """The port alone: scene, meta, K2-plain tape in kernel rows, rays and
    counters of sample 0, and the table pack (for ``kernel_space``)."""
    ts, tm = tcompile(desc, w, h, dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=1,
                       max_bounces=k, seed=SEED)
    tab = tmega2.pack_mega2_tables(ts, tm, device)
    fp = tmega2.frame_params(ts, cfg)
    pix = torch.arange(w * h, dtype=torch.int32, device=device)
    tape = tmega2.trace_tapes_plain(tab, pix, torch.zeros_like(pix), fp)
    o, d, tmv, pc = generate_rays(fp.cam, pix, 0, w, h, SEED)
    rays = torch.cat([o, d, tmv[:, None]], dim=1)
    return dict(scene=ts, meta=tm, tab=tab, tape=tape, rays=rays,
                pix_ctr=pc, bg=torch.tensor(
                    np.asarray(ts.camera.background), device=device))


def port_trace_replay(case, scene=None, rays=None, bg=None,
                      fn=trp.replay_plain):
    """``fn`` (``replay_plain``, or ``replay_cuda.replay`` for the kernels)
    over a `port_trace_case` in kernel space; ``scene`` / ``rays`` / ``bg``
    override the case's (e.g. with tensors that need grad)."""
    scene = case["scene"] if scene is None else scene
    tt = trp.replay_table(
        scene, case["meta"], case["tab"],
        kernel_space=tmega2.mega2_kernel_id_space(case["tab"], case["meta"]),
        device=case["rays"].device)
    return fn(
        tt, case["rays"] if rays is None else rays, case["tape"],
        case["pix_ctr"], 0, case["bg"] if bg is None else bg, t_min=T_MIN)
