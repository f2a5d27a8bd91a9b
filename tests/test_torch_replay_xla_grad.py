"""PyTorch port: the XLA taped replay's gradient, mirroring
tests/test_replay.py's ``test_grad_matches_search_path`` over every leaf:
the taped gradient (``ops/replay.trace_taped``) equals the scan form's
(``integrator.trace(differentiable=True)``) and the JAX package's taped
gradient, f64, rtol 1e-6.  Its own file: the JAX jit takes ~35 s."""

import jax
import numpy as np
import torch

from raytracinginoneweekendincuda_torch.ops import replay as trp
from raytracinginoneweekendincuda_torch.ops.hit import scene_tensors
from raytracinginoneweekendincuda_torch.ops.integrator import trace
from raytracinginoneweekendincuda_torch.ops.raygen import generate_rays
from raytracinginoneweekendincuda_torch.parallel import train as ttrain
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_tpu.ops import replay as jrp
from raytracinginoneweekendincuda_tpu.parallel import train as jtrain
from test_replay import _loss as jax_loss
from test_replay import _probe_scene as jax_probe_scene
from torch_probe_scenes import SEED, marble_probe
from torch_threads import one_torch_thread  # noqa: F401

W, H, BOUNCES, T_MIN = 12, 8, 6, 1e-3


def port_grads(trace_fn, spp=2):
    """d(tests/test_replay.py's _loss)/d(every leaf), the port's
    ``trace_fn`` on the f64 probe, as numpy."""
    sc, meta = tcompile(marble_probe(), W, H, dtype=np.float64)
    params = ttrain.split_params(sc, "cpu")
    st = ttrain.merge_params(scene_tensors(sc, "cpu"), params)
    img = 0.0
    for s in range(spp):
        o, d, t, pc = generate_rays(st.camera, torch.arange(W * H), s, W,
                                    H, SEED)
        img = img + trace_fn(st, meta, o, d, t, pc, s, max_bounces=BOUNCES,
                             t_min=T_MIN)
    (img / spp).sum().backward()
    leaves = ttrain.parameter_list(params)
    return [np.zeros(p.shape) if p.grad is None else p.grad.numpy()
            for p in leaves]


def scan_trace(*args, **kw):
    return trace(*args, differentiable=True, **kw)


def test_taped_grad_matches_scan_and_jax():
    """Every leaf: the taped gradient equals the scan form's and the JAX
    package's taped gradient (one jit over the parameter dict), f64,
    rtol 1e-6."""
    taped = port_grads(trp.trace_taped)
    scan = port_grads(scan_trace)
    js, jm = jax_probe_scene()
    g = jax.jit(jax.grad(lambda p: jax_loss(
        jrp.trace_taped, jtrain.merge_params(js, p), jm)))(
            jtrain.split_params(js))
    want = [np.asarray(x) for x in (*[g[f] for f in
                                      jtrain.DIFF_SCENE_FIELDS],
                                    *g["camera"])]
    names = [*ttrain.DIFF_SCENE_FIELDS,
             *(f"camera.{f}" for f in g["camera"]._fields)]
    for name, a, b, c in zip(names, taped, scan, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(a, c, rtol=1e-6, err_msg=name)
    assert abs(taped[0][0, 2]) > 0.0       # tests/test_replay.py's probe
