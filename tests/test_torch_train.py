"""PyTorch port: the single-device mega2 train step
(``parallel/train.make_train_step_mega2``: trace, replay, MSE, Adam)
against the JAX package's step on the CPU, scene 4 at 12x8, spp 2,
K 4, lr 0.05 (the configuration of tests/test_replay.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.parallel import train as ttrain
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_torch.utils.config import (
    RenderConfig as TConfig,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops.integrator import trace
from raytracinginoneweekendincuda_tpu.ops.raygen import generate_rays
from raytracinginoneweekendincuda_tpu.parallel import train as jtrain
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401

W, H, SPP, K, LR, SEED = 12, 8, 2, 4, 0.05, 1984


@pytest.fixture(scope="module")
def setup():
    """JAX scene, meta, target (the true scene's radiance, XLA search)
    and the perturbed-albedo start of tests/test_replay.py."""
    scene, meta = jcompile(jscenes.build_scene(4), W, H, dtype=np.float32)
    scene = jax.tree.map(jnp.asarray, scene)
    pix = np.arange(W * H, dtype=np.int32)
    tgt = 0.0
    for s in range(SPP):
        o, d, t, pc = generate_rays(scene.camera, jnp.asarray(pix),
                                    jnp.uint32(s), W, H, SEED)
        tgt = tgt + trace(scene, meta, o, d, t, pc, jnp.uint32(s),
                          max_bounces=K, t_min=1e-3)
    tgt = np.asarray(tgt / SPP, np.float32)
    scene0 = scene._replace(tex_c0=jnp.clip(scene.tex_c0 * 0.5 + 0.2, 0, 1))
    ts, tm = tcompile(tscenes.build_scene(4), W, H, dtype=np.float32)
    ts0 = ts._replace(tex_c0=np.asarray(scene0.tex_c0))
    return scene0, meta, ts0, tm, pix, tgt


def _port_step(ts0, tm, params):
    state = ttrain.init_state(
        ts0, lambda ps: torch.optim.Adam(ps, lr=LR), params=params)
    step = ttrain.make_train_step_mega2(
        ts0, tm, TConfig(width=W, height=H, samples_per_pixel=SPP,
                         max_bounces=K, seed=SEED))
    return state, step


def test_one_step_matches_jax(setup):
    """From the same parameters (carried across by params_from_numpy):
    the loss within rel 1e-5 and every leaf after one Adam step within
    rtol 1e-5."""
    scene0, meta, ts0, tm, pix, tgt = setup
    opt = optax.adam(LR)
    jstep = jtrain.make_train_step_mega2(
        scene0, meta, RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                                   max_bounces=K, seed=SEED), opt)
    jstate = jtrain.init_state(scene0, opt)
    p0 = jax.tree.map(np.asarray, jstate.params)
    jstate, jloss = jstep(jstate, pix, jnp.asarray(tgt))
    want = jax.tree.map(np.asarray, jstate.params)

    state, step = _port_step(ts0, tm, ttrain.params_from_numpy(p0, "cpu"))
    state, loss = step(state, pix, torch.from_numpy(tgt))
    got = ttrain.params_to_numpy(state.params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert np.abs(want["tex_c0"] - p0["tex_c0"]).max() > 0.01  # it moved
    for f in ttrain.DIFF_SCENE_FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, err_msg=f)
    for f, a, b in zip(want["camera"]._fields, got["camera"],
                       want["camera"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, err_msg=f)


def test_four_steps_reduce_the_loss(setup):
    _, _, ts0, tm, pix, tgt = setup
    state, step = _port_step(ts0, tm, ttrain.split_params(ts0, "cpu"))
    losses = []
    for _ in range(4):
        state, loss = step(state, pix, torch.from_numpy(tgt))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses
    assert state.step == 4


def test_params_from_numpy_round_trips_split_params(setup):
    _, _, ts0, _, _, _ = setup
    params = ttrain.split_params(ts0, "cpu")
    again = ttrain.params_from_numpy(ttrain.params_to_numpy(params), "cpu")
    for a, b in zip(ttrain.parameter_list(params),
                    ttrain.parameter_list(again)):
        assert a.requires_grad and b.requires_grad and a.is_leaf
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    merged = ttrain.merge_params(ts0, params)
    assert merged.tex_c0 is params["tex_c0"]
    assert merged.camera is params["camera"]
    np.testing.assert_array_equal(params["sph_c0"].detach().numpy(),
                                  np.asarray(ts0.sph_c0))
