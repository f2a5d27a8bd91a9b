"""PyTorch port: the general train step (``parallel/train.make_train_step``:
camera rays, the XLA path's differentiable trace, MSE, Adam) against the
JAX package's ``make_train_step`` on a 1x1 mesh, on the CPU, for both
engines: scene 4 at 12x8, spp 2, K 4, lr 0.05 (the configuration of
tests/test_torch_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops.hit import scene_tensors
from raytracinginoneweekendincuda_torch.ops.integrator import trace
from raytracinginoneweekendincuda_torch.ops.raygen import generate_rays
from raytracinginoneweekendincuda_torch.parallel import train as ttrain
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_torch.utils.config import (
    RenderConfig as TConfig,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.parallel import train as jtrain
from raytracinginoneweekendincuda_tpu.parallel.render import make_mesh
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401

W, H, SPP, K, LR, SEED = 12, 8, 2, 4, 0.05, 1984
ENGINES = ("taped", "scan")


def _cfg(cls):
    return cls(width=W, height=H, samples_per_pixel=SPP, max_bounces=K,
               seed=SEED)


@pytest.fixture(scope="module")
def setup():
    """The JAX and the port's start scenes (albedos perturbed as in
    tests/test_replay.py), and the target: the true scene's radiance (the
    port's search)."""
    ts, tm = tcompile(tscenes.build_scene(4), W, H, dtype=np.float32)
    ts0 = ts._replace(tex_c0=np.clip(np.asarray(ts.tex_c0) * 0.5 + 0.2, 0,
                                     1).astype(np.float32))
    pix = np.arange(W * H, dtype=np.int32)
    st = scene_tensors(ts, "cpu")
    acc = 0.0
    for s in range(SPP):
        o, d, t, pc = generate_rays(st.camera, torch.from_numpy(pix), s, W, H,
                                    SEED)
        acc = acc + trace(st, tm, o, d, t, pc, s, max_bounces=K, t_min=1e-3)
    tgt = (acc / SPP).numpy()
    js, jm = jcompile(jscenes.build_scene(4), W, H, dtype=np.float32)
    js0 = jax.tree.map(jnp.asarray, js)._replace(
        tex_c0=jnp.asarray(ts0.tex_c0))
    return js0, jm, ts0, tm, pix, tgt


@pytest.fixture(scope="module")
def jax_steps(setup):
    """One JAX step of each engine from the same start: (start params,
    params after the step, loss) by engine (one jit each)."""
    js0, jm, _, _, pix, tgt = setup
    mesh = make_mesh(jax.devices()[:1], sample_shards=1)
    out = {}
    for engine in ENGINES:
        opt = optax.adam(LR)
        jstate = jtrain.init_state(js0, opt)
        p0 = jax.tree.map(np.asarray, jstate.params)
        step = jtrain.make_train_step(js0, jm, _cfg(RenderConfig), mesh, opt,
                                      engine=engine)
        jstate, jloss = step(jstate, js0, pix, jnp.asarray(tgt))
        out[engine] = (p0, jax.tree.map(np.asarray, jstate.params),
                       float(jloss))
    return out


def _port(ts0, tm, params, engine="auto"):
    state = ttrain.init_state(
        ts0, lambda ps: torch.optim.Adam(ps, lr=LR), params=params)
    return state, ttrain.make_train_step(ts0, tm, _cfg(TConfig),
                                         engine=engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_one_step_matches_jax(setup, jax_steps, engine):
    """From the same parameters: the loss within rel 1e-5 and every leaf
    after one Adam step within rtol 1e-5."""
    _, _, ts0, tm, pix, tgt = setup
    p0, want, jloss = jax_steps[engine]
    state, step = _port(ts0, tm, ttrain.params_from_numpy(p0, "cpu"),
                        engine)
    state, loss = step(state, ts0, pix, torch.from_numpy(tgt))
    got = ttrain.params_to_numpy(state.params)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert np.abs(want["tex_c0"] - p0["tex_c0"]).max() > 0.01  # it moved
    for f in ttrain.DIFF_SCENE_FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, err_msg=f)
    for f, a, b in zip(want["camera"]._fields, got["camera"],
                       want["camera"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, err_msg=f)


def test_four_steps_reduce_the_loss(setup):
    _, _, ts0, tm, pix, tgt = setup
    state, step = _port(ts0, tm, ttrain.split_params(ts0, "cpu"))
    losses = []
    for _ in range(4):
        state, loss = step(state, ts0, pix, torch.from_numpy(tgt))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses
    assert state.step == 4


def test_unknown_engine_raises(setup):
    _, _, ts0, tm, _, _ = setup
    with pytest.raises(ValueError, match="unknown differentiable engine"):
        ttrain.make_train_step(ts0, tm, _cfg(TConfig), engine="mega2")


def test_f64_scene_keeps_its_dtype():
    """split_params keeps an f64 scene's dtype (the f32 leaves of an f32
    scene stay f32), and a step runs in it."""
    for dt, want in ((np.float64, torch.float64), (np.float32, torch.float32)):
        ts, _ = tcompile(tscenes.build_scene(4), 4, 4, dtype=dt)
        params = ttrain.split_params(ts, "cpu")
        assert {p.dtype for p in ttrain.parameter_list(params)} == {want}
    ts64, tm64 = tcompile(tscenes.build_scene(4), 4, 4, dtype=np.float64)
    state = ttrain.init_state(ts64, lambda ps: torch.optim.Adam(ps, lr=LR),
                              device="cpu")
    step = ttrain.make_train_step(ts64, tm64, TConfig(
        width=4, height=4, samples_per_pixel=1, max_bounces=2))
    state, loss = step(state, ts64, np.arange(16),
                       torch.zeros((16, 3), dtype=torch.float64))
    assert loss.dtype == torch.float64 and np.isfinite(float(loss))
    assert state.params["sph_c0"].dtype == torch.float64


def test_step_marks_its_phases_in_order(setup):
    """The taped step marks its tape, forward, backward and update; the
    scan step has no tape; a step with marks gives the loss of one
    without."""
    _, _, ts0, tm, pix, tgt = setup
    for engine, names in (("taped", ["tape", "forward", "backward",
                                     "update"]),
                          ("scan", ["forward", "backward", "update"])):
        got = []
        state, step = _port(ts0, tm, ttrain.split_params(ts0, "cpu"), engine)
        _, marked = step(state, ts0, pix, torch.from_numpy(tgt),
                         mark=got.append)
        assert got == names
        state, step = _port(ts0, tm, ttrain.split_params(ts0, "cpu"), engine)
        _, plain = step(state, ts0, pix, torch.from_numpy(tgt))
        assert float(marked) == float(plain)
