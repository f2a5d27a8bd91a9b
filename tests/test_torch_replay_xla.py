"""PyTorch port: the XLA taped replay (``ops/replay.py``: ``generate_tape``,
``replay``, ``trace_taped``), mirroring tests/test_replay.py.

Forward: the replay of the search's own tape reproduces the search's
radiance (f64).  The tape: its shape and misses, equal to the JAX
package's ``generate_tape`` in f64, and in f32 equal on at least 97% of
lanes to the mega2 trace's plain version (``trace_tapes_plain``, the
plain version of K2, in global ids; tests/test_replay.py's bound), whose
tape the XLA replay replays within K1's bounds of ``replay_plain`` (the
plain version of K3).  The backward: tests/test_torch_replay_xla_grad.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops import mega2 as tmega2
from raytracinginoneweekendincuda_torch.ops import replay as trp
from raytracinginoneweekendincuda_torch.ops.hit import scene_tensors
from raytracinginoneweekendincuda_torch.ops.integrator import trace
from raytracinginoneweekendincuda_torch.ops.raygen import generate_rays
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_tpu.ops import replay as jrp
from raytracinginoneweekendincuda_tpu.ops.raygen import (
    generate_rays as jrays,
)
from test_replay import _probe_scene as jax_probe_scene
from torch_probe_scenes import SEED, marble_probe
from torch_threads import one_torch_thread  # noqa: F401

W, H, BOUNCES, T_MIN = 12, 8, 6, 1e-3
TOL_ABOVE, MAX_FRAC_ABOVE, MAX_MEAN = 1e-4, 0.01, 2e-3   # K1's bounds


def rays(st, s=0):
    return generate_rays(st.camera, torch.arange(W * H), s, W, H, SEED)


def tape_of(st, meta, s=0):
    o, d, t, pc = rays(st, s)
    return trp.generate_tape(st, meta, o, d, t, pc, s, max_bounces=BOUNCES,
                             t_min=T_MIN)


@pytest.mark.parametrize("sid", [0, 8])
def test_forward_matches_search(sid):
    """Replay == search radiance on a geometry scene and a media scene
    (cornell smoke: medium winners ride the tape as S+Q+m)."""
    sc, meta = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float64)
    st = scene_tensors(sc, "cpu")
    o, d, t, pc = rays(st)
    kw = dict(max_bounces=BOUNCES, t_min=T_MIN)
    ref = trace(st, meta, o, d, t, pc, 0, **kw)
    got = trp.trace_taped(st, meta, o, d, t, pc, 0, **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_tape_shape_and_misses():
    sc, meta = tcompile(marble_probe(), W, H, dtype=np.float64)
    tape, _ = tape_of(scene_tensors(sc, "cpu"), meta)
    tape = tape.numpy()
    assert tape.shape == (BOUNCES, W * H) and tape.dtype == np.int32
    S, Q = sc.sph_c0.shape[0], sc.quad_q.shape[0]
    assert tape.min() >= -1 and tape.max() < S + Q + meta.n_media
    assert (tape[0] == -1).any()          # sky-facing rays miss at once
    dead = tape[0] == -1
    assert (tape[1:, dead] == -1).all()   # a lane that missed stays -1


def test_tape_equals_jax_f64():
    """The port's tape and search radiance against JAX's generate_tape on
    the same scene in f64."""
    js, jm = jax_probe_scene()
    o, d, t, pc = jrays(js.camera, jnp.arange(W * H, dtype=jnp.int32),
                        jnp.uint32(0), W, H, SEED)
    want, jacc = jrp.generate_tape(js, jm, o, d, t, pc, jnp.uint32(0),
                                   max_bounces=BOUNCES, t_min=T_MIN)
    sc, meta = tcompile(marble_probe(), W, H, dtype=np.float64)
    got, acc = tape_of(scene_tensors(sc, "cpu"), meta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-9,
                               atol=1e-12)


def plain_k2_case(sid):
    """f32 scene 'sid', the tensor scene, its XLA tape and the plain K2
    tape of sample 0 in global ids."""
    sc, meta = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float32)
    st = scene_tensors(sc, "cpu")
    tape_x, _ = tape_of(st, meta)
    tape_k = tmega2.mega2_tapes(sc, meta, np.arange(W * H), 1, width=W,
                                height=H, max_bounces=BOUNCES, t_min=T_MIN,
                                seed=SEED, device="cpu")[0]
    return sc, meta, st, tape_x, tape_k


@pytest.mark.parametrize("sid", [1, 4])
def test_xla_tape_matches_plain_k2_tape(sid):
    """The XLA search and the mega2 trace record the same winners on at
    least 97% of lanes (tests/test_replay.py's bound: f32 winner ties
    cascade down a lane's path)."""
    *_, tape_x, tape_k = plain_k2_case(sid)
    assert tape_k.shape == tape_x.shape
    same_lane = (tape_x == tape_k).all(0).double().mean().item()
    assert same_lane >= 0.97, same_lane


@pytest.mark.parametrize("sid", [1, 4])
def test_xla_replay_of_plain_k2_tape_matches_replay_plain(sid):
    """On the plain K2 tape (global ids), the XLA replay and replay_plain
    agree within K1's bounds."""
    sc, meta, st, _, tape_k = plain_k2_case(sid)
    o, d, t, pc = rays(st)
    got = trp.replay(st, meta, tape_k, o, d, t, pc, 0, max_bounces=BOUNCES,
                     t_min=T_MIN)
    tt = trp.replay_table(sc, meta, tmega2.pack_mega2_tables(sc, meta, "cpu"))
    want = trp.replay_plain(tt, torch.cat([o, d, t[:, None]], dim=1), tape_k,
                            pc, 0, st.camera.background, t_min=T_MIN)
    diff = (got.double() - want.double()).abs()
    assert torch.isfinite(got).all()
    assert (diff.amax(1) > TOL_ABOVE).double().mean() <= MAX_FRAC_ABOVE
    assert diff.mean() < MAX_MEAN
