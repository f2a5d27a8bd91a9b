"""The taped replay against the search in f32 on scene 0: a gap that
comes from the reference (ROADMAP.md queue 3).

The search (``hit.sphere_candidates``) solves the sphere quadratic in the
coefficient form, the replay (``replay.taped_record``) in the direct
``oc`` form, as the JAX package does.  On the 1000-radius ground sphere
the two roots round apart in f32, the hit point moves, and where it
sits at a checker edge the cell (and the path's radiance) flips.  The JAX
package shows the same lanes; in f64 the two agree.  So the taped and the
scan engines of the train step differ in f32 on this scene."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops import replay as trp
from raytracinginoneweekendincuda_torch.ops.hit import scene_tensors
from raytracinginoneweekendincuda_torch.ops.raygen import generate_rays
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops import replay as jrp
from raytracinginoneweekendincuda_tpu.ops.raygen import (
    generate_rays as jrays,
)
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from torch_probe_scenes import SEED, T_MIN
from torch_threads import one_torch_thread  # noqa: F401

W, H, K = 64, 36, 8      # sample 0 of 2,304 pixels: a few lanes flip


def port_gap(dtype):
    """(per-lane max |replay - search| of sample 0, the tape)."""
    sc, meta = tcompile(tscenes.build_scene(0), W, H, dtype=dtype)
    st = scene_tensors(sc, "cpu")
    o, d, t, pc = generate_rays(st.camera, torch.arange(W * H), 0, W, H,
                                SEED)
    kw = dict(max_bounces=K, t_min=T_MIN)
    tape, search = trp.generate_tape(st, meta, o, d, t, pc, 0, **kw)
    taped = trp.replay(st, meta, tape, o, d, t, pc, 0, **kw)
    return (taped - search).abs().amax(1).numpy(), tape.numpy()


def jax_gap():
    sc, meta = jcompile(jscenes.build_scene(0), W, H, dtype=np.float32)
    sc = jax.tree.map(jnp.asarray, sc)
    o, d, t, pc = jrays(sc.camera, jnp.arange(W * H, dtype=jnp.int32),
                        jnp.uint32(0), W, H, SEED)
    kw = dict(max_bounces=K, t_min=T_MIN)
    tape, search = jrp.generate_tape(sc, meta, o, d, t, pc, jnp.uint32(0),
                                     **kw)
    taped = jrp.replay(sc, meta, tape, o, d, t, pc, jnp.uint32(0), **kw)
    return (np.abs(np.asarray(taped) - np.asarray(search)).max(1),
            np.asarray(tape))


def test_f32_gap_of_the_taped_replay_is_the_references():
    gap, tape = port_gap(np.float32)
    jgap, jtape = jax_gap()
    ground = 0                                # sphere row 0, radius 1000
    for g, tp in ((gap, tape), (jgap, jtape)):
        lanes = np.where(g > 1e-2)[0]
        assert lanes.size > 0                 # both packages show it
        assert (tp[:, lanes] == ground).any(0).all()
    # the reference's largest flips are the port's, of the same size
    big = np.where(jgap > 5e-2)[0]
    assert big.size > 0
    np.testing.assert_allclose(gap[big], jgap[big], rtol=1e-5)
    # in f64 the replay reproduces the search on every lane
    gap64, _ = port_gap(np.float64)
    assert gap64.max() < 1e-12
