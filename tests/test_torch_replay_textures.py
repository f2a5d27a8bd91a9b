"""PyTorch port: the replay forward on the textured scenes -- image (2)
and Perlin marble (3, 5) -- against the JAX package's Pallas replay
(interpret mode) at 16x12 and 2 bounces, with the thresholds of
``tests/test_pallas_replay.py::test_primal_textured_scenes_match_xla``."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops.pallas_replay import replay_pallas
from test_torch_replay import T_MIN, jax_case, port_replay
from torch_threads import one_torch_thread  # noqa: F401

K = 2


@pytest.mark.parametrize("sid,minfrac", [(2, 0.999), (3, 0.90), (5, 0.90)])
def test_replay_textured_matches_pallas(sid, minfrac):
    (js, jm, tape, o, d, t, pc), port = jax_case(
        jscenes.build_scene(sid), tscenes.build_scene(sid), K)
    want = np.asarray(replay_pallas(js, jm, tape, o, d, t, pc,
                                    jnp.uint32(0), max_bounces=K,
                                    t_min=T_MIN))
    got = port_replay(port).numpy()
    close = np.isclose(got, want, rtol=1e-3, atol=5e-4).all(axis=-1)
    assert close.mean() >= minfrac, close.mean()
