"""PyTorch port: the plain mega2 render against the JAX package, part 2 --
the Perlin-noise and image-texture scenes (2, 3, 5, 9).  Bounds and
reasons: ``tests/torch_render_cases.py``."""

import pytest

import torch_render_cases as cases
from test_torch_mega2_render import jax_reference

SCENES = (2, 3, 5, 9)


@pytest.fixture(scope="module")
def jax_ref():
    cache = {}

    def get(sid):
        if sid not in cache:
            cache[sid] = jax_reference(sid)
        return cache[sid]
    return get


@pytest.mark.parametrize("sid", SCENES)
def test_plain_render_matches_jax_mega2(sid, jax_ref):
    cases.check_bounds(sid, cases.port_render(sid), jax_ref(sid))


@pytest.mark.parametrize("sid", [s for s in SCENES if s in cases.GOLDEN_MEGA2])
def test_u8_hash_equals_jax_mega2_golden(sid):
    assert cases.golden_hash(sid) == cases.GOLDEN_MEGA2[sid]
