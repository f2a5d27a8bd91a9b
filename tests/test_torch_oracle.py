"""PyTorch port: the f64 numpy oracle (``testing/oracle.py``) against the
JAX package's, and the port's f64 engines against it.

The port's oracle shares with JAX's only the numpy draw slots and samplers
(expression for expression), so its frames must equal JAX's bit for bit.
The engine cases are ``tests/test_oracle_parity.py``'s, at its sizes and
with ``assert_images_close``'s defaults: the batched engines against the
scalar oracle, which share only the RNG contract and the samplers.
"""

import numpy as np
import pytest

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops.render import render as trender
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_torch.testing.compare import (
    assert_images_close,
)
from raytracinginoneweekendincuda_torch.testing.oracle import Oracle
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.testing.oracle import (
    Oracle as JOracle,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("sid", [0, 3, 9])
def test_oracle_equals_jax_oracle(sid):
    W, H = 8, 4
    ts, tm = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float64)
    js, jm = jcompile(jscenes.build_scene(sid), W, H, dtype=np.float64)
    got = Oracle(ts, tm, W, H, 1984).render(1)
    want = JOracle(js, jm, W, H, 1984).render(1)
    assert got.shape == (H, W, 3) and got.any()
    np.testing.assert_array_equal(got, want)


def test_oracle_calls_no_torch(monkeypatch):
    """The oracle is independent of the port's batched code: it runs with
    every torch function made to raise."""
    import torch

    def refuse(*_a, **_k):
        raise AssertionError("the oracle called torch")

    for name in ("as_tensor", "tensor", "zeros", "where", "stack", "sqrt"):
        monkeypatch.setattr(torch, name, refuse)
    scene, meta = tcompile(tscenes.build_scene(8), 4, 2, dtype=np.float64)
    assert Oracle(scene, meta, 4, 2, 1984).render(1).any()


def _parity(desc, W, H, spp, label, engine="bruteforce", oracle=None):
    scene, meta = tcompile(desc, W, H, dtype=np.float64)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       dtype="float64", engine=engine)
    img = trender(scene, meta, cfg, device="cpu")
    if oracle is None:
        oracle = Oracle(scene, meta, W, H, cfg.seed).render(spp)
    assert_images_close(img, oracle, label=label)


def test_book1_basic():
    _parity(tscenes.book1_basic(), 32, 18, 2, "book1_basic")


@pytest.mark.parametrize("sid", [0, 1, 2, 3, 4, 5, 6, 7, 8])
def test_reference_scene(sid):
    _parity(tscenes.build_scene(sid), 24, 12, 2, f"scene{sid}")


@pytest.fixture(scope="module")
def scene9_oracle():
    W, H = 16, 8
    scene, meta = tcompile(tscenes.build_scene(9), W, H, dtype=np.float64)
    return Oracle(scene, meta, W, H, 1984).render(2)


@pytest.mark.parametrize("engine", ["bruteforce", "bvh"])
def test_final_scene(engine, scene9_oracle):
    _parity(tscenes.build_scene(9), 16, 8, 2, f"scene9 {engine}",
            engine=engine, oracle=scene9_oracle)
