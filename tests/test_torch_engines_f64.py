"""PyTorch port at float64: the hit, shade and integrator modules through
the ``bruteforce`` and ``wavefront`` engines, against the JAX package's
``bruteforce`` engine at float64 (the repo's f64 oracle setting).

Every radiance sample draws from the same counters in both packages, so
in f64 the frames agree to rounding: atol 1e-9 (the JAX package's own
wavefront-vs-chunked test holds 1e-12 within one package; across two
frameworks libm's sin/cos/arccos may differ by an ulp).  The winners of
``closest_hit_winner`` must be equal on the same rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops import hit as thit
from raytracinginoneweekendincuda_torch.ops.raygen import generate_rays
from raytracinginoneweekendincuda_torch.ops.render import render as trender
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_torch.utils.config import (
    RenderConfig as TConfig,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops import hit as jhit
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

W, H, RPB = 24, 16, 256
CASES = ((0, 4), (4, 4), (8, 2))      # (scene, spp), tests/test_wavefront.py


@pytest.fixture(scope="module")
def jax_frames():
    """JAX ``bruteforce`` frames at f64, one per case."""
    out = {}
    for sid, spp in CASES:
        scene, meta = jcompile(jscenes.build_scene(sid), W, H,
                               dtype=np.float64)
        cfg = JConfig(width=W, height=H, samples_per_pixel=spp,
                      dtype="float64", rays_per_batch=RPB)
        out[sid] = np.asarray(jrender(scene, meta, cfg))
    return out


def port_frame(sid: int, spp: int, engine: str) -> np.ndarray:
    scene, meta = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float64)
    cfg = TConfig(width=W, height=H, samples_per_pixel=spp, dtype="float64",
                  rays_per_batch=RPB, engine=engine)
    img = trender(scene, meta, cfg, device="cpu")
    assert img.dtype == np.float64 and img.shape == (H, W, 3)
    return img


@pytest.mark.parametrize("sid,spp", CASES)
def test_bruteforce_f64_matches_jax(jax_frames, sid, spp):
    np.testing.assert_allclose(port_frame(sid, spp, "bruteforce"),
                               jax_frames[sid], atol=1e-9, rtol=0)


@pytest.mark.parametrize("sid,spp", CASES)
def test_wavefront_f64_matches_jax(jax_frames, sid, spp):
    np.testing.assert_allclose(port_frame(sid, spp, "wavefront"),
                               jax_frames[sid], atol=1e-9, rtol=0)


@pytest.mark.parametrize("sid", (0, 4, 8))
def test_closest_hit_winner_equal(sid):
    """The same f64 rays give the same winner ids and the same record:
    camera rays of random pixels and samples with their directions
    jittered by 10%, random times and medium draws (numpy seed 7)."""
    jscene, jmeta = jcompile(jscenes.build_scene(sid), W, H,
                             dtype=np.float64)
    tscene, tmeta = tcompile(tscenes.build_scene(sid), W, H,
                             dtype=np.float64)
    st = thit.scene_tensors(tscene, "cpu")
    rs = np.random.default_rng(7)
    n, m = 2048, max(tmeta.n_media, 1)
    o, d, _, _ = generate_rays(st.camera,
                               torch.from_numpy(rs.integers(0, W * H, n)),
                               torch.from_numpy(rs.integers(0, 4, n)), W, H,
                               1984)
    o, d = o.numpy(), d.numpy()
    d = d + 0.1 * np.linalg.norm(d, axis=1, keepdims=True) \
        * rs.normal(0.0, 1.0, (n, 3))
    tm = rs.uniform(0.0, 1.0, n)
    u_med = rs.uniform(1e-6, 1.0, (n, m))
    jrec, jwin = jhit.closest_hit_winner(
        jscene, jmeta, jhit.derive(jscene), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tm), 1e-3, jnp.asarray(u_med))
    trec, twin = thit.closest_hit_winner(
        st, tmeta, thit.derive(st), torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tm), 1e-3, torch.from_numpy(u_med))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    assert (twin >= 0).float().mean() > 0.2          # the rays hit things
    hit = trec.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(jrec.hit))
    for name in ("t", "p", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(trec, name).numpy()[hit],
                                   np.asarray(getattr(jrec, name))[hit],
                                   atol=1e-9, rtol=1e-9, err_msg=name)
    np.testing.assert_array_equal(trec.front.numpy()[hit],
                                  np.asarray(jrec.front)[hit])
