"""PyTorch port: kernel K5's plain version (``ops/mega.mega_bounces_plain``)
against the JAX package's Pallas kernel ``mega_bounces`` in interpret mode,
and the mega table packer against the JAX packer.

The pool: 512 lanes from the frame loop's first refill at 16x8 (work item
k -> pixel k % 128, sample k // 128), the same ``rf`` / ``ri`` for both; one
call of K = 2 bounces from there, and a second call from the JAX state
after it.

Tolerance: ``ri`` (counters, bounce, liveness) equal on every lane; the
throughput and radiance columns of ``rf`` within 1e-5 (absolute, or
relative above 1) on at least 99% of lanes.  The origin and direction
columns agree within 1e-4 on at least 85% of lanes and within 1e-2 on all
of them.  Why not tighter: XLA's CPU backend contracts the interpret-mode
kernel's products into FMAs, which K5 and its plain version do not (see
tests/test_torch_closest_geo.py).  On scene 0's small spheres (radius 0.2
seen from ~19 units) the discriminant ``b*b - a*cc`` cancels ~9e3-fold, so
that rounding moves a hit's ``t`` by up to ~1e-4 relative, and a
Lambertian bounce direction (normal = (p - centre) / radius) by up to
~0.5%.  On the card, where neither side contracts, chip_smoke.py holds K5
against the plain version with K1's bounds.
"""

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops import mega as tmega
from raytracinginoneweekendincuda_torch.ops.raygen import (
    camera_tuple, generate_rays,
)
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops import mega as jmega
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from torch_threads import one_torch_thread  # noqa: F401

W, H, POOL, K, MAX_B, T_MIN, SEED = 16, 8, 512, 2, 50, 1e-3, 1984


def refill_pool(scene):
    """(rf [512, 13] f32, ri [512, 4] i32) of a fresh pool."""
    k = torch.arange(POOL)
    o, d, tm, pc = generate_rays(camera_tuple(scene.camera), k % (W * H),
                                 k // (W * H), W, H, SEED)
    rf = torch.cat([o, d, tm[:, None], torch.ones((POOL, 3)),
                    torch.zeros((POOL, 3))], dim=1)
    ri = torch.stack([pc, (k // (W * H)).to(torch.int32),
                      torch.zeros(POOL, dtype=torch.int32),
                      torch.ones(POOL, dtype=torch.int32)], dim=1)
    return rf.numpy(), ri.numpy()


def close_lanes(a: np.ndarray, b: np.ndarray, tol: float) -> float:
    """Share of lanes whose every entry agrees to ``tol`` (relative above
    1)."""
    ok = np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))
    return float(ok.all(axis=1).mean())


@pytest.mark.parametrize("sid", (0, 1, 4, 6, 7, 8))
def test_plain_matches_pallas_interpret(sid):
    jscene, jmeta = jcompile(jscenes.build_scene(sid), W, H,
                             dtype=np.float32)
    tscene, tmeta = tcompile(tscenes.build_scene(sid), W, H,
                             dtype=np.float32)
    sph, quad, attr, med = jmega.pack_mega_tables(jscene, jmeta)
    tabs = tmega.pack_mega_tables(tscene, tmeta, "cpu")
    med_key = tuple(tuple(float(x) for x in r) for r in np.asarray(med))
    bg = tuple(float(x) for x in np.asarray(jscene.camera.background))
    rf, ri = refill_pool(tscene)
    for call in range(2):
        jrf, jri = (np.asarray(x) for x in jmega.mega_bounces(
            rf, ri, sph, quad, attr, meta=jmeta, med_key=med_key,
            k_bounces=K, t_min=T_MIN, max_bounces=MAX_B, background=bg,
            interpret=True))
        prf, pri = tmega.mega_bounces(
            torch.tensor(rf), torch.tensor(ri), tabs, k_bounces=K,
            t_min=T_MIN, max_bounces=MAX_B, background=bg)
        assert prf.dtype == torch.float32 and pri.dtype == torch.int32
        np.testing.assert_array_equal(pri.numpy(), jri, err_msg=f"call {call}")
        prf = prf.numpy()
        assert close_lanes(prf[:, 7:], jrf[:, 7:], 1e-5) >= 0.99, call
        assert close_lanes(prf[:, :7], jrf[:, :7], 1e-4) >= 0.85, call
        assert close_lanes(prf[:, :7], jrf[:, :7], 1e-2) == 1.0, call
        rf, ri = jrf, jri
    assert (ri[:, 2] > 0).all()      # every lane bounced


@pytest.mark.parametrize("sid", (0, 8))
def test_port_packer_matches_jax(sid):
    """Bit-equal tables; the port's media table adds radius^2 in column 15
    (the Pallas kernel squares its python-float radius at trace time)."""
    jscene, jmeta = jcompile(jscenes.build_scene(sid), W, H,
                             dtype=np.float32)
    tscene, tmeta = tcompile(tscenes.build_scene(sid), W, H,
                             dtype=np.float32)
    want = [np.asarray(x) for x in jmega.pack_mega_tables(jscene, jmeta)]
    tabs = tmega.pack_mega_tables(tscene, tmeta, "cpu")
    for name, w in zip(("sph", "quad", "attr"), want):
        np.testing.assert_array_equal(getattr(tabs, name).numpy(), w,
                                      err_msg=name)
    med = tabs.med.numpy()
    np.testing.assert_array_equal(np.delete(med, 15, axis=1),
                                  np.delete(want[3], 15, axis=1))
    r = want[3][:, 4].astype(np.float64)
    np.testing.assert_array_equal(med[:, 15], (r * r).astype(np.float32))
    assert tabs.n_media == tmeta.n_media


def test_dispatch_and_wrapper_refusals():
    scene, meta = tcompile(tscenes.build_scene(4), W, H, dtype=np.float32)
    tabs = tmega.pack_mega_tables(scene, meta, "cpu")
    rf, ri = (torch.from_numpy(x) for x in refill_pool(scene))
    kw = dict(k_bounces=K, t_min=T_MIN, max_bounces=MAX_B,
              background=(0.7, 0.8, 1.0))
    before = tmega.mega_bounces_cuda.launches
    tmega.mega_bounces(rf, ri, tabs, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmega.mega_bounces_cuda(rf, ri, tabs, **kw)
    with pytest.raises(ValueError, match="no mega_bounces"):
        tmega.mega_bounces(rf.to("meta"), ri, tabs, **kw)
    assert tmega.mega_bounces_cuda.launches == before
