"""PyTorch port: the BVH build (``scene/bvh.py``), its traversal
(``ops/bvh_engine.py``) and the engines ``bvh`` / ``wavefront_bvh``,
against the JAX package and against the port's brute-force engine.

Tolerances:

* the build is numpy on both sides: arrays equal;
* traversal on seeded rays, f64: ``t`` within rtol 1e-12 and the winners
  equal but on ulp ties (two primitives at the same ``t``); f32: the
  bounds of ``tests/test_torch_closest_geo.py`` (winners on >= 99.9% of
  lanes, ``t`` within 2e-4 relative: XLA contracts the JAX loop's
  arithmetic into FMAs, PyTorch does not);
* frames, f64: at most 2 pixels above 1e-9 (``tests/test_bvh.py``: the
  brute-force engine tests spheres in the coefficient form, the BVH in
  the direct ``oc`` form, so a grazing ray may flip a winner).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops import bvh_engine as tbvh
from raytracinginoneweekendincuda_torch.ops import hit as thit
from raytracinginoneweekendincuda_torch.ops.render import render as trender
from raytracinginoneweekendincuda_torch.scene import bvh as tbuild
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_torch.utils.config import (
    RenderConfig as TConfig,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops import bvh_engine as jbvh
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.scene import bvh as jbuild
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

T_MIN, N_RAYS = 1e-3, 1024


def _leaf_reachability(bvh):
    """Walk the threaded layout sequentially; collect visited leaves."""
    m = len(bvh.prim)
    leaves, node, visited = [], 0, 0
    while node < m:
        visited += 1
        assert visited <= 4 * m, "traversal does not terminate"
        if bvh.prim[node] >= 0:
            leaves.append(int(bvh.prim[node]))
            node = int(bvh.escape[node])
        else:
            node = node + 1      # descend (as if every AABB hit)
    return leaves


@pytest.mark.parametrize("sid", [0, 4, 7, 9])
def test_build_equals_jax(sid):
    """The port's build is JAX's pure-Python build, array for array."""
    ts, _ = tcompile(tscenes.build_scene(sid), 8, 8)
    js, _ = jcompile(jscenes.build_scene(sid), 8, 8)
    got = tbuild.build_scene_bvh(ts)
    want = jbuild.build_scene_bvh(js, use_native=False)
    for f in tbuild.BvhArrays._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("sid", [0, 4, 7, 9])
def test_builder_invariants(sid):
    """``tests/test_bvh.py:45`` on the port's build."""
    scene, _ = tcompile(tscenes.build_scene(sid), 8, 8)
    _, _, ids = tbuild.primitive_bounds(scene)
    bvh = tbuild.build_scene_bvh(scene)
    n, m = len(ids), len(bvh.prim)
    assert m == 2 * n - 1                      # binary tree over n leaves
    assert sorted(_leaf_reachability(bvh)) == sorted(ids.tolist())
    eps = 1e-6
    for i in range(m):
        if bvh.prim[i] < 0:
            left = i + 1
            for c in (left, int(bvh.escape[left])):
                assert (bvh.nmin[i] <= bvh.nmin[c] + eps).all()
                assert (bvh.nmax[i] >= bvh.nmax[c] - eps).all()
    assert ((bvh.escape > np.arange(m)) & (bvh.escape <= m)).all()


def test_single_primitive():
    """``tests/test_bvh.py:69`` on the port's build."""
    scene, _ = tcompile(tscenes.book1_basic(), 8, 8)
    lo, hi, ids = tbuild.primitive_bounds(scene)
    bvh = tbuild.build_bvh(lo[:1], hi[:1], ids[:1])
    assert len(bvh.prim) == 1 and bvh.prim[0] == ids[0] \
        and bvh.escape[0] == 1


def seeded_rays(scene, dtype):
    """[N_RAYS] rays (numpy seed 1984): half through the viewport from the
    camera, half from points near it in random directions; times in
    [0, 1); medium draws in (0, 1]."""
    rs = np.random.default_rng(1984)
    cam = scene.camera
    n = N_RAYS // 2
    st = rs.uniform(0.0, 1.0, (n, 2))
    org = np.asarray(cam.origin, np.float64)
    d_cam = (np.asarray(cam.lower_left, np.float64)
             + st[:, :1] * np.asarray(cam.horizontal, np.float64)
             + st[:, 1:] * np.asarray(cam.vertical, np.float64) - org)
    o = np.concatenate([np.broadcast_to(org, (n, 3)),
                        org + rs.normal(0.0, 0.5, (n, 3))])
    d = np.concatenate([d_cam, rs.normal(0.0, 1.0, (n, 3))])
    tm = rs.uniform(0.0, 1.0, N_RAYS)
    u_med = 1.0 - rs.uniform(0.0, 1.0, (N_RAYS, 4))
    return [a.astype(dtype) for a in (o, d, tm, u_med)]


def port_traverse(scene, rays):
    st = thit.scene_tensors(scene, "cpu")
    tabs = tbvh.pack_tables(st, tbuild.build_scene_bvh(scene))
    o, d, tm, _ = (torch.from_numpy(a) for a in rays)
    t, p, steps = tbvh.traverse(tabs, scene.sph_c0.shape[0], o, d, tm,
                                T_MIN)
    return t.numpy(), p.numpy(), steps


def jax_traverse(scene, meta, rays, monkeypatch):
    """JAX ``bvh_closest_hit``'s (t, winner): the record's tail is
    replaced by one that returns its geometry inputs."""
    monkeypatch.setattr(jbvh.hit_ops, "record_from_geo_winner",
                        lambda *a: (a[-2], a[-1]))
    tabs = jbvh.pack_tables(scene, jbuild.build_scene_bvh(
        scene, use_native=False))
    o, d, tm, u = (jnp.asarray(a) for a in rays)
    t, p = jbvh.bvh_closest_hit(scene, meta, tabs, o, d, tm, T_MIN,
                                u[:, :max(meta.n_media, 1)])
    return np.asarray(t), np.asarray(p)


def assert_winners(t, p, t_ref, p_ref, rtol):
    """Hit / miss equal; ``t`` within ``rtol``; a different winner only on
    an ulp tie (its ``t`` within ``rtol`` too)."""
    np.testing.assert_array_equal(p >= 0, p_ref >= 0)
    h = p >= 0
    np.testing.assert_allclose(t[h], t_ref[h], rtol=rtol, atol=0)
    assert (p != p_ref).sum() <= 2
    assert h.mean() > 0.3                 # the rays do hit things


@pytest.mark.parametrize("sid", [0, 9])
def test_traversal_matches_jax_f64(sid, monkeypatch):
    tscene, _ = tcompile(tscenes.build_scene(sid), 8, 8, dtype=np.float64)
    jscene, jmeta = jcompile(jscenes.build_scene(sid), 8, 8,
                             dtype=np.float64)
    rays = seeded_rays(tscene, np.float64)
    t, p, _ = port_traverse(tscene, rays)
    jt, jp = jax_traverse(jscene, jmeta, rays, monkeypatch)
    assert_winners(t, p, jt, jp, rtol=1e-12)


@pytest.mark.parametrize("sid", [0, 9])
def test_traversal_matches_jax_f32(sid, monkeypatch):
    tscene, _ = tcompile(tscenes.build_scene(sid), 8, 8, dtype=np.float32)
    jscene, jmeta = jcompile(jscenes.build_scene(sid), 8, 8,
                             dtype=np.float32)
    rays = seeded_rays(tscene, np.float32)
    t, p, _ = port_traverse(tscene, rays)
    jt, jp = jax_traverse(jscene, jmeta, rays, monkeypatch)
    same = p == jp
    assert same.mean() >= 0.999
    h = same & (p >= 0)
    assert h.mean() > 0.3
    np.testing.assert_allclose(t[h], jt[h], rtol=2e-4, atol=0)


@pytest.mark.parametrize("sid", [0, 9])
def test_traversal_matches_bruteforce_f64(sid):
    """The BVH winner against the port's brute-force ``closest_hit`` on the
    same rays (its record's geometry winner)."""
    scene, meta = tcompile(tscenes.build_scene(sid), 8, 8, dtype=np.float64)
    rays = seeded_rays(scene, np.float64)
    t, p, _ = port_traverse(scene, rays)
    st = thit.scene_tensors(scene, "cpu")
    o, d, tm, _ = (torch.from_numpy(a) for a in rays)
    der = thit.derive(st)
    t_s = thit.sphere_candidates(st, der.ds, o, d, tm, T_MIN)
    t_q = thit.quad_candidates(st, der.dq, o, d, T_MIN)
    t_all = torch.cat([t_s, t_q], dim=1)
    tb = t_all.amin(1)
    pb = thit.first_argmin(t_all, tb)
    pb = torch.where(tb < thit.BIG * 0.5, pb, -1)
    assert_winners(t, p, tb.numpy(), pb.numpy(), rtol=1e-12)


def test_sync_every_n_equals_every_step(monkeypatch):
    """Testing the loop condition every `SYNC_EVERY` steps changes no
    value: the extra steps leave finished lanes as they are."""
    scene, _ = tcompile(tscenes.build_scene(9), 8, 8, dtype=np.float32)
    rays = seeded_rays(scene, np.float32)
    n = tbvh.SYNC_EVERY
    assert n > 1
    t, p, steps = port_traverse(scene, rays)
    monkeypatch.setattr(tbvh, "SYNC_EVERY", 1)
    t1, p1, steps1 = port_traverse(scene, rays)
    np.testing.assert_array_equal(t, t1)
    np.testing.assert_array_equal(p, p1)
    assert steps1 > 50 and steps == -(-steps1 // n) * n


def port_frame(sid, W, H, spp, engine, **kw):
    scene, meta = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float64)
    cfg = TConfig(width=W, height=H, samples_per_pixel=spp,
                  dtype="float64", engine=engine, **kw)
    img = trender(scene, meta, cfg, device="cpu")
    assert img.dtype == np.float64 and img.shape == (H, W, 3) and img.any()
    return img


def assert_frames_close(img, ref):
    diff = np.abs(img - ref).max(axis=-1)
    assert int((diff > 1e-9).sum()) <= 2, diff.max()


@pytest.mark.parametrize("sid,spp", [(0, 2), (4, 2), (7, 2), (9, 1)])
def test_bvh_frame_matches_bruteforce(sid, spp):
    """``tests/test_bvh.py:76-90`` on the port."""
    assert_frames_close(port_frame(sid, 32, 18, spp, "bvh"),
                        port_frame(sid, 32, 18, spp, "bruteforce"))


def test_wavefront_bvh_frame_matches_bruteforce():
    """``tests/test_wavefront.py:30`` on the port."""
    kw = dict(rays_per_batch=256)
    assert_frames_close(port_frame(0, 24, 16, 2, "wavefront_bvh", **kw),
                        port_frame(0, 24, 16, 2, "bruteforce", **kw))


def test_bvh_frame_matches_jax_bvh():
    W, H = 16, 8
    scene, meta = jcompile(jscenes.build_scene(9), W, H, dtype=np.float64)
    cfg = JConfig(width=W, height=H, samples_per_pixel=1, dtype="float64",
                  engine="bvh")
    want = np.asarray(jrender(scene, meta, cfg))
    assert_frames_close(port_frame(9, W, H, 1, "bvh"), want)
