"""PyTorch port: the sharded render's shard bodies on the CPU.

Every coordinate (i, j) of a (px, sp) mesh runs in this one process
(`parallel/render.shard_sums`, no collectives); a plain sum over j and a
stack over i stand in for the all-reduce and the all-gather, and
`frame_sums` / `finish_frame` make the frame.  Two references for each
case (the shapes and scenes of ``tests/test_parallel.py``):

* the port's one-device `render`: bit-identical where the sample axis is
  not split (the same per-pixel sums in the same order), within 5e-7
  where it is (the partial sums reassociate);
* JAX's `render_sharded` on the suite's 8 virtual devices at the same
  mesh shape, within the bounds that hold the port's frames to JAX's
  (``tests/torch_render_cases.check_bounds``: XLA's FMA contraction).

Also K1's sample window (`frame_params(..., samp0=)`) on the plain
version, and `shard_work_stats` against JAX's segments.  The real
process groups are ``tests/test_torch_dist.py``'s.
"""

import jax
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops import mega2 as tmega2
from raytracinginoneweekendincuda_torch.ops.render import render as trender
from raytracinginoneweekendincuda_torch.parallel import render as tpr
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_torch.utils.config import (
    RenderConfig as TConfig,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.parallel.render import (
    make_mesh, render_sharded, shard_work_stats,
)
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from torch_render_cases import check_bounds
from torch_threads import one_torch_thread  # noqa: F401

# (engine, scene id, W, H, spp, mesh shape): tests/test_parallel.py's
CASES = {
    **{f"mega2-{s[0]}x{s[1]}": ("mega2", 4, 24, 12, 4, s)
       for s in ((8, 1), (4, 2), (2, 4))},
    **{f"bruteforce-{s[0]}x{s[1]}": ("bruteforce", 4, 32, 16, 4, s)
       for s in ((8, 1), (4, 2), (2, 4))},
    "wavefront-2x2": ("wavefront", 4, 24, 12, 4, (2, 2)),
    "wavefront_pallas-2x2": ("wavefront_pallas", 4, 24, 12, 4, (2, 2)),
    "cornell_smoke-2x2": ("bruteforce", 8, 16, 16, 2, (2, 2)),
    "simple_light-mega2-2x2": ("mega2", 5, 16, 12, 2, (2, 2)),
}


def _cfg(config, case):
    engine, _, W, H, spp, _ = case
    return config(width=W, height=H, samples_per_pixel=spp,
                  rays_per_batch=512, engine=engine)


def combine(scene, meta, cfg, shape) -> np.ndarray:
    """Every shard of ``shape`` in this process: sum over j, stack over i."""
    n_px, n_sp = shape
    rows = []
    for i in range(n_px):
        acc = None
        for j in range(n_sp):
            part = tpr.shard_sums(scene, meta, cfg, shape, (i, j),
                                  device="cpu")
            acc = part if acc is None else acc + part
        rows.append(acc)
    fb = tpr.frame_sums(cfg, shape, torch.stack(rows))
    return tpr.finish_frame(fb, cfg)


@pytest.fixture(scope="module")
def port_frames():
    out = {}

    def get(name):
        if name not in out:
            case = CASES[name]
            scene, meta = tcompile(tscenes.build_scene(case[1]), case[2],
                                   case[3], dtype=np.float32)
            cfg = _cfg(TConfig, case)
            out[name] = (np.asarray(combine(scene, meta, cfg, case[5]),
                                    np.float32),
                         np.asarray(trender(scene, meta, cfg, device="cpu"),
                                    np.float32))
        return out[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_frame_matches_the_one_device_render(name, port_frames):
    img, ref = port_frames(name)
    assert img.shape == ref.shape and img.any()
    if CASES[name][5][1] == 1:
        np.testing.assert_array_equal(img, ref)
    else:
        np.testing.assert_allclose(img, ref, atol=5e-7, rtol=5e-7)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_frame_matches_jax_render_sharded(name, port_frames):
    case = CASES[name]
    n_px, n_sp = case[5]
    mesh = make_mesh(jax.devices()[:n_px * n_sp], sample_shards=n_sp)
    scene, meta = jcompile(jscenes.build_scene(case[1]), case[2], case[3],
                           dtype=np.float32)
    ref = np.asarray(render_sharded(scene, meta, _cfg(JConfig, case), mesh),
                     np.float64)
    check_bounds(case[1], port_frames(name)[0], ref)


def test_k1_sample_window_sums_to_the_whole_frame():
    """render_radiance_plain over samples 2-3 (samp0 2) plus samples 0-1
    equals samples 0-3 within f32 reassociation; samp0 0 is the default."""
    W, H = 16, 8
    scene, meta = tcompile(tscenes.build_scene(4), W, H, dtype=np.float32)
    tab = tmega2.pack_mega2_tables(scene, meta, "cpu")
    pix = torch.arange(W * H, dtype=torch.int32)
    cfg = TConfig(width=W, height=H, samples_per_pixel=2)
    lo = tmega2.render_radiance_plain(tab, pix, tmega2.frame_params(scene,
                                                                    cfg))
    hi = tmega2.render_radiance_plain(
        tab, pix, tmega2.frame_params(scene, cfg, samp0=2))
    whole = tmega2.render_radiance_plain(tab, pix, tmega2.frame_params(
        scene, cfg.with_(samples_per_pixel=4)))
    assert not torch.equal(lo, hi)
    np.testing.assert_allclose((lo + hi).numpy(), whole.numpy(), atol=5e-7,
                               rtol=5e-7)
    assert tmega2.frame_params(scene, cfg).samp0 == 0


def test_tape_lanes_take_the_sample_window():
    pix, samp = tmega2.tape_lanes(torch.tensor([5, 9, 2]), 2, samp0=6)
    assert pix.tolist() == [5, 9, 2, 5, 9, 2]
    assert samp.tolist() == [6, 6, 6, 7, 7, 7]


def test_shard_work_stats_equal_jax_segments():
    """Path segments a px shard runs, from K2's tapes (the plain trace
    here), equal the JAX kernel's segment counters on quads 24x12@2 at
    the default (4, 2) mesh of the suite's 8 devices."""
    W, H = 24, 12
    jscene, jmeta = jcompile(jscenes.build_scene(4), W, H, dtype=np.float32)
    want, _ = shard_work_stats(jscene, jmeta, JConfig(
        width=W, height=H, samples_per_pixel=2, engine="mega2"))
    scene, meta = tcompile(tscenes.build_scene(4), W, H, dtype=np.float32)
    got = tpr.shard_work_stats(scene, meta, TConfig(
        width=W, height=H, samples_per_pixel=2, engine="mega2"),
        tpr.Mesh(4, 2, 0, "cpu"), device="cpu")
    assert got.tolist() == np.asarray(want).tolist()


def test_interleaved_shards_balance_the_work():
    """Interleaved px shards of scene 0 at 64x32@2 run path segments within
    10% of their mean (JAX's balance gate)."""
    W, H = 64, 32
    scene, meta = tcompile(tscenes.build_scene(0), W, H, dtype=np.float32)
    segs = tpr.shard_work_stats(scene, meta, TConfig(
        width=W, height=H, samples_per_pixel=2, engine="mega2"),
        tpr.Mesh(4, 2, 0, "cpu"), device="cpu").astype(float)
    assert segs.min() > 0
    assert segs.max() / segs.mean() < 1.10, segs


def test_render_sharded_without_a_process_group_is_the_one_device_frame():
    """No process group: the 1x1 mesh, no collective; engine mega and an
    spp the sample shards do not divide raise."""
    W, H = 16, 8
    scene, meta = tcompile(tscenes.build_scene(4), W, H, dtype=np.float32)
    cfg = TConfig(width=W, height=H, samples_per_pixel=2, engine="mega2")
    mesh = tpr.make_mesh(device="cpu")
    assert mesh.dims == (1, 1) and mesh.coord == (0, 0)
    img = tpr.render_sharded(scene, meta, cfg, device="cpu")
    np.testing.assert_array_equal(img, trender(scene, meta, cfg,
                                               device="cpu"))
    with pytest.raises(ValueError, match="engine 'mega'"):
        tpr.render_sharded(scene, meta, cfg.with_(engine="mega"),
                           device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tpr.shard_sums(scene, meta, cfg.with_(samples_per_pixel=3), (2, 2),
                       (0, 1), device="cpu")
    with pytest.raises(ValueError, match="process group"):
        tpr.make_mesh(world=2, device="cpu")
