"""PyTorch port on the card: each kernel against its plain PyTorch version
-- K1 (csrc/mega2_render.cu), K2 (csrc/mega2_trace.cu), K3 / K4
(csrc/replay_fwd.cu, csrc/replay_bwd.cu) against ``replay_plain`` and its
autograd, K5 (csrc/mega_bounces.cu) and K6 (csrc/closest_geo.cu).  Imports only the port (the card's machine has no JAX).  Marked
``cuda``; skipped where there is no CUDA device (the kernels have no CPU
build).  Run on a card with
``python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist``."""

import numpy as np
import pytest
import torch

import torch_texture_scenes as tex
from raytracinginoneweekendincuda_torch.core import camera
from raytracinginoneweekendincuda_torch.ops import mega, mega2, pallas_hit
from raytracinginoneweekendincuda_torch.ops.raygen import (
    camera_tuple, generate_rays,
)
from raytracinginoneweekendincuda_torch.ops.render import finalize
from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.scene import api
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _case(sid, dev, W=32, H=16, spp=2):
    desc = tex.SCENES[sid](api, camera) if sid in tex.SCENES \
        else scenes.build_scene(sid)
    scene, meta = compile_scene(desc, W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       engine="mega2")
    return mega2.pack_mega2_tables(scene, meta, dev), \
        mega2.frame_params(scene, cfg)


@pytest.mark.parametrize("sid", [*range(10), *sorted(tex.SCENES)])
def test_k1_matches_plain_on_card(sid, dev):
    """Same libdevice math, IEEE division and sqrt, no FMA contraction on
    either side: at most 1% of pixels may move by more than 1e-4, and the
    mean difference stays below 2e-3 (the bounds chip_smoke.py holds)."""
    tab, fp = _case(sid, dev)
    pix = torch.arange(fp.width * fp.height, dtype=torch.int32, device=dev)
    before = mega2.render_radiance_cuda.launches
    k1 = finalize(mega2.render_radiance(tab, pix, fp), fp.spp, True, False)
    plain = finalize(mega2.render_radiance_plain(tab, pix, fp), fp.spp,
                     True, False)
    torch.cuda.synchronize()
    assert mega2.render_radiance_cuda.launches == before + 1
    diff = (k1 - plain).abs().double().cpu().numpy()
    assert np.isfinite(k1.cpu().numpy()).all()
    assert (diff.max(-1) > 1e-4).mean() <= 0.01
    assert diff.mean() < 2e-3


def test_k1_rejects_bad_pixel_ids(dev):
    tab, fp = _case(4, dev)
    with pytest.raises(ValueError, match="int32"):
        mega2.render_radiance_cuda(
            tab, torch.zeros((2, 2), dtype=torch.int32, device=dev), fp)


# ---- the gradient path: K2 (trace), K3 / K4 (replay forward / backward)

def _trace_case(sid, dev, W=32, H=16, spp=2, K=8):
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=1,
                       max_bounces=K)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    pix, samp = mega2.tape_lanes(
        torch.arange(W * H, dtype=torch.int32, device=dev), spp)
    return tab, mega2.frame_params(scene, cfg), pix, samp


@pytest.mark.parametrize("sid", range(10))
def test_k2_matches_plain_on_card(sid, dev):
    """K2 records the plain version's winners on every lane."""
    tab, fp, pix, samp = _trace_case(sid, dev)
    before = mega2.trace_tapes_cuda.launches
    got = mega2.trace_tapes(tab, pix, samp, fp)
    want = mega2.trace_tapes_plain(tab, pix, samp, fp)
    torch.cuda.synchronize()
    assert mega2.trace_tapes_cuda.launches == before + 1
    assert got.shape == want.shape == (fp.max_bounces, pix.shape[0])
    assert (got == want).all(0).float().mean() >= 0.999


REPLAY_CASES = ["scene 0", "scene 2", "scene 3", "scene 4", "scene 8",
                "marble probe", "media probe"]


def _replay_case(name, dev, K=8):
    import torch_probe_scenes as probes

    desc = (probes.marble_probe() if name == "marble probe"
            else probes.media_probe() if name == "media probe"
            else scenes.build_scene(int(name.split()[1])))
    return probes, probes.port_trace_case(desc, K, w=32, h=16, device=dev)


def _grads(probes, case, fn, wgt):
    rays = case["rays"].clone().requires_grad_(True)
    bg = case["bg"].clone().requires_grad_(True)
    from raytracinginoneweekendincuda_torch.ops import replay as trp

    tt = trp.replay_table(
        case["scene"], case["meta"], case["tab"],
        kernel_space=mega2.mega2_kernel_id_space(case["tab"], case["meta"]))
    rep_leaf = tt.rep.detach().clone().requires_grad_(True)
    out = fn(tt._replace(rep=rep_leaf), rays, case["tape"], case["pix_ctr"],
             0, bg, t_min=probes.T_MIN)
    (out * wgt).sum().backward()
    zero = lambda g, x: torch.zeros_like(x) if g is None else g
    return (out.detach(), zero(rep_leaf.grad, rep_leaf),
            zero(rays.grad, rays), zero(bg.grad, bg))


@pytest.mark.parametrize("name", REPLAY_CASES)
def test_k3_k4_match_plain_and_autograd_on_card(name, dev):
    """K3 against replay_plain (at most 1% of lanes above 1e-4, mean <
    2e-3) and K4 against autograd of replay_plain (d_rep rel-L2 <= 1e-3;
    at most 1% of lanes whose ray cotangent differs by more than 1e-3 of
    the largest); everything finite."""
    from raytracinginoneweekendincuda_torch.ops import replay as trp
    from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc

    probes, case = _replay_case(name, dev)
    wgt = torch.rand((case["rays"].shape[0], 3),
                     generator=torch.Generator().manual_seed(0)).to(dev)
    before = (rc.replay_fwd_cuda.launches, rc.replay_bwd_cuda.launches)
    k_out, k_rep, k_rays, k_bg = _grads(probes, case, rc.replay, wgt)
    p_out, p_rep, p_rays, p_bg = _grads(probes, case, trp.replay_plain, wgt)
    torch.cuda.synchronize()
    assert (rc.replay_fwd_cuda.launches, rc.replay_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    for t in (k_out, k_rep, k_rays, k_bg):
        assert torch.isfinite(t).all()
    diff = (k_out - p_out).abs()
    assert (diff.max(1).values > 1e-4).float().mean() <= 0.01
    assert float(diff.mean()) < 2e-3
    assert float((k_rep - p_rep).norm()) <= 1e-3 * max(float(p_rep.norm()),
                                                       1e-30)
    scale = 1e-3 * max(float(p_rays.abs().max()), 1e-30)
    assert ((k_rays - p_rays).abs().max(1).values > scale).float().mean() \
        <= 0.01
    torch.testing.assert_close(k_bg, p_bg, rtol=1e-3, atol=1e-3 * max(
        float(p_bg.abs().max()), 1e-30))


def test_k4_matches_fd_of_k3(dev):
    """The marble probe's background and one albedo entry: K4's gradient
    within 5% of central FD of K3's primal (both linear in them, so FD is
    exact up to f32 rounding)."""
    from raytracinginoneweekendincuda_torch.ops import replay as trp
    from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc

    probes, case = _replay_case("marble probe", dev, K=4)
    tt = trp.replay_table(
        case["scene"], case["meta"], case["tab"],
        kernel_space=mega2.mega2_kernel_id_space(case["tab"], case["meta"]))
    rep = tt.rep.detach().clone().requires_grad_(True)
    bg = case["bg"].clone().requires_grad_(True)
    out = rc.replay(tt._replace(rep=rep), case["rays"], case["tape"],
                    case["pix_ctr"], 0, bg, t_min=probes.T_MIN)
    out.sum().backward()
    eps = 1e-2

    def primal(rep_v, bg_v):
        with torch.no_grad():
            return float(rc.replay(tt._replace(rep=rep_v), case["rays"],
                                   case["tape"], case["pix_ctr"], 0, bg_v,
                                   t_min=probes.T_MIN).double().sum())

    r0 = rep.detach()
    row = int(torch.nonzero(rep.grad[:, 17]).flatten()[0])
    for which, g in (("bg", float(bg.grad[2])),
                     ("rep", float(rep.grad[row, 17]))):
        plus, minus = r0.clone(), r0.clone()
        bp, bm = bg.detach().clone(), bg.detach().clone()
        if which == "bg":
            bp[2] += eps
            bm[2] -= eps
        else:
            plus[row, 17] += eps
            minus[row, 17] -= eps
        fd = (primal(plus, bp) - primal(minus, bm)) / (2 * eps)
        assert abs(g) > 0.0
        np.testing.assert_allclose(g, fd, rtol=5e-2)


# ---- the XLA engine family: K6 (closest geometry hit), K5 (ray pool)

def _camera_rays(scene, dev, W, H, spp):
    """Camera rays of every (pixel, sample) work item, k -> (k % W*H,
    k // W*H)."""
    k = torch.arange(W * H * spp, device=dev)
    return k, generate_rays(camera_tuple(scene.camera), k % (W * H),
                            k // (W * H), W, H, 1984)


@pytest.mark.parametrize("sid", range(10))
def test_k6_matches_plain_on_card(sid, dev):
    """Camera rays and their directions jittered (numpy seed 3): ``t``
    identical on every lane, ``prim`` on at least 99.9% of them."""
    W, H = 32, 16
    scene, _ = compile_scene(scenes.build_scene(sid), W, H, dtype=np.float32)
    sph, quad = pallas_hit.pack_geometry(scene, dev)
    _, (o, d, tm, _) = _camera_rays(scene, dev, W, H, 2)
    jit = np.random.default_rng(3).normal(0.0, 0.2, tuple(d.shape))
    d = d + d.norm(dim=1, keepdim=True) * torch.as_tensor(
        jit.astype(np.float32), device=dev)
    rays = torch.cat([o, d, tm[:, None], torch.zeros_like(tm)[:, None]],
                     dim=1).contiguous()
    before = pallas_hit.closest_geo_cuda.launches
    t, p = pallas_hit.closest_geo(rays, sph, quad, 1e-3)
    tp, pp = pallas_hit.closest_geo_plain(rays, sph, quad, 1e-3)
    torch.cuda.synchronize()
    assert pallas_hit.closest_geo_cuda.launches == before + 1
    assert t.device == dev and p.dtype == torch.int32
    assert torch.equal(t, tp)
    assert (p == pp).float().mean() >= 0.999


def test_k6_rejects_bad_inputs(dev):
    scene, _ = compile_scene(scenes.build_scene(4), 8, 8, dtype=np.float32)
    sph, quad = pallas_hit.pack_geometry(scene, dev)
    rays = torch.zeros((64, 8), device=dev)
    with pytest.raises(ValueError, match="\\[B, 8\\]"):
        pallas_hit.closest_geo_cuda(rays[:, :7].contiguous(), sph, quad, 1e-3)
    with pytest.raises(ValueError, match="rows"):
        pallas_hit.closest_geo_cuda(rays, sph[:9].contiguous(), quad, 1e-3)
    with pytest.raises(ValueError, match="f32"):
        pallas_hit.closest_geo_cuda(rays.double(), sph, quad, 1e-3)


@pytest.mark.parametrize("sid", (0, 1, 4, 6, 7, 8))
def test_k5_matches_plain_on_card(sid, dev):
    """Two calls of K = 2 bounces from a fresh 1024-lane pool: ``ri``
    equal on at least 99.9% of lanes, ``rf`` within K1's bounds."""
    W, H, spp = 32, 16, 2
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    tabs = mega.pack_mega_tables(scene, meta, dev)
    k, (o, d, tm, pc) = _camera_rays(scene, dev, W, H, spp)
    rf = torch.cat([o, d, tm[:, None], torch.ones_like(o),
                    torch.zeros_like(o)], dim=1).contiguous()
    zero = torch.zeros_like(pc)
    ri = torch.stack([pc, (k // (W * H)).to(torch.int32), zero, zero + 1],
                     dim=1).contiguous()
    kw = dict(k_bounces=2, t_min=1e-3, max_bounces=50,
              background=tuple(float(x) for x in
                               np.asarray(scene.camera.background)))
    for _ in range(2):
        before = mega.mega_bounces_cuda.launches
        rf_k, ri_k = mega.mega_bounces(rf, ri, tabs, **kw)
        rf_p, ri_p = mega.mega_bounces_plain(rf, ri, tabs, **kw)
        torch.cuda.synchronize()
        assert mega.mega_bounces_cuda.launches == before + 1
        assert (ri_k == ri_p).all(1).float().mean() >= 0.999
        diff = (rf_k - rf_p).abs().double().cpu().numpy()
        assert np.isfinite(rf_k.cpu().numpy()).all()
        assert (diff.max(-1) > 1e-4).mean() <= 0.01
        assert diff.mean() < 2e-3
        rf, ri = rf_k, ri_k


def test_xla_engines_render_on_card(dev):
    """``render`` with ``mega`` and ``wavefront_pallas`` on the card
    launches K5 / K6 and agrees with the same engines on the CPU (scene 4,
    16x8@2: quads only, no flips)."""
    from raytracinginoneweekendincuda_torch.ops.render import render

    scene, meta = compile_scene(scenes.build_scene(4), 16, 8,
                                dtype=np.float32)
    for engine, wrapper in (("mega", mega.mega_bounces_cuda),
                            ("wavefront_pallas",
                             pallas_hit.closest_geo_cuda)):
        cfg = RenderConfig(width=16, height=8, samples_per_pixel=2,
                           engine=engine)
        before = wrapper.launches
        img = render(scene, meta, cfg, device=dev)
        assert wrapper.launches > before
        np.testing.assert_allclose(img, render(scene, meta, cfg,
                                               device="cpu"),
                                   atol=1e-5, rtol=0)
