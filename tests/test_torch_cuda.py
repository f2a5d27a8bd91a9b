"""PyTorch port on the card: each kernel against its plain PyTorch version
-- K1 (csrc/mega2_render.cu), K2 (csrc/mega2_trace.cu), K3 / K4
(csrc/replay_fwd.cu, csrc/replay_bwd.cu) against ``replay_plain`` and its
autograd, K5 (csrc/mega_bounces.cu), K6 (csrc/closest_geo.cu) and the
probes P1-P3 (csrc/probe_pair.cu, probe_intmul.cu, probe_mosaic.cu);
and the plain PyTorch paths that only the card can test: the general
train step repeating bit for bit, the BVH engines against their
brute-force twins.  Imports only the port (the card's machine has no
JAX).  Marked ``cuda``; skipped where there is no CUDA device (the
kernels have no CPU build).  Run on a card with
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
from raytracinginoneweekendincuda_torch.parallel import train
from raytracinginoneweekendincuda_torch.scene import api
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.tools import (
    probe_intmul, probe_mosaic, probe_pair,
)
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


def _assert_k1_equals_plain(tab, fp, pix):
    before = mega2.render_radiance_cuda.launches
    got = mega2.render_radiance(tab, pix, fp)
    want = mega2.render_radiance_plain(tab, pix, fp)
    torch.cuda.synchronize()
    assert mega2.render_radiance_cuda.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("sid", [*range(10), *sorted(tex.SCENES)])
def test_k1_sums_equal_plain_on_card(sid, dev):
    """K1's radiance sums are array-equal to the plain version's: the same
    arithmetic in the same order, no FMA contraction, each pixel's samples
    summed in order whichever lane renders it."""
    tab, fp = _case(sid, dev)
    _assert_k1_equals_plain(
        tab, fp, torch.arange(fp.width * fp.height, dtype=torch.int32,
                              device=dev))
    assert mega2.render_radiance_cuda.shape[2] > 0    # rows in shared memory


@pytest.mark.parametrize("ids", ["permuted", "padded", "one", "31",
                                 "ragged"])
def test_k1_sums_equal_plain_on_pixel_lists(ids, dev):
    """Pixel lists in any order, padded with -1 (zeros), shorter than a
    warp (1, 31 ids), or not a multiple of the block (389 ids, one
    repeated): array-equal to the plain version."""
    tab, fp = _case(0, dev)
    rs = np.random.default_rng(11)
    n_pix = fp.width * fp.height
    perm = rs.permutation(n_pix)
    lists = {
        "permuted": perm,
        "padded": np.insert(perm, rs.integers(0, n_pix, 64), -1),
        "one": perm[:1],
        "31": perm[:31],
        "ragged": np.append(perm[:388], perm[5]),
    }
    pix = torch.as_tensor(lists[ids].astype(np.int32), device=dev)
    _assert_k1_equals_plain(tab, fp, pix)


def test_k1_sums_equal_plain_with_lane_refill(dev):
    """More pixel ids than the persistent grid has lanes (scene 0 at
    640x360: 230,400 ids): lanes take a second and third pixel from the
    queue and reset their sums, which stay array-equal to the plain
    version's."""
    tab, fp = _case(0, dev, 640, 360, 2)
    pix = torch.arange(fp.width * fp.height, dtype=torch.int32, device=dev)
    _assert_k1_equals_plain(tab, fp, pix)
    blocks, threads, _ = mega2.render_radiance_cuda.shape
    assert blocks * threads < pix.shape[0]


def test_k1_large_world_equals_plain(dev):
    """The large world (``sphere_field``: 10,000 spheres, 643 KB of sphere
    rows) exceeds a block's shared memory: K1 reads its rows from global
    memory, culling its 157 chunks, and its sums stay array-equal to the
    plain version's."""
    w, h, spp = 16, 8, 2
    scene, meta = compile_scene(scenes.sphere_field(), w, h,
                                dtype=np.float32)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    assert tab.cull_pairs
    _assert_k1_equals_plain(
        tab, mega2.frame_params(scene, cfg),
        torch.arange(w * h, dtype=torch.int32, device=dev))
    assert mega2.render_radiance_cuda.shape[2] == 0   # rows in global memory


CULL_OFF = dict(cull_min_chunks=10 ** 9)


@pytest.mark.parametrize("n,smem", [(3200, True), (10_000, False)])
def test_k1_culled_world_equals_unculled(n, smem, dev):
    """The culled K1 on the two large worlds (rows in shared and in global
    memory): array-equal to the plain version and to K1 with the cull
    forced off."""
    w, h, spp = 32, 16, 2
    scene, meta = compile_scene(scenes.sphere_field(n), w, h,
                                dtype=np.float32)
    fp = mega2.frame_params(scene, RenderConfig(
        width=w, height=h, samples_per_pixel=spp))
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    off = mega2.pack_mega2_tables(scene, meta, dev, **CULL_OFF)
    assert tab.cull_pairs and not off.cull_pairs
    _assert_k1_equals_plain(tab, fp, pix)
    assert (mega2.render_radiance_cuda.shape[2] > 0) == smem
    np.testing.assert_array_equal(
        mega2.render_radiance_cuda(tab, pix, fp).cpu().numpy(),
        mega2.render_radiance_cuda(off, pix, fp).cpu().numpy())


@pytest.mark.parametrize("sid", (0, 9))
def test_k1_forced_cull_equals_plain(sid, dev):
    """Every chunk of scenes 0 and 9 culled: K1 array-equal to the plain
    version, which culls the same chunks ray by ray."""
    scene, meta = compile_scene(scenes.build_scene(sid), 32, 16,
                                dtype=np.float32)
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2)
    tab = mega2.pack_mega2_tables(scene, meta, dev, dense_max=0,
                                  cull_min_chunks=0)
    assert tab.cull_pairs
    _assert_k1_equals_plain(tab, mega2.frame_params(scene, cfg),
                            torch.arange(512, dtype=torch.int32, device=dev))


def test_k2_culled_world_equals_unculled(dev):
    """K2 on the 3,200-sphere world with the cull: the same tapes as K2
    without it and as the plain version, on every lane."""
    w, h, spp, K = 32, 16, 2, 8
    scene, meta = compile_scene(scenes.sphere_field(3200), w, h,
                                dtype=np.float32)
    fp = mega2.frame_params(scene, RenderConfig(
        width=w, height=h, samples_per_pixel=1, max_bounces=K))
    pix, samp = mega2.tape_lanes(
        torch.arange(w * h, dtype=torch.int32, device=dev), spp)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    off = mega2.pack_mega2_tables(scene, meta, dev, **CULL_OFF)
    assert tab.cull_pairs and not off.cull_pairs
    got = mega2.trace_tapes_cuda(tab, pix, samp, fp)
    for want in (mega2.trace_tapes_cuda(off, pix, samp, fp),
                 mega2.trace_tapes_plain(tab, pix, samp, fp)):
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


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


def test_k2_permuted_padded_lanes_match_plain_on_card(dev):
    """K2's lane queue on a permuted pixel list with padding lanes
    (pix < 0) and mixed samples (numpy seed 5): every lane's tape equals
    the plain version's, and padding lanes hold -1 throughout."""
    tab, fp, _, _ = _trace_case(4, dev)
    rs = np.random.default_rng(5)
    n = fp.width * fp.height
    ids = np.insert(rs.permutation(n), rs.integers(0, n, 97), -1)
    pix = torch.as_tensor(ids.astype(np.int32), device=dev)
    samp = torch.as_tensor(rs.integers(0, 4, ids.shape[0]).astype(np.int32),
                           device=dev)
    got = mega2.trace_tapes_cuda(tab, pix, samp, fp)
    want = mega2.trace_tapes_plain(tab, pix, samp, fp)
    assert mega2.trace_tapes_cuda.shape[2] > 0      # rows in shared memory
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (got[:, pix < 0] == -1).all()


def test_k2_rows_in_global_memory_match_plain_on_card(dev):
    """The 10,000-sphere world's rows exceed the opt-in: K2 reads them
    from global memory (culled), and its tapes equal the plain
    version's."""
    w, h, spp, K = 16, 8, 2, 8
    scene, meta = compile_scene(scenes.sphere_field(), w, h,
                                dtype=np.float32)
    fp = mega2.frame_params(scene, RenderConfig(
        width=w, height=h, samples_per_pixel=1, max_bounces=K))
    pix, samp = mega2.tape_lanes(
        torch.arange(w * h, dtype=torch.int32, device=dev), spp)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    got = mega2.trace_tapes_cuda(tab, pix, samp, fp)
    assert mega2.trace_tapes_cuda.shape[2] == 0
    want = mega2.trace_tapes_plain(tab, pix, samp, fp)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


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


@pytest.fixture(scope="module")
def k3_step_lanes():
    """Sample 0 of scene 0 at the train step's 640x360, K 8 (230,400
    lanes, more than K3's grid holds), the tape traced by K2; K3's
    inputs and the plain version's radiance on all lanes."""
    from raytracinginoneweekendincuda_torch.ops import replay as trp

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    dev = torch.device("cuda", 0)
    (tt, rays, tape, pc, bg, _), t_min = _k4_case(scenes.build_scene(0), dev,
                                                  640, 360)
    with torch.no_grad():
        plain = trp.replay_plain(tt, rays, tape, pc, 0, bg, t_min=t_min)
    return tt, rays, tape, pc, bg, t_min, plain


@pytest.mark.parametrize("n", [1, 31, 33, 4097, "all"])
def test_k3_queue_edges_match_plain_on_card(n, k3_step_lanes):
    """K3 on the first n lanes (one lane, a partial warp, a warp and one,
    more lanes than a block, and all 230,400, more than the persistent
    grid's threads, so that they refill): within K1's bounds of the plain
    version (at most 1% of lanes above 1e-4, mean < 2e-3), every lane
    written, and the grid of csrc/persistent_grid.cuh: 384-thread blocks
    (kBlock in csrc/replay_fwd.cu), or n rounded up to a warp below that,
    never more blocks than the lanes need, at most the blocks the card
    holds (two a SM: a multiple of the SMs)."""
    from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc

    tt, rays, tape, pc, bg, t_min, plain = k3_step_lanes
    n = rays.shape[0] if n == "all" else n
    out = rc.replay_fwd_cuda(tt, tt.rep.detach(), rays[:n].contiguous(),
                             tape[:, :n].contiguous(), pc[:n].contiguous(),
                             0, bg, t_min=t_min)
    torch.cuda.synchronize()
    blocks, threads, smem = rc.replay_fwd_cuda.shape
    assert smem == 0 and threads == min(-(-n // 32) * 32, 384)
    if n == rays.shape[0]:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert blocks % sms == 0 and blocks * threads < n
    else:
        assert blocks == -(-n // threads)
    assert torch.isfinite(out).all()
    diff = (out - plain[:n]).abs()
    assert (diff.max(1).values > 1e-4).float().mean() <= 0.01
    assert float(diff.mean()) < 2e-3


def test_k3_two_launches_agree_on_card(k3_step_lanes):
    """Which thread replays which lane changes from run to run; a lane's
    radiance does not: two launches bit-equal on all 230,400 lanes."""
    from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc

    tt, rays, tape, pc, bg, t_min, _ = k3_step_lanes
    a, b = (rc.replay_fwd_cuda(tt, tt.rep.detach(), rays, tape, pc, 0, bg,
                               t_min=t_min) for _ in range(2))
    assert torch.equal(a, b)


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


def _k4_case(desc, dev, w, h, K=8):
    """K4's inputs for sample 0 of a w x h frame of ``desc``, the tape
    traced by K2 (tools/kernel_times.replay_inputs)."""
    from raytracinginoneweekendincuda_torch.tools.kernel_times import (
        replay_inputs,
    )

    scene, meta = compile_scene(desc, w, h, dtype=np.float32)
    tab = mega2.pack_mega2_tables(scene, meta, dev)
    fp = mega2.frame_params(scene, RenderConfig(
        width=w, height=h, samples_per_pixel=1, max_bounces=K))
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    tape = mega2.trace_tapes_cuda(tab, pix, torch.zeros_like(pix), fp)
    return replay_inputs(scene, meta, tab, fp, pix, 0, tape, dev), fp.t_min


def test_k4_global_d_rep_matches_autograd_on_card(dev):
    """sphere_field(3200)'s table (3,264 rows) is above the opt-in, so K4
    adds d_rep into global memory: d_rep within rel-L2 1e-3 of autograd
    of replay_plain, at most 1% of lanes whose d_rays or d_bg differ by
    more than 1e-3 of the largest."""
    from raytracinginoneweekendincuda_torch.ops import replay as trp
    from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc

    (tt, rays, tape, pc, bg, g), t_min = _k4_case(scenes.sphere_field(3200),
                                                  dev, 32, 16)
    d_rep, d_rays, d_bg = rc.replay_bwd_cuda(tt, tt.rep.detach(), rays,
                                             tape, pc, 0, bg, g, t_min=t_min)
    assert rc.replay_bwd_cuda.rep_shared is False
    rep = tt.rep.detach().clone().requires_grad_(True)
    rays_p = rays.clone().requires_grad_(True)
    bg_p = bg.expand(rays.shape[0], 3).clone().requires_grad_(True)
    out = trp.replay_plain(tt._replace(rep=rep), rays_p, tape, pc, 0, bg_p,
                           t_min=t_min)
    grads = torch.autograd.grad(out, (rep, rays_p, bg_p), g,
                                allow_unused=True)
    want = [torch.zeros_like(x) if gr is None else gr
            for gr, x in zip(grads, (rep, rays_p, bg_p))]
    assert int((tape >= 0).sum()) > 0 and float(want[0].norm()) > 0.0
    for t in (d_rep, d_rays, d_bg):
        assert torch.isfinite(t).all()
    assert float((d_rep - want[0]).norm()) <= 1e-3 * float(want[0].norm())
    for got, ref in ((d_rays, want[1]), (d_bg, want[2])):
        tol = 1e-3 * float(ref.abs().max())
        assert ((got - ref).abs().max(1).values > tol).float().mean() <= 0.01


def test_k4_two_launches_agree_on_card(dev):
    """Scene 0 (d_rep in shared memory): d_rays and d_bg are per lane and
    bit-equal across launches; d_rep's atomic sum changes order from run
    to run, within rel 1e-6."""
    from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc

    (tt, rays, tape, pc, bg, g), t_min = _k4_case(scenes.build_scene(0),
                                                  dev, 64, 32)
    runs = [rc.replay_bwd_cuda(tt, tt.rep.detach(), rays, tape, pc, 0, bg, g,
                               t_min=t_min) for _ in range(2)]
    assert rc.replay_bwd_cuda.rep_shared is True
    (rep0, rays0, bg0), (rep1, rays1, bg1) = runs
    assert torch.equal(rays0, rays1) and torch.equal(bg0, bg1)
    assert float(rep0.norm()) > 0.0
    assert float((rep0 - rep1).norm()) <= 1e-6 * float(rep0.norm())


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


@pytest.mark.parametrize("world,staged", [("scene 9", True),
                                          ("sphere_field", False)])
def test_k6_shared_and_global_tables_match_plain_on_card(world, staged,
                                                         dev):
    """Scene 9's tables (the largest reference tables, 200 KB of staged
    rows) go to shared memory; ``sphere_field()``'s 10,001 spheres exceed
    the opt-in and are read from global memory.  Both: ``t`` identical to
    the plain version on every lane, ``prim`` on at least 99.9%."""
    W, H = 32, 16
    desc = scenes.build_scene(9) if staged else scenes.sphere_field()
    scene, _ = compile_scene(desc, W, H, dtype=np.float32)
    sph, quad = pallas_hit.pack_geometry(scene, dev)
    _, (o, d, tm, _) = _camera_rays(scene, dev, W, H, 2)
    rays = torch.cat([o, d, tm[:, None], torch.zeros_like(tm)[:, None]],
                     dim=1).contiguous()
    t, p = pallas_hit.closest_geo_cuda(rays, sph, quad, 1e-3)
    assert (pallas_hit.closest_geo_cuda.shape[2] > 0) == staged
    tp, pp = pallas_hit.closest_geo_plain(rays, sph, quad, 1e-3)
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


@pytest.mark.parametrize("k_bounces", (1, 2))
@pytest.mark.parametrize("n", (1, 33, 8192))
@pytest.mark.parametrize("sid", (0, 8))
def test_k5_pools_with_inactive_rays_on_card(sid, n, k_bounces, dev):
    """K5 (a warp a ray) on pools of 1, 33 and 8192 rays, every third ray
    inactive: inactive rays come back unchanged, and against the plain
    version ``ri`` is equal on at least 99.9% of rays and ``rf`` within
    K1's bounds (chip_smoke.py phase 11's)."""
    W, H, spp = 64, 32, 4
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    tabs = mega.pack_mega_tables(scene, meta, dev)
    k, (o, d, tm, pc) = _camera_rays(scene, dev, W, H, spp)
    rf = torch.cat([o, d, tm[:, None], torch.ones_like(o),
                    torch.zeros_like(o)], dim=1)[:n].contiguous()
    live = (torch.arange(n, device=dev) % 3 != 2).to(torch.int32)
    ri = torch.stack([pc, (k // (W * H)).to(torch.int32),
                      torch.zeros_like(pc), torch.ones_like(pc)],
                     dim=1)[:n].clone()
    ri[:, 3] = live
    kw = dict(k_bounces=k_bounces, t_min=1e-3, max_bounces=50,
              background=tuple(float(x) for x in
                               np.asarray(scene.camera.background)))
    for _ in range(2):
        before = mega.mega_bounces_cuda.launches
        rf_k, ri_k = mega.mega_bounces(rf, ri, tabs, **kw)
        rf_p, ri_p = mega.mega_bounces_plain(rf, ri, tabs, **kw)
        torch.cuda.synchronize()
        assert mega.mega_bounces_cuda.launches == before + 1
        off = ri[:, 3] == 0
        assert torch.equal(rf_k[off], rf[off]) and torch.equal(ri_k[off],
                                                               ri[off])
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


# ---- the probes P1-P3 (tools/probe_pair.py, probe_intmul.py,
#      probe_mosaic.py): each kernel against its plain version at the
#      probe's TPU shape

@pytest.mark.parametrize("variant", probe_pair.VARIANTS)
def test_probe_pair_matches_plain_on_card(variant, dev):
    """Bit-equal (NaN where the plain version has NaN): the plain version
    sums the dots in the kernel's order and neither contracts FMAs.  C 512,
    SUB 8 (REP cut to 3), on both blocks of a two-copy launch."""
    coef, ray = probe_pair.make_inputs(512, 8, dev)
    before = probe_pair.probe_pair_cuda.launches
    got = probe_pair.probe_pair_cuda(coef, ray, variant, 3, copies=2)
    want = probe_pair.probe_pair_plain(coef, ray, variant, 3).cpu().numpy()
    torch.cuda.synchronize()
    assert probe_pair.probe_pair_cuda.launches == before + 1
    for block in got.cpu().numpy():
        np.testing.assert_array_equal(block, want)


@pytest.mark.parametrize("flavour", probe_intmul.FLAVOURS)
def test_probe_intmul_matches_plain_on_card(flavour, dev):
    x = probe_intmul.make_input(dev)
    got = probe_intmul.intmul_chain_cuda(x, flavour, 50, copies=2)
    want = probe_intmul.intmul_chain_plain(x, flavour, 50)
    torch.cuda.synchronize()
    for block in got:
        assert torch.equal(block.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("inputs", ["tool", "random"])
@pytest.mark.parametrize("name", list(probe_mosaic.CASES))
def test_probe_mosaic_matches_plain_on_card(name, inputs, dev):
    """Bit-equal; trig within 2 ulp (the kernel's acosf / atan2f against
    PyTorch's).  On the tool's inputs and on the case's seeded random
    ones, where operands, ids and indices vary."""
    case = probe_mosaic.CASES[name]
    args = (case.inputs if inputs == "tool" else case.random)(dev)
    before = case.cuda.launches
    got = case.dispatch(*args).cpu().numpy()
    want = case.plain(*args).cpu().numpy()
    assert case.cuda.launches == before + 1
    if name == "trig":
        assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tool,argv", [
    (probe_pair, ["64", "2", "8", "full,wide8_dotsonly,direct"]),
    (probe_intmul, ["--iters", "100"]),
    (probe_mosaic, [])], ids=["probe_pair", "probe_intmul", "probe_mosaic"])
def test_probe_tools_run_on_card(tool, argv, dev):
    assert tool.main(argv)


def test_general_step_matches_cpu_on_card(dev):
    """One step of ``make_train_step`` (engines taped and scan) on the card
    and on the CPU from the same parameters, scene 4 at 12x8@2, K 4, Adam
    lr 0.05: the loss within rel 1e-5 and every leaf after the step within
    rtol 1e-5 (chip_smoke.py phase 15's gate (b)4)."""
    scene, meta = compile_scene(scenes.build_scene(4), 12, 8,
                                dtype=np.float32)
    start = scene._replace(tex_c0=np.clip(
        np.asarray(scene.tex_c0) * 0.5 + 0.2, 0.0, 1.0).astype(np.float32))
    cfg = RenderConfig(width=12, height=8, samples_per_pixel=2,
                       max_bounces=4)
    target = np.random.default_rng(4).random((96, 3)).astype(np.float32)
    for engine in ("taped", "scan"):
        out = []
        for where in ("cpu", dev):
            state = train.init_state(
                start, lambda ps: torch.optim.Adam(ps, lr=0.05),
                device=where)
            step = train.make_train_step(start, meta, cfg, engine=engine)
            state, loss = step(state, start, np.arange(96),
                               torch.as_tensor(target, device=where))
            out.append((float(loss), [p.detach().cpu() for p in
                                      train.parameter_list(state.params)]))
        (l_c, p_c), (l_g, p_g) = out
        np.testing.assert_allclose(l_g, l_c, rtol=1e-5, err_msg=engine)
        for g, c in zip(p_g, p_c):
            torch.testing.assert_close(g, c, rtol=1e-5, atol=0)


@pytest.mark.parametrize("engine", ["taped", "scan"])
def test_general_step_repeats_on_card(engine, dev):
    """One ``make_train_step`` step run twice from the same parameters on
    the card, scene 0 at 128x72@2, K 4 (most lanes on the ground sphere's
    row): loss, every gradient and every leaf after Adam bit-identical
    (the winner reads' backward, ``hit.row_sum``, adds in an order fixed
    by the data)."""
    W, H = 128, 72
    scene, meta = compile_scene(scenes.build_scene(0), W, H,
                                dtype=np.float32)
    start = scene._replace(tex_c0=np.clip(
        np.asarray(scene.tex_c0) * 0.5 + 0.2, 0.0, 1.0).astype(np.float32))
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2,
                       max_bounces=4)
    target = torch.as_tensor(np.random.default_rng(0).random(
        (W * H, 3)).astype(np.float32), device=dev)
    runs = []
    for _ in range(2):
        state = train.init_state(start, lambda ps: torch.optim.Adam(
            ps, lr=1e-2), device=dev)
        step = train.make_train_step(start, meta, cfg, engine=engine)
        state, loss = step(state, start, np.arange(W * H), target)
        leaves = train.parameter_list(state.params)
        runs.append((float(loss), [p.detach().clone() for p in leaves],
                     [torch.zeros_like(p) if p.grad is None else p.grad
                      for p in leaves]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sid", [0, 4, 9])
def test_bvh_engines_match_bruteforce_on_card(sid, dev):
    """``bvh`` / ``wavefront_bvh`` against the card's ``bruteforce`` /
    ``wavefront`` frames at f64, 16x8@1, max_bounces 8: at most 2 pixels
    above 1e-9 (tests/test_torch_bvh.py's bound)."""
    from raytracinginoneweekendincuda_torch.ops.render import render

    scene, meta = compile_scene(scenes.build_scene(sid), 16, 8,
                                dtype=np.float64)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1,
                       max_bounces=8, dtype="float64")
    img = {e: render(scene, meta, cfg.with_(engine=e), device=dev)
           for e in ("bruteforce", "bvh", "wavefront", "wavefront_bvh")}
    for got, want in (("bvh", "bruteforce"), ("wavefront_bvh", "wavefront")):
        diff = np.abs(img[got] - img[want]).max(-1)
        assert img[got].any() and int((diff > 1e-9).sum()) <= 2, got
