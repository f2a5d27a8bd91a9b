"""The reference BVH's walk finds the brute-force winner
(`tracer._closest`) on the rays of the reference's own paths, over both
cells' worlds.  A ray where the two differ is allowed only as a rounding
hit of the f32 sphere test (ROADMAP fault 2): the walk's winner is then
the winner in f64."""

import pytest
import torch

from rtbench import spec
from rtbench.drivers.render_loop import frame_seed, ratio
from rtbench.reference import bvh, tracer
from rtbench.reference.scenes import book1_final, bouncing_spheres

from .conftest import gpu_device

WORLDS = {"book1_final": book1_final, "bouncing_spheres": bouncing_spheres}


def path_rays(fr, pix, seed, spp):
    """(o, d, tm) of every lane-bounce of the reference's paths."""
    rays = []
    tracer.radiance(fr, pix, [seed], spp, visit=lambda *r: rays.append(r))
    return [torch.cat(x) for x in list(zip(*rays))[1:]]


def differences(fr, world, o, d, tm):
    """(rays walked, rays whose winners differ, those of them whose walk
    winner is not the f64 winner)."""
    tree = bvh.build(fr.tab)
    _, _, win = bvh.walk(tree, fr.tab, o, d, tm, fr.t_min)
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    _, brute = tracer._closest(fr.tab, o, d, tm, a, fr.t_min * a)
    off = (win != brute).nonzero()[:, 0]
    if not off.numel():
        return o.shape[0], 0, 0
    tab64 = tracer.tables(world, o.device, torch.float64)
    o64, d64, tm64 = o[off].double(), d[off].double(), tm[off].double()
    a64 = (d64 * d64).sum(1)
    _, exact = tracer._closest(tab64, o64, d64, tm64, a64, fr.t_min * a64)
    return o.shape[0], off.numel(), int((win[off] != exact).sum())


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_the_walk_finds_the_brute_force_winner(name):
    world = WORLDS[name].world()
    fr = tracer.Frame(world, 64, 36, 50, "cpu")
    pix = torch.arange(64 * 36)
    o, d, tm = path_rays(fr, pix, 2**31 + 11, 1)
    n, off, unexplained = differences(fr, world, o, d, tm)
    assert n >= 3000
    assert unexplained == 0, (off, unexplained)


def test_ratio_and_its_standard_error_by_hand():
    # lanes of 1 and 3 bounces with 2 and 4 tests: 6 / 4 = 1.5 a bounce;
    # residuals 2 - 1.5 and 4 - 4.5, so se = sqrt(0.5 * 2 / 1) / 4
    r, rel = ratio(torch.tensor([2.0, 4.0]), torch.tensor([1.0, 3.0]))
    assert r == pytest.approx(1.5)
    assert rel == pytest.approx(0.25 / 1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["book1_final.final_render",
                                      "bouncing_spheres.preview"])
def test_the_walk_finds_the_brute_force_winner_at_the_cell_size(workload):
    """Every lane-bounce that a traced run of the cell counts."""
    dev = gpu_device()
    cell = spec.load_cell(workload)
    c, lc = cell.config, cell.traffic["lane_count"]
    world = spec.reference_scene(cell)
    fr = tracer.Frame(world, c["width"], c["height"], c["max_bounces"], dev)
    pix = torch.arange(0, c["width"] * c["height"], lc["stride"], device=dev)
    o, d, tm = path_rays(fr, pix, frame_seed(4242, 1),
                         min(lc["samples"], cell.traffic["spp"]))
    tot = off = unexplained = 0
    for s in range(0, o.shape[0], 1 << 18):
        n, k, u = differences(fr, world, o[s:s + (1 << 18)],
                              d[s:s + (1 << 18)], tm[s:s + (1 << 18)])
        tot, off, unexplained = tot + n, off + k, unexplained + u
    print(f"{workload}: {tot} rays, {off} winners differ, "
          f"{unexplained} not the f64 winner")
    assert unexplained == 0
