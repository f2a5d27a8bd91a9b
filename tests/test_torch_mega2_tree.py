"""PyTorch port: the sphere tree K1 walks (``ops/mega2.sphere_tree``, the
walk ``sphere_walk`` in ``csrc/mega2_bounce.cuh``), on the CPU.

The tree holds every sphere row but the oversized prefix in exactly one
leaf; each node's f32 box holds its rows' f64 boxes, swept over their
motion, and its children's boxes.  The kernel's walk, emulated op for op
in numpy (``tools/tree_walk.walk``), finds the winner of the loop over
every row (the plain version's ``_closest_spheres``) on seeded rays of
every bounce of the benchmark cells' worlds; where the two could differ,
the loop's winner is a rounding hit, a sphere its ray misses in f64 (the
rounding world of ``torch_field_scene``).  An equal key goes to the lower
row, as the loop's strict < in row order gives it.
"""

import types

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.core.camera import Camera
from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.scene import api
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.tools import tree_walk
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from torch_field_scene import ROUNDING_RAY, rounding_world
from torch_threads import one_torch_thread  # noqa: F401

WORLDS = {"book1_final": scenes.book1_final,
          "bouncing_spheres": lambda: scenes.build_scene(0)}


def _tables(world, w=48, h=27, **kw):
    scene, meta = compile_scene(WORLDS[world](), w, h, dtype=np.float32)
    return scene, mega2.pack_mega2_tables(scene, meta, "cpu", **kw)


def _leaves(nodes, n):
    """Each leaf's rows, in heap order of the leaves."""
    return [list(range(int(nodes[h, 6]), int(nodes[h, 6] + nodes[h, 7])))
            for h in range(n, 2 * n)]


def _row_boxes(sph):
    """f64 boxes [rows, 2, 3] of packed sphere rows, swept over c0 .. c0 +
    dc."""
    c1 = sph[:, 0:3] + sph[:, 3:6]
    r = sph[:, 8:9]
    return np.stack([np.minimum(sph[:, 0:3], c1) - r,
                     np.maximum(sph[:, 0:3], c1) + r], 1)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_the_packer_builds_the_tree_over_the_rows_after_the_prefix(world):
    _, tab = _tables(world)
    ns = int((tab.sph[:, 9] > 0.5).sum())
    assert (tab.tree_p0, tab.tree_n) == (1, -(-(ns - 1) // mega2.TREE_LEAF))
    assert tab.sph[0, 8] == 1000.0              # the ground, tested first
    assert tab.tree.shape == (2 * tab.tree_n, mega2.TREE_COLS)
    assert tab.tree.dtype == torch.float32 and tab.tree.is_contiguous()


@pytest.mark.parametrize("rows,leaf", [(483, 1), (483, 2), (9, 4), (1, 1),
                                       (64, 1), (5, 2)])
def test_every_row_lies_in_exactly_one_leaf(rows, leaf):
    """(a) The leaves, read left to right, hold rows p0 .. p0 + rows - 1
    once each, in order (so every internal node holds a run of rows)."""
    _, tab = _tables("bouncing_spheres")
    sph = tab.sph.double().numpy()[:1 + rows]
    nodes, n = mega2.sphere_tree(sph, 1, 1 + rows, leaf)
    assert n == -(-rows // leaf)

    def dfs(h):
        return _leaves(nodes, n)[h - n] if h >= n else dfs(2 * h) + \
            dfs(2 * h + 1)
    assert dfs(1) == list(range(1, 1 + rows))
    assert sorted(sum(_leaves(nodes, n), [])) == list(range(1, 1 + rows))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_every_box_holds_its_rows_and_its_children(world):
    """(b) Each node's f32 box holds the f64 boxes of its rows, swept over
    their motion, and its children's boxes; the moving spheres of scene 0
    are among them."""
    scene, tab = _tables(world)
    nodes, n = tab.tree.double().numpy(), tab.tree_n
    sph = tab.sph.double().numpy()
    # the f64 rows of the scene itself, not their f32 copies
    order = tab.remap[:tab.s_pad].numpy()
    act = order >= 0
    sph[act, 0:3] = np.asarray(scene.sph_c0, np.float64)[order[act]]
    sph[act, 3:6] = np.asarray(scene.sph_dc, np.float64)[order[act]]
    sph[act, 8] = np.asarray(scene.sph_rad, np.float64)[order[act]]
    if world == "bouncing_spheres":
        assert (np.abs(sph[act, 3:6]).sum(1) > 0).sum() > 100
    boxes = _row_boxes(sph)
    rows = {h: r for h, r in zip(range(n, 2 * n), _leaves(nodes, n))}
    for h in range(n - 1, 0, -1):
        rows[h] = rows[2 * h] + rows[2 * h + 1]
        for c in (2 * h, 2 * h + 1):
            assert (nodes[h, 0:3] <= nodes[c, 0:3]).all(), (h, c)
            assert (nodes[h, 3:6] >= nodes[c, 3:6]).all(), (h, c)
    for h in range(1, 2 * n):
        b = boxes[rows[h]]
        assert (nodes[h, 0:3] < b[:, 0].min(0)).all(), h
        assert (nodes[h, 3:6] > b[:, 1].max(0)).all(), h


def _rays(tab, scene, stride, samples=2):
    fp = mega2.frame_params(scene, RenderConfig(
        width=48, height=27, samples_per_pixel=samples, max_bounces=50,
        seed=4242))
    pix = torch.arange(0, 48 * 27, stride, dtype=torch.int32)
    return fp, tree_walk.path_rays(tab, fp, pix)


def _f64_misses(tab, rows, o, d, tm):
    """Whether each ray misses its row's sphere in f64 (a rounding hit)."""
    sph = tab.sph.double().numpy()[rows]
    o, d = o.astype(np.float64), d.astype(np.float64)
    c = sph[:, 0:3] + ((tm.astype(np.float64) - sph[:, 6]) * sph[:, 7])[
        :, None] * sph[:, 3:6]
    oc = o - c
    b = (oc * d).sum(1)
    return b * b - (d * d).sum(1) * ((oc * oc).sum(1) - sph[:, 8] ** 2) < 0


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_the_walk_finds_the_winner_of_every_row(world):
    """(c) On the rays of every bounce of 972 paths (primary rays and the
    plain version's later bounces, ~2,200 lane-bounces), the emulated walk
    finds the loop's (key, row) on every ray, and tests far fewer rows."""
    scene, tab = _tables(world)
    fp, rays = _rays(tab, scene, stride=4, samples=3)
    assert len(rays) > 3
    n_rays = tests = 0
    for o, d, tm in rays:
        w = tree_walk.walk(tab, o, d, tm, fp.t_min)
        key, row = tree_walk.brute_force(tab, o, d, tm, fp.t_min)
        differ = w["row"] != row
        # a difference may only be a rounding hit of the loop's
        assert _f64_misses(tab, row[differ], o[differ], d[differ],
                           tm[differ]).all()
        np.testing.assert_array_equal(w["key"][~differ], key[~differ])
        assert not differ.any()
        n_rays += o.shape[0]
        tests += int((w["boxes"] + w["spheres"]).sum())
    assert n_rays > 1800
    assert tests / n_rays < 0.2 * tab.s_pad


def test_a_rounding_hit_is_the_only_winner_the_walk_may_not_find():
    """(c) The rounding world (``torch_field_scene``: 65 spheres, two
    chunks, so a tree): the loop's f32 test reports a hit on a sphere the
    ray misses in f64; the walk does not meet that sphere's box before the
    ground and keeps the ground, the ray's f64 winner."""
    scene, meta = compile_scene(rounding_world(api, Camera), 8, 4,
                                dtype=np.float32)
    tab = mega2.pack_mega2_tables(scene, meta, "cpu")
    assert tab.tree_n > 0 and not tab.cull_pairs
    o, d, tm = ROUNDING_RAY[None, 0:3], ROUNDING_RAY[None, 3:6], \
        ROUNDING_RAY[None, 6]
    t_min = float(np.float32(1e-3))
    w = tree_walk.walk(tab, o, d, tm, t_min)
    _, row = tree_walk.brute_force(tab, o, d, tm, t_min)
    assert int(tab.remap[row[0]]) == 64 and w["row"][0] == 0
    assert _f64_misses(tab, row, o, d, tm).all()


def test_an_equal_key_goes_to_the_lower_row():
    """(d) Three spheres, the ray along +x from the origin: rows 1 and 2
    are hit at exactly t = 4 (keys equal in f32), row 0 is missed.  Row 2's
    box is met first (x = 2), so the walk tests it before row 1; the lower
    row 1 still wins, as in the loop over every row."""
    spheres = [((5.0, -10.0, 0.0), 1.0), ((5.0, 0.0, 0.0), 1.0),
               ((7.0, 4.0, 0.0), 5.0)]
    sph = np.zeros((64, mega2.SPH_COLS))
    for k, (c, r) in enumerate(spheres):
        sph[k, 0:3], sph[k, 8], sph[k, 9] = c, r, 1.0
        sph[k, 10] = np.float32(r) * np.float32(r)
    nodes, n = mega2.sphere_tree(sph, 0, 3)
    assert [_leaves(nodes, n)[h - n] for h in (3, 4, 5)] == [[2], [0], [1]]
    tab = types.SimpleNamespace(
        sph=torch.as_tensor(sph, dtype=torch.float32),
        tree=torch.as_tensor(nodes), tree_p0=0, tree_n=n, s_pad=64,
        cull_pairs=False, cull_s=None)
    o = np.zeros((1, 3), np.float32)
    d = np.array([[1.0, 0.0, 0.0]], np.float32)
    tm = np.zeros(1, np.float32)
    w = tree_walk.walk(tab, o, d, tm, 1e-3)
    key, row = tree_walk.brute_force(tab, o, d, tm, 1e-3)
    assert (key[0], row[0]) == (4.0, 1)
    assert (w["key"][0], w["row"][0]) == (4.0, 1)
    assert w["spheres"][0] == 2      # row 2, then row 1 (row 0's box is
                                     # not met)


@pytest.mark.parametrize("n,kw,tree", [
    (40, {}, False),                           # one sphere chunk
    (100, {}, True),                           # two chunks
    (3200, {}, False),                         # culled
    (3200, {"cull_min_chunks": 10 ** 9}, True),   # the cull forced off
])
def test_the_tree_goes_to_unculled_worlds_of_several_sphere_chunks(n, kw,
                                                                   tree):
    scene, meta = compile_scene(scenes.sphere_field(n), 8, 4,
                                dtype=np.float32)
    tab = mega2.pack_mega2_tables(scene, meta, "cpu", **kw)
    assert (tab.tree_n > 0) == tree
    if tree:
        assert tab.tree_n == n                  # the ground is the prefix
