"""The Book 2 cell `final_scene.frame` on the CPU at a tiny size: whole
runs through the program's plain path, the control, the Book 2 BVH's
winners against the brute force's, the readers and the roofline by hand,
and a run whose earth image cannot be decoded failing; at the cell's
size on the card (marked ``cuda``) the control and the walk's winners."""

import io
import json

import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as port_scenes
from rtbench import spec
from rtbench.control import control
from rtbench.drivers.render_loop import frame_seed
from rtbench.reference.book2 import bvh, tracer
from rtbench.reference.tracer import BIG
from rtbench.reference.scenes import final_scene
from rtbench.roofline import k1, k1_world
from rtbench.run import main
from rtbench.trace import Window

from .conftest import gpu_device
from .test_rtbench_imports import PORT, loaded_after

CELL = "final_scene.frame"


def run(root, seed=2**31 + 5, trace=0, seconds=0.2):
    buf = io.StringIO()
    assert main(["--workload", CELL, "--seed", str(seed), "--seconds",
                 str(seconds), "--trace", str(trace)], root=root,
                device="cpu", out=buf) == 0
    return json.loads(buf.getvalue().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_end_to_end(tiny_root, trace):
    line = run(tiny_root, trace=trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["check"]) == {"u8_mean_abs", "pixels_off_pct",
                                  "frames_missing"}
    if trace:
        # the CPU has no device trace: its readers find nothing
        assert line["metrics"] == {}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"rays_per_s", "setup_s"}
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"]


def test_a_frame_without_its_image_fails(tiny_root, monkeypatch):
    """The port's scene compiled without the earth's image data (its file
    could not be decoded): every frame is failed and the run not correct,
    where the port would render its debug colour."""
    real = port_scenes.final_scene
    monkeypatch.setattr(port_scenes, "final_scene", lambda: real(
        image_path="no/such/earthmap.jpg"))
    line = run(tiny_root)
    assert line["failed"] == line["attempted"] >= 1
    assert line["correct"] is False


def test_the_reference_raises_without_its_image(tmp_path):
    with pytest.raises(RuntimeError, match="cannot decode"):
        final_scene.world(image_path=str(tmp_path / "missing.jpg"))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(RuntimeError, match="cannot decode"):
        final_scene.world(image_path=str(bad))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tiny_root, seed):
    res = control(CELL, seed, 4, root=tiny_root, device="cpu")
    assert res["correct"] is False
    assert res["check"]["u8_mean_abs"]["value"] > 1.0


def test_a_dry_run_loads_no_jax(tiny_root):
    code = ("import io\nfrom rtbench.run import main\n"
            f"assert main(['--workload', {CELL!r}, '--seed', '3', "
            f"'--seconds', '0.1', '--trace', '1'], root={tiny_root!r}, "
            "device='cpu', out=io.StringIO()) == 0\n")
    names = loaded_after(code)
    assert PORT in names
    assert not names & {"jax", "jaxlib", "flax",
                        "raytracinginoneweekendincuda_tpu"}


def path_rays(fr, pix, seed, spp):
    """Each bounce's rays of the reference's paths: [(o, d, tm, pix_ctr,
    samp, bounce)]."""
    rays = []
    tracer.radiance(fr, pix, [seed], spp,
                    visit=lambda lanes, *r: rays.append(r))
    return rays


def _path_to(tree, leaf):
    parent = {}
    for i, (le, ri) in enumerate(zip(tree.left.tolist(),
                                     tree.right.tolist())):
        if le >= 0:
            parent[le] = parent[ri] = i
    path = [leaf]
    while path[-1] in parent:
        path.append(parent[path[-1]])
    return path


def _leaf_of(tree, tab, row):
    """The tree node of the hittable that holds surface or medium row
    ``row``."""
    S, Q = tab.s_c0.shape[0], tab.q_n.shape[0]
    kind, ref, size = tree.kind, tree.ref, tree.size
    if row < S:
        hold = ((kind == bvh.SPHERE) & (ref == row)) | (
            (kind == bvh.INSTANCE) & (ref <= row) & (row < ref + size))
    elif row < S + Q:
        hold = (kind == bvh.QUAD) & (ref == row - S)
    elif row < tab.rows:
        hold = (kind == bvh.BOX) & (ref == (row - S - Q) // 6)
    else:
        hold = (kind == bvh.MEDIUM) & (ref == row - tab.rows)
    return int(hold.nonzero()[0, 0])


def _slab(lo, hi, o, d, t_min, t_max):
    """The walk's slab test (AABB.h:68-98) in the dtype of its inputs."""
    inv = 1.0 / d
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    a = torch.tensor(t_min, dtype=o.dtype)
    b = torch.tensor(t_max, dtype=o.dtype)
    for k in range(3):
        a, b = torch.fmax(a, near[k]), torch.fmin(b, far[k])
    return bool(b > a)


def differences(fr, world, tree, rays):
    """(rays walked, rays whose winners differ, those of them not
    explained).  A difference is explained only where the walk missed the
    brute force's winner because a box on the way to its leaf misses the
    ray in the walk's f32 slab test though it meets it in f64 (the
    rounding of a thin box: a flat quad's box is padded to 1e-4 only,
    Quad.h:43-48, AABB.h:114-120), or where the walk's winner is the
    brute force's winner in f64 (a rounding hit of an f32 test, ROADMAP
    fault 2)."""
    fr64 = tracer.Frame(world, fr.width, fr.height, fr.max_bounces,
                        fr.device, torch.float64)
    tot = off = 0
    unexplained = []
    for o, d, tm, pix_ctr, samp, b in rays:
        _, win, t_walk = bvh.walk(tree, fr, o, d, tm, pix_ctr, samp,
                                  torch.full_like(pix_ctr, b))
        _, _, t, brute, _, _ = tracer.closest(fr, o, d, tm, pix_ctr, samp, b)
        tot += o.shape[0]
        for i in (win != brute).nonzero()[:, 0].tolist():
            off += 1
            path = _path_to(tree, _leaf_of(tree, fr.tab, int(brute[i])))
            misses32 = [not _slab(tree.lo[n], tree.hi[n], o[i], d[i],
                                  fr.t_min, BIG) for n in path]
            meets64 = [_slab(tree.lo[n].double(), tree.hi[n].double(),
                             o[i].double(), d[i].double(), fr.t_min, BIG)
                       for n in path]
            exact = tracer.closest(fr64, o[i:i + 1].double(),
                                   d[i:i + 1].double(), tm[i:i + 1].double(),
                                   pix_ctr[i:i + 1], samp[i:i + 1], b)[3]
            if int(exact) != int(win[i]) and not any(
                    m32 and m64 for m32, m64 in zip(misses32, meets64)):
                unexplained.append(dict(
                    o=o[i].tolist(), d=d[i].tolist(), bounce=b,
                    walk=(int(win[i]), float(t_walk[i])),
                    brute=(int(brute[i]), float(t[i]))))
    return tot, off, unexplained


def test_the_walk_finds_the_brute_force_winner():
    world = final_scene.world()
    fr = tracer.Frame(world, 48, 24, 50, "cpu")
    rays = path_rays(fr, torch.arange(48 * 24), 2**31 + 11, 2)
    tot, off, unexplained = differences(fr, world, bvh.build(world, "cpu"),
                                        rays)
    assert tot >= 5000
    assert not unexplained, (off, unexplained)


def test_the_tree_and_its_leaves():
    """410 top-level hittables (400 boxes, the light, six spheres, the two
    media, the cluster): 819 nodes; a leaf names its tracer rows."""
    world = final_scene.world()
    tree = bvh.build(world, "cpu")
    leaf = tree.kind >= 0
    assert int(leaf.sum()) == 410 and tree.kind.shape[0] == 819
    kinds = tree.kind[leaf].tolist()
    assert [kinds.count(k) for k in range(5)] == [6, 1, 400, 2, 1]
    inst = (tree.kind == bvh.INSTANCE).nonzero()[0, 0]
    assert int(tree.size[inst]) == 1000 and int(tree.ref[inst]) == 6
    tab = tracer.tables(world, "cpu")
    assert (tab.s_c0.shape[0], tab.q_n.shape[0], tab.b_lo.shape[0],
            len(tab.media), tab.rows) == (1006, 1, 400, 2, 1006 + 1 + 2400)


def test_one_ray_by_hand():
    """Straight down onto the middle of a ground box from above the
    scene: its top face (+y, face 4) at the box's height, a box test at
    every node down to it, the box's six quad tests, and the mist's
    medium test (its box holds every point of the scene)."""
    world = final_scene.world()
    fr = tracer.Frame(world, 4, 2, 50, "cpu")
    tree = bvh.build(world, "cpu")
    box = world.hittables[0]                   # x, z in [-1000, -900]
    top = box.corners()[1][1]
    o = torch.tensor([[-950.0, 700.0, -950.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]])
    z = torch.zeros(1, dtype=torch.int32)
    tests, win, t = bvh.walk(tree, fr, o, d, torch.zeros(1), z, z, z)
    assert int(win) == 1006 + 1 + 4 and float(t) == pytest.approx(
        700.0 - top, rel=1e-6)
    assert [int(x) for x in tests[2:]] == [6, 1, 0]
    assert int(tests[0]) >= 10 and int(tests[1]) == 0


def test_the_roofline_by_hand():
    tests = {"box_tests": 40, "sphere_tests": 100, "quad_tests": 3,
             "medium_tests": 1.5, "instance_entries": 0.5}
    ops = 40 * 28 + 100 * 26 + 3 * 57 + 1.5 * 76 + 0.5 * 30 + 100
    assert k1_world.ops_per_lane_bounce(tests) == pytest.approx(ops)
    by = (1006 + 2401) * 56 * 4 + 2 * 22 * 4 + 819 * 32 + 1000 + 10 * 16
    assert k1_world.launch_bytes(1006, 2401, 2, 819, 1000, 10) == by
    s, what = k1_world.bound(1006, 2401, 2, 819, 1000, 10, 1e9, tests)
    assert s == pytest.approx(max(1e9 * ops / 67e12, by / 3.35e12))
    assert what == "operations"
    assert k1_world.OPS["box_tests"] == k1.OPS_NODE
    assert tuple(k1_world.OPS) == bvh.COUNTS     # the count's names


def test_the_readers_by_hand(monkeypatch):
    from raytracinginoneweekendincuda_torch.utils import tracing
    cell = spec.load_cell(CELL)
    tests = {"box_tests": 40, "sphere_tests": 100, "quad_tests": 3,
             "medium_tests": 1.5, "instance_entries": 0.5}
    counts = {"frames": 2, "spheres": 1006, "quads": 2401, "media": 2,
              "ref_bvh_nodes": 819, "texture_bytes": 1000, "pixels": 10,
              "lane_bounces_per_frame": 67e9,
              **{f"ref_{k}_per_lane_bounce": v for k, v in tests.items()}}
    frame_s = 67e9 * k1_world.ops_per_lane_bounce(tests) / 67e12
    win = Window(6.0, [("mega2_render_kernel", 0.0, 40 * frame_s)], [],
                 counts)
    read = spec.metric_reader(cell, "k1_world_roofline").read
    assert read(win) == pytest.approx(5.0)
    assert read(Window(6.0, [], [], counts)) is None
    rows = spec.metric_reader(cell, "k1_untreed_rows").read
    monkeypatch.setattr(tracing, "_counts", {
        "k1_tree_prefix_rows": 0, "k1_loose_quad_rows": 192,
        "k1_slab_rows": 1344, "k1_media": 6, "k1_tree_launches": 3})
    assert rows(win) == pytest.approx(514.0)
    assert rows(Window(6.0, [], [], counts)) is None
    monkeypatch.setattr(tracing, "_counts", {"k1_tree_launches": 3})
    assert rows(win) is None


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card_at_the_cell_size():
    dev = gpu_device()
    for seed in (1, 2, 3):
        assert control(CELL, seed, 20, device=dev)["correct"] is False


@pytest.mark.cuda
def test_the_walk_finds_the_brute_force_winner_at_the_cell_size():
    """Every lane-bounce that a traced run of the cell counts."""
    dev = gpu_device()
    cell = spec.load_cell(CELL)
    c, lc = cell.config, cell.traffic["lane_count"]
    world = spec.reference_scene(cell)
    fr = tracer.Frame(world, c["width"], c["height"], c["max_bounces"], dev)
    pix = torch.arange(0, c["width"] * c["height"], lc["stride"], device=dev)
    rays = path_rays(fr, pix, frame_seed(4242, 1),
                     min(lc["samples"], cell.traffic["spp"]))
    tot, off, unexplained = differences(fr, world, bvh.build(world, dev),
                                        rays)
    print(f"{CELL}: {tot} rays, {off} winners differ, {len(unexplained)} "
          f"not explained by a thin box's f32 slab test: {unexplained}")
    assert not unexplained
