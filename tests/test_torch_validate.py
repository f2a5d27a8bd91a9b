"""PyTorch port: the on-card validation and the reference benchmarks
(``tools/validate_gpu.py``, ``validate_replay_gpu.py``,
``make_validation.py``, ``bench_northstar.py``, ``utils/benchmark.py
--all``) held against the JAX package on the CPU, with the plain
versions, at small sizes; and every such entry point raises without a
card."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.tools import (
    bench_northstar, make_validation, validate_gpu, validate_replay_gpu,
)
from raytracinginoneweekendincuda_torch.utils import benchmark
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops import replay as jreplay
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils import benchmark as jbenchmark
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from test_golden import GOLDEN
from torch_render_cases import MAX_BAD, NOISE_IMAGE, check_bounds
from torch_threads import one_torch_thread  # noqa: F401


def test_reference_table_equals_jax():
    assert benchmark.REFERENCE_TABLE == jbenchmark.REFERENCE_TABLE
    assert benchmark.BASELINE_RAYS_PER_S == jbenchmark.BASELINE_RAYS_PER_S


@pytest.mark.parametrize("sid", (1, 2, 4, 5, 6, 7, 8, 9))
def test_frame_hash_reproduces_golden_mega2(sid):
    """The tool's u8 frame and hash at tests/test_golden.py's config (the
    CPU build) give GOLDEN's mega2 column; scenes 0 and 3 differ from JAX
    by XLA's FMA contraction (ROADMAP.md queue 3)."""
    w, h = (16, 8) if sid == 9 else (24, 12)
    u8, _ = validate_gpu.mega2_frames(sid, "cpu", w, h, 2, max_bounces=8)
    assert u8.dtype == np.uint8 and u8.shape == (h, w, 3)
    assert validate_gpu.frame_hash(u8) == GOLDEN[sid][1]


def _record(path, hashes, config=validate_gpu.HASH_CONFIG):
    with open(path, "w") as f:
        json.dump({"engines_vs_cpu": {"card_frame_hash_config": config,
                                      "card_frame_hashes": hashes}}, f)
    return str(path)


def test_pin_hashes_new_ok_changed(tmp_path):
    now = {"0": "aa", "1": "bb", "2": "cc"}
    prev = validate_gpu.previous_hashes(_record(tmp_path / "r.json",
                                                {"0": "aa", "1": "b0"}))
    assert prev == {"0": "aa", "1": "b0"}
    ok, tags, note = validate_gpu.pin_hashes(now, prev)
    assert tags == {"0": "ok", "1": "CHANGED", "2": "NEW"}
    assert not ok and note is None
    ok, tags, note = validate_gpu.pin_hashes(now, prev, "a new bounce rule")
    assert ok and note == "a new bounce rule"
    ok, tags, note = validate_gpu.pin_hashes({"0": "aa", "2": "cc"}, prev)
    assert ok and note is None and tags == {"0": "ok", "2": "NEW"}
    # strict: a scene the record lacks fails; a reason does not excuse it
    assert not validate_gpu.pin_hashes({"0": "aa", "2": "cc"}, prev,
                                       strict=True)[0]
    assert not validate_gpu.pin_hashes(now, prev, "why", strict=True)[0]
    assert validate_gpu.pin_hashes({"0": "aa"}, prev, strict=True) == (
        True, {"0": "ok"}, None)
    # another config's hashes, or no record, pin nothing
    assert validate_gpu.previous_hashes(_record(
        tmp_path / "s.json", {"0": "aa"}, "mega2 1x1@1")) == {}
    assert validate_gpu.previous_hashes(str(tmp_path / "none.json")) == {}


def test_cpu_bounds():
    """The tool's copy of the CPU-against-JAX bounds is the tests' own
    (``torch_render_cases``): the same tables, and the same verdict on
    frames at the edges of each limit."""
    assert validate_gpu.MAX_BAD == MAX_BAD
    assert validate_gpu.NOISE_IMAGE == NOISE_IMAGE
    rs = np.random.default_rng(0)
    ref = rs.random((54, 96, 3)).astype(np.float32)
    flip = ref.copy()
    flip[:3, :81] += 0.1           # 243 flipped pixels; scene 0 allows 243
    r = validate_gpu.cpu_bounds(0, flip, ref)
    assert r["ok"] and (r["flipped"], r["allowed"]) == (243, 243)
    flip1 = flip.copy()
    flip1[3, 0] += 0.1             # 244
    far = ref.copy()
    far[:3, :81] += 0.2            # 243, mean 9.4e-3 above 5e-3
    spots = ref.copy()
    spots[:4] += 0.3               # 92.6% close, mean 2.2e-2 above 2e-2
    cases = [(0, ref.copy(), True), (0, flip, True), (0, flip1, False),
             (0, far, False), (1, flip, False), (0, ref + 9e-6, True),
             (3, flip1, True), (3, spots, False), (3, ref + 0.02, False),
             (9, ref + 4.9e-3, True), (9, ref + 0.011, False)]
    for sid, img, want in cases:
        img = img.astype(np.float32)
        assert validate_gpu.cpu_bounds(sid, img, ref)["ok"] == want, sid
        if want:
            check_bounds(sid, img, ref)
        else:
            with pytest.raises(AssertionError):
                check_bounds(sid, img, ref)


def _jax_frame(sid, w, h, spp, seed):
    scene, meta = jcompile(jscenes.build_scene(sid), w, h, dtype=np.float32)
    cfg = JConfig(width=w, height=h, samples_per_pixel=spp, seed=seed,
                  engine="bruteforce")
    return np.asarray(jrender(scene, meta, cfg, gamma=False))


def test_noise_floor_against_jax_bruteforce():
    """Section 1's check on a real pair: the port's CPU mega2 frame
    against JAX's CPU bruteforce frames at seeds 1984 and 31337, scene 0
    at 24x12@4."""
    w, h, spp = 24, 12, 4
    from raytracinginoneweekendincuda_torch.models import scenes

    img = validate_gpu.frame(scenes.build_scene(0), "mega2", spp, 1984,
                             torch.device("cpu"), w, h)
    ref = _jax_frame(0, w, h, spp, 1984)
    ref2 = _jax_frame(0, w, h, spp, 31337)
    st = validate_gpu.reroll_stats(img, ref, ref2)
    assert st["noise_p99"] > 0.1
    assert st["ratio"] < validate_gpu.RATIO_MAX, st


def test_fastgrad_fd_matches_jax_xla_replay():
    """Section 5 at a tiny north-star shape (32x18, 64 pixels, K 6, spp
    2; the plain versions): the directional derivative through K4's plain
    version equals jax.grad through the JAX package's XLA replay on the
    same tape and rays within rel 1e-3, and the FD check holds."""
    case = validate_gpu.fd_case("cpu", width=32, height=18, n_pix=64)
    res = validate_gpu.fd_check(case)
    assert res["ad"] != 0.0 and res["fd"] != 0.0
    assert res["rel"] < validate_gpu.FD_REL_MAX, res

    jscene, jmeta = jcompile(jscenes.book1_final(), 32, 18, dtype=np.float32)
    jscene = jax.tree.map(jnp.asarray, jscene)
    tape = jnp.asarray(case.tape.numpy())
    o, d, tm = (jnp.asarray(x.numpy()) for x in (case.o, case.d, case.tm))
    pc = jnp.asarray(case.pc.numpy().astype(np.uint32))
    wgt = jnp.asarray(case.wgt.numpy())

    def loss(tex):
        sc = jscene._replace(tex_c0=tex)
        return (jreplay.replay(sc, jmeta, tape, o, d, tm, pc, 0,
                               max_bounces=tape.shape[0], t_min=1e-3)
                * wgt).sum()

    g = jax.grad(loss)(jscene.tex_c0)
    ad_jax = float(jnp.sum(g * jnp.asarray(case.v.numpy())))
    assert abs(res["ad"] - ad_jax) <= 1e-3 * abs(ad_jax), (res, ad_jax)


def test_replay_section_plain():
    """validate_replay_gpu's scenes 2 (image) and 8 (box medium) at 16x12,
    K 8, with the plain versions of K3 / K4, under the JAX tool's gates."""
    m = validate_replay_gpu.validate("cpu", scenes=(2, 8), width=16,
                                     height=12)
    assert m["ok"], m
    assert m["scene2_close_lane_fraction"] >= 0.999
    assert m["scene8_medium_albedo_grad_l1"] > 0


def test_replay_scene3_fd64_plain():
    """validate_replay_gpu's scene 3 (Perlin marble) at 16x12, K 8, with
    the plain versions: the close lanes and the gradient meet the JAX
    tool's gates, and K4's directional derivative is within the FD
    bound of the f64 XLA replay's central difference."""
    m = validate_replay_gpu.validate("cpu", scenes=(3,), width=16,
                                     height=12)
    assert m["scene3_lanes_grad_ok"] and m["scene3_fd64_ok"], m
    assert m["scene3_fd64_directional_rel"] < validate_replay_gpu.FD_REL_MAX


def test_run_all_writes_table(tmp_path):
    out = tmp_path / "table.md"
    rows = benchmark.run_all("mega2", 1, str(out), "cpu", width=16,
                             height=8, rows=[(4, 1, 0.27)])
    assert [r[:3] for r in rows] == [(4, "quads", 1)] and rows[0][3] > 0
    text = out.read_text().splitlines()
    assert "| Scene | spp | this port (s) | reference (s) | ratio |" in text
    assert text[-1].startswith("| 4 quads | 1 | ")
    assert "RTX 5070 Ti" in "\n".join(text)


def test_north_star_counts_and_bound_on_cpu():
    rec = bench_northstar.north_star("cpu", spp=4, repeats=1, bound_spp=2,
                                     width=32, height=18)
    assert rec["lane_bounces_counted_at_spp"] == 2
    boxes, spheres = rec["walk_tests_per_lane_bounce"]   # the sphere tree's
    assert 0 < boxes and 1 <= spheres < 484
    assert rec["lane_bounces"] >= 32 * 18 * 4     # a bounce a path at least
    assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes",
                                                       "operations")
    assert rec["bound_share"] == pytest.approx(
        rec["bound_ms"] / (rec["seconds"] * 1e3))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("entry", (
    "run_all", "benchmark --all", "bench_northstar", "validate_gpu",
    "validate_replay_gpu", "make_validation"))
def test_entry_points_raise_without_card(entry, tmp_path):
    _no_card()
    out = str(tmp_path / "out")
    calls = {
        "run_all": lambda: benchmark.run_all(out=out),
        "benchmark --all": lambda: benchmark.main(["--all", "--out", out]),
        "bench_northstar": lambda: bench_northstar.main([]),
        "validate_gpu": lambda: validate_gpu.main(["--json", out]),
        "validate_replay_gpu": lambda: validate_replay_gpu.main(
            ["--json", out]),
        "make_validation": lambda: make_validation.main(["--out", out]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not (tmp_path / "out").exists()
