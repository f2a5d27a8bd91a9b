"""PyTorch port: what the replay kernels' host side decides without a
card -- K4's choice of where it sums d_rep (ops/replay_cuda.py) on the
port's own tables -- the K3 / K4 record of tools/kernel_times, and the K3
/ K4 variants of tools/replay_split."""

import os

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models.scenes import (
    build_scene, sphere_field,
)
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops import replay as rp
from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.tools import kernel_times, replay_split
from raytracinginoneweekendincuda_torch.utils import cuda_build
from torch_threads import one_torch_thread  # noqa: F401

H100_OPTIN = 232_448      # an H100's opt-in shared memory a block, bytes


def _table_rows(desc) -> int:
    scene, meta = compile_scene(desc, 16, 8, dtype=np.float32)
    tab = mega2.pack_mega2_tables(scene, meta, "cpu")
    return rp.replay_table(
        scene, meta, tab,
        kernel_space=mega2.mega2_kernel_id_space(tab, meta)).NP


@pytest.mark.parametrize("world,rows,shared", [
    ("scene 0", 512, True), ("scene 9", 3522, False),
    ("sphere_field(3200)", 3264, False)])
def test_k4_sums_d_rep_in_shared_memory_where_it_fits(world, rows, shared):
    """At the train step's K 8: scene 0's 512 rows (55 KB of d_rep beside
    36 KB of states) in shared memory, scene 9's and the large world's
    (above the opt-in) in global memory."""
    desc = (sphere_field(3200) if world.startswith("sphere_field")
            else build_scene(int(world.split()[1])))
    np_rows = _table_rows(desc)
    assert np_rows == rows
    assert rc.bwd_rep_in_shared(np_rows, 8, H100_OPTIN) is shared


def test_k4_shared_rule_counts_states_and_rows():
    """The rule is the block's states (K x 9 words a thread) plus d_rep
    (27 words a row) against the opt-in, to the byte."""
    K, threads = 8, rc.BWD_BLOCK
    states = 4 * rc.STATE_WORDS * K * threads
    for rows in (1, 512, 1000):
        need = states + 4 * 27 * rows
        assert rc.bwd_rep_in_shared(rows, K, need)
        assert not rc.bwd_rep_in_shared(rows, K, need - 1)
    assert rc.bwd_rep_in_shared(512, 8, 92_160, threads=128)
    assert not rc.bwd_rep_in_shared(512, 8, 92_160, threads=160)


def test_kernel_times_replay_record():
    """K3 / K4's keys; the K4 hash covers d_rays and d_bg but not d_rep,
    whose atomic sum varies from run to run (its norm is kept)."""
    rs = np.random.default_rng(3)
    out, d_rep, d_rays, d_bg = (torch.as_tensor(rs.standard_normal(s).astype(
        np.float32)) for s in ((64, 3), (16, 27), (64, 7), (64, 3)))
    rec = kernel_times.replay_record(0.03, out, 0.2, d_rep, d_rays, d_bg)
    assert set(rec) == {"k3_train_shape_ms", "k3_train_shape_sha256",
                        "k4_train_shape_ms", "k4_train_shape_sha256",
                        "k4_train_shape_d_rep_norm"}
    assert rec["k3_train_shape_sha256"] == kernel_times.digest(out)
    assert rec["k4_train_shape_sha256"] == kernel_times.digest(d_rays, d_bg)
    assert rec["k4_train_shape_d_rep_norm"] == pytest.approx(
        float(np.linalg.norm(d_rep.double().numpy())), rel=1e-12)
    moved = kernel_times.replay_record(0.03, out, 0.2, d_rep * 2.0, d_rays,
                                       d_bg)
    assert moved["k4_train_shape_sha256"] == rec["k4_train_shape_sha256"]
    d_bg[5, 1] += 1.0
    moved = kernel_times.replay_record(0.03, out, 0.2, d_rep, d_rays, d_bg)
    assert moved["k4_train_shape_sha256"] != rec["k4_train_shape_sha256"]


def test_kernel_times_replay_inputs_on_cpu():
    """The replay inputs kernel_times and chip_smoke time K3 / K4 on: one
    row a lane, g from seed 1984 in [0.5, 1.5), and the plain replay runs
    on them."""
    scene, meta = compile_scene(build_scene(4), 8, 4, dtype=np.float32)
    _, _, _, cfg = kernel_times.train_start((4, 8, 4, 1, 3))
    tab = mega2.pack_mega2_tables(scene, meta, "cpu")
    fp = mega2.frame_params(scene, cfg)
    pix = torch.arange(32, dtype=torch.int32)
    tape = mega2.trace_tapes_plain(tab, pix, torch.zeros_like(pix), fp)
    tt, rays, tape, pc, bg, g = kernel_times.replay_inputs(
        scene, meta, tab, fp, pix, 0, tape, torch.device("cpu"))
    assert rays.shape == (32, 7) and g.shape == (32, 3)
    assert float(g.min()) >= 0.5 and float(g.max()) < 1.5
    again = kernel_times.replay_inputs(scene, meta, tab, fp, pix, 0, tape,
                                       torch.device("cpu"))
    assert torch.equal(again[5], g) and torch.equal(again[1], rays)
    out = rp.replay_plain(tt, rays, tape, pc, 0, bg, t_min=fp.t_min)
    assert out.shape == (32, 3) and torch.isfinite(out).all()


def test_k4_split_variants_apply_to_the_kernel_source():
    """tools/replay_split makes its variants of K4 by text replacement: each
    must find its text in csrc/replay_bwd.cu, and each changes the source
    but the two that only build or launch it otherwise."""
    with open(os.path.join(cuda_build.CSRC_DIR, "replay_bwd.cu")) as f:
        src = f.read()
    vs = replay_split.k4_change_variants(src)
    same = {n for n, (v, _, _) in vs.items() if v == src}
    assert same == {"change", "change, texture columns by index"}
    assert vs["change, texture columns by index"][1] == "parent"
    assert "atomicAdd(acc" not in vs["change, no d_rep atomics"][0]


def test_k3_split_variants_apply_to_the_kernel_source():
    """tools/replay_split makes its variants of K3 by text replacement:
    each must find its text in csrc/replay_fwd.cu and change the source,
    and each keeps the launch's entry point."""
    with open(os.path.join(cuda_build.CSRC_DIR, "replay_fwd.cu")) as f:
        src = f.read()
    vs = replay_split.k3_change_variants(src)
    assert {n for n, (v, _, _) in vs.items() if v == src} == {"change"}
    assert all(h == "change" and sig == "change"
               for _, h, sig in vs.values())
    for v, _, _ in vs.values():
        assert 'extern "C" int replay_fwd_launch(' in v
    assert "drained" in src
    assert "if (!drained)" not in \
        vs["change, queue asked after it is empty"][0]
    assert "atomicAdd(queue, 32u)" in vs["change, warp rounds of 32"][0]
    assert "__all_sync" in vs["change, refill rounds of 32"][0]
    for blk in (128, 256):
        assert f"constexpr int kBlock = {blk};" in \
            vs[f"change, {blk} threads"][0]
    assert "__launch_bounds__(kBlock, 3)" in vs["change, 3 blocks a SM"][0]
    assert "bounce_fwd(ps, tape" in vs["change, rows in shared memory"][0]
    assert "wray + 7 * (lane - base)" in \
        vs["change, rays through shared memory"][0]
    assert replay_split.k3_parent_variants("x") == {
        "parent": ("x", "parent", "parent")}
