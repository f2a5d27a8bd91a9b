"""PyTorch port: what the replay kernels' host side computes without a
card -- the fixed-order sum of K4's per lane-bounce slots into d_rep
(ops/replay_cuda.rep_sum) -- the K3 / K4 record of tools/kernel_times,
and the K3 / K4 variants of tools/replay_split."""

import os

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models.scenes import (
    build_scene,
)
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops import replay as rp
from raytracinginoneweekendincuda_torch.ops import replay_cuda as rc
from raytracinginoneweekendincuda_torch.ops.hit import row_sum
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.tools import kernel_times, replay_split
from raytracinginoneweekendincuda_torch.utils import cuda_build
from torch_threads import one_torch_thread  # noqa: F401

def _slots(K, n, np_rows, hot, seed):
    """K4-shaped slots: keys [K, n] (-1 on about a third of them, ``hot``
    of the others on row 3) and rows [K, n, 27], NaN where the key is -1
    (K4 leaves those rows unwritten)."""
    rs = np.random.default_rng(seed)
    keys = rs.integers(0, np_rows, (K, n))
    keys[rs.random((K, n)) < hot] = 3
    keys[rs.random((K, n)) < 0.35] = -1
    rows = rs.standard_normal((K, n, 27)).astype(np.float32)
    rows[keys < 0] = np.nan
    return torch.as_tensor(keys.astype(np.int32)), torch.as_tensor(rows)


@pytest.mark.parametrize("K,n,np_rows,hot", [
    (8, 4096, 512, 0.5), (8, 2000, 37, 0.9), (3, 700, 1, 0.0),
    (16, 1500, 3522, 0.3)])
def test_k4_rep_sum_is_row_sum_and_adds_every_slot(K, n, np_rows, hot):
    """d_rep from K4's slots: bit for bit `hit.row_sum` of the rows with a
    key (the fixed order), within f32 rounding of ``index_add_`` in f64,
    the unwritten rows (NaN here) never read."""
    keys, rows = _slots(K, n, np_rows, hot, seed=K * n)
    got = rc.rep_sum(keys, rows, np_rows)
    assert torch.equal(got, rc.rep_sum_plain(keys, rows, np_rows))
    sel = (keys >= 0).reshape(-1)
    ids = keys.reshape(-1)[sel].long()
    vals = rows.reshape(-1, 27)[sel]
    assert torch.equal(got, row_sum(ids, vals, np_rows))
    want = torch.zeros((np_rows, 27), dtype=torch.float64).index_add_(
        0, ids, vals.double())
    assert torch.isfinite(got).all()
    scale = float(vals.abs().sum()) / max(np_rows, 1) + 1.0
    assert float((got.double() - want).abs().max()) <= 1e-5 * scale


def _emulate_rep_sum_kernel(keys, rows, np_rows):
    """csrc/rep_sum.cu's two kernels in numpy f32, in their order: a block
    of 256 threads a chunk (thread t adds entries t, t + 256, ..., then a
    tree of fixed pairs), then each row's chunk partials in order."""
    order, starts, chunk_first, max_chunks = (
        x.numpy() if torch.is_tensor(x) else x
        for x in rc.rep_sum_chunks(keys, np_rows))
    flat = rows.reshape(-1, 27).numpy()
    n_chunks = int(chunk_first[-1])
    assert n_chunks <= max_chunks
    partial = np.zeros((max_chunks, 27), np.float32)
    seen = []
    for b in range(n_chunks):
        r = int(np.searchsorted(chunk_first, b, side="right")) - 1
        first = int(starts[r]) + (b - int(chunk_first[r])) * rc.REP_CHUNK
        end = min(int(starts[r + 1]), first + rc.REP_CHUNK)
        idx = order[first:end]
        seen.append(idx)
        assert (keys.reshape(-1).numpy()[idx] == r).all()
        red = np.zeros((256, 27), np.float32)
        for t in range(256):
            for e in idx[t::256]:
                red[t] = red[t] + flat[e]
        s = 128
        while s > 0:
            red[:s] = red[:s] + red[s:2 * s]
            s //= 2
        partial[b] = red[0]
    out = np.zeros((np_rows, 27), np.float32)
    for r in range(np_rows):
        for q in range(int(chunk_first[r]), int(chunk_first[r + 1])):
            out[r] = out[r] + partial[q]
    return out, np.sort(np.concatenate(seen)) if seen else np.zeros(0)


@pytest.mark.parametrize("K,n,np_rows,hot", [
    (8, 4096, 512, 0.5), (3, 700, 1, 0.0), (4, 1500, 3522, 0.3)])
def test_k4_rep_sum_kernel_chunks_read_every_slot_once(K, n, np_rows, hot):
    """The host half of the CUDA sum (rep_sum_chunks) and the kernels'
    order, emulated: every slot with a row is read by exactly one chunk of
    its own row, and the sums agree with the plain twin within f32
    reassociation."""
    keys, rows = _slots(K, n, np_rows, hot, seed=K + n)
    got, seen = _emulate_rep_sum_kernel(keys, rows, np_rows)
    assert np.array_equal(seen, np.flatnonzero(keys.reshape(-1).numpy() >= 0))
    want = rc.rep_sum_plain(keys, rows, np_rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_k4_rep_sum_repeats_whatever_the_lane_order():
    """The slots are fixed by (bounce, lane), so a permutation of the lanes
    among the queue's rounds cannot change them; and the sum of one set
    of slots is the same on every call."""
    keys, rows = _slots(8, 3000, 64, 0.6, seed=5)
    first = rc.rep_sum(keys, rows, 64)
    for _ in range(3):
        assert torch.equal(rc.rep_sum(keys.clone(), rows.clone(), 64), first)


def test_kernel_times_replay_record():
    """K3 / K4's keys; the K4 hash covers d_rep, d_rays and d_bg: K4's
    d_rep is summed in an order fixed by the data, so it repeats."""
    rs = np.random.default_rng(3)
    out, d_rep, d_rays, d_bg = (torch.as_tensor(rs.standard_normal(s).astype(
        np.float32)) for s in ((64, 3), (16, 27), (64, 7), (64, 3)))
    rec = kernel_times.replay_record(0.03, out, 0.2, d_rep, d_rays, d_bg)
    assert set(rec) == {"k3_train_shape_ms", "k3_train_shape_sha256",
                        "k4_train_shape_ms", "k4_train_shape_sha256"}
    assert rec["k3_train_shape_sha256"] == kernel_times.digest(out)
    assert rec["k4_train_shape_sha256"] == kernel_times.digest(d_rep, d_rays,
                                                               d_bg)
    moved = kernel_times.replay_record(0.03, out, 0.2, d_rep * 2.0, d_rays,
                                       d_bg)
    assert moved["k4_train_shape_sha256"] != rec["k4_train_shape_sha256"]
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
    assert "atomicAdd(acc" not in src and "atomicAdd(d_rep" not in src
    assert "g.row[0] == 1.2345e30f" in vs["change, no row stores"][0]
    assert "constexpr int kBlock = 448;" in vs["change, 448 threads"][0]


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
