"""PyTorch port: the lane-share helper (tools/lane_share.py) on hand-made
winner tapes, and the large world of the card's K1 tests."""

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models.scenes import sphere_field
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.tools.lane_share import (
    lane_shares, path_bounces, trace_shares,
)
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401

# rows 0, 1 and 3 are surfaces, row 2 a light; np_rows 4, so 4 is medium 0
ATTR = torch.zeros((4, 40))
ATTR[2, 10] = 3.0
# winner tapes [K 4, lanes] and the bounces each path ran
PATHS = {
    "hit, hit, miss": ([0, 1, -1, -1], 3),
    "light first": ([2, -1, -1, -1], 1),
    "miss first": ([-1, -1, -1, -1], 1),
    "to the cap": ([0, 1, 0, 1], 4),
    "medium, hit, miss": ([4, 0, -1, -1], 3),
    "hit, light": ([0, 2, -1, -1], 2),
}


def test_path_bounces_on_hand_made_tape():
    tape = torch.tensor([t for t, _ in PATHS.values()],
                        dtype=torch.int32).T.contiguous()
    got = path_bounces(tape, ATTR, 4)
    assert got.tolist() == [n for _, n in PATHS.values()]


@pytest.mark.parametrize("counts,warp,want", [
    # two samples of four pixels, warps of two: nested runs each sample's
    # longest path (3, 4 | 3, 3), flat each warp's longest pixel (4 | 7)
    ([[3, 1, 4, 2], [1, 3, 3, 1]], 2,
     {"mean_path": 18 / 8, "nested": 18 / 26, "flat": 18 / 22}),
    # a partial last warp idles its missing lane
    ([[3, 1, 4]], 2, {"mean_path": 8 / 3, "nested": 8 / 14,
                      "flat": 8 / 14}),
    # paths of one length waste nothing
    ([[2] * 64, [2] * 64], 32, {"mean_path": 2.0, "nested": 1.0,
                                "flat": 1.0}),
], ids=["two warps", "partial warp", "uniform"])
def test_lane_shares(counts, warp, want):
    got = lane_shares(torch.tensor(counts), warp)
    assert got == pytest.approx(want, rel=1e-12)


def test_trace_shares_at_the_train_steps_shape():
    """K2's tape at the training step's shape (640x360, spp 8, K 8;
    1.84 M sample-major lanes) made from seeded path lengths (numpy seed
    7): trace_shares reads lane ``s*P + p`` as pixel p's sample s, so its
    ``nested`` share is the useful share of a thread a lane whose warp
    holds 32 adjacent pixels of one sample and runs its longest path."""
    W, H, spp, K = 640, 360, 8, 8
    P = W * H
    counts = np.random.default_rng(7).integers(1, K + 1, (spp, P))
    # a path of c < K bounces: c - 1 hits on surface row 0, then a miss;
    # of K bounces: K hits
    b = np.arange(K)[:, None]
    lanes = counts.reshape(-1)[None]
    tape = np.where((b < lanes - 1) | (lanes == K), 0, -1).astype(np.int32)
    got = trace_shares(torch.from_numpy(tape), torch.zeros((1, 40)), 1, spp)
    warps = counts.reshape(spp, P // 32, 32)
    assert got["mean_path"] == pytest.approx(counts.mean(), rel=1e-12)
    assert got["nested"] == pytest.approx(
        counts.sum() / (32 * warps.max(-1).sum()), rel=1e-12)
    assert got["flat"] == pytest.approx(
        counts.sum() / (32 * warps.sum(0).max(-1).sum()), rel=1e-12)


def test_sphere_field_is_seeded_and_renders():
    """The large world the card's K1 tests use: one seed gives one world,
    all 10,001 spheres pack as active rows, and the plain render of a few
    pixels is finite and not black."""
    tabs = []
    for seed in (1984, 1984, 7):
        scene, meta = compile_scene(sphere_field(seed=seed), 4, 2,
                                    dtype=np.float32)
        tabs.append(mega2.pack_mega2_tables(scene, meta, "cpu"))
    assert int((tabs[0].sph[:, 9] > 0.5).sum()) == 10_001
    assert torch.equal(tabs[0].sph, tabs[1].sph)
    assert not torch.equal(tabs[0].sph, tabs[2].sph)
    cfg = RenderConfig(width=4, height=2, samples_per_pixel=1,
                       max_bounces=4)
    out = mega2.render_radiance_plain(
        tabs[0], torch.arange(8, dtype=torch.int32),
        mega2.frame_params(scene, cfg))
    assert out.shape == (8, 3)
    assert torch.isfinite(out).all() and out.sum() > 0
