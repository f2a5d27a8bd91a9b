"""PyTorch port: the winner-tape trace (K2's plain version,
``ops/mega2.trace_tapes_plain`` behind ``mega2_tapes``) against the JAX
package's ``mega2_tapes`` (Pallas interpret mode) at 12x8, spp 2, K 6."""

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes as tscenes
from raytracinginoneweekendincuda_torch.ops import mega2 as tmega2
from raytracinginoneweekendincuda_torch.scene.compiler import (
    compile_scene as tcompile,
)
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops import mega2 as jmega2
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from torch_threads import one_torch_thread  # noqa: F401

W, H, SPP, K = 12, 8, 2, 6
KW = dict(width=W, height=H, max_bounces=K, t_min=1e-3, seed=1984)


def _scenes(sid):
    js, jm = jcompile(jscenes.build_scene(sid), W, H, dtype=np.float32)
    ts, tm = tcompile(tscenes.build_scene(sid), W, H, dtype=np.float32)
    return js, jm, ts, tm


def _jax_tapes(js, jm, pix, id_space="global"):
    return np.asarray(jmega2.mega2_tapes(js, jm, pix, SPP, id_space=id_space,
                                         **KW))


def _port_tapes(ts, tm, pix, id_space="global"):
    return tmega2.mega2_tapes(ts, tm, pix, SPP, id_space=id_space,
                              device="cpu", **KW).numpy()


@pytest.mark.parametrize("sid", [1, 4, 6, 8, 0])
def test_tapes_match_jax(sid):
    """Bit-equal tapes on scenes 1, 4, 6 and 8 (8: medium winners as
    S+Q+m); on scene 0 at least 97% of lanes equal (f32 near-tangency
    ties flip a winner and cascade down the lane, tests/test_replay.py)."""
    js, jm, ts, tm = _scenes(sid)
    pix = np.arange(W * H, dtype=np.int32)
    want = _jax_tapes(js, jm, pix)
    got = _port_tapes(ts, tm, pix)
    assert got.shape == want.shape == (SPP, K, W * H)
    if sid == 0:
        same = (got == want).all(axis=1)
        assert same.mean() >= 0.97, same.mean()
    else:
        np.testing.assert_array_equal(got, want)
    if sid == 8:
        S, Q = ts.sph_c0.shape[0], ts.quad_q.shape[0]
        assert (got >= S + Q).any(), "no medium winner on scene 8"


def test_scattered_ids_gather_the_contiguous_tapes():
    """Scattered pixel ids give the contiguous run's tapes, gathered."""
    _, _, ts, tm = _scenes(4)
    full = _port_tapes(ts, tm, np.arange(W * H, dtype=np.int32))
    rs = np.random.default_rng(5)
    pix = rs.permutation(W * H)[:40].astype(np.int32)
    np.testing.assert_array_equal(_port_tapes(ts, tm, pix), full[:, :, pix])


@pytest.mark.parametrize("sid", [4, 8])
def test_kernel_space_maps_to_global(sid):
    """The kernel-space tape, mapped through `mega2_kernel_id_space`,
    equals the global tape."""
    _, _, ts, tm = _scenes(sid)
    pix = np.arange(W * H, dtype=np.int32)
    glob = _port_tapes(ts, tm, pix)
    kern = torch.from_numpy(_port_tapes(ts, tm, pix, id_space="kernel"))
    tab = tmega2.pack_mega2_tables(ts, tm, "cpu")
    remap, s_pad = tmega2.mega2_kernel_id_space(tab, tm)
    assert s_pad == tab.s_pad and remap.shape[0] == tab.np_rows + tm.n_media
    mapped = torch.where(kern >= 0, remap[kern.clamp_min(0).long()], -1)
    np.testing.assert_array_equal(mapped.numpy(), glob)
