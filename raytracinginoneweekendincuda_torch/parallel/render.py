"""Sharded rendering over a (px, sp) mesh of ranks (``torch.distributed``).

Port of ``raytracinginoneweekendincuda_tpu/parallel/render.py``.  The two
axes of the JAX mesh become two sets of process groups:

* ``px``: pixel parallelism.  Each px shard renders its own pixels; the
  scene is packed in every rank from the same host arrays.
* ``sp``: sample parallelism.  Each sp shard renders its window of the
  samples, ``spp / n_sp`` of them; one all-reduce over sp sums them.

Rank r sits at ``(i, j) = divmod(r, n_sp)``, the layout of JAX's
``devices.reshape(n_px, n_sp)``.  The counter RNG keys on global pixel and
sample ids, so the layout does not show in the image: bit-identical to
`ops/render.render` when the sample axis is not split (the same sums in
the same order), and equal to f32 reassociation otherwise.

The shard bodies are plain functions of the mesh shape and a coordinate
(`shard_sums`), with no collectives, so a test can run every coordinate
of a mesh in one process; `render_sharded` runs this rank's body, then
the sum over sp and the gather over px (`_collect`), and every rank
returns the whole frame, as JAX's ``all_gather`` makes it do.

Engines, as in JAX: ``mega2`` (K1 with its sample window ``samp0``; px
shards take interleaved pixels ``i, i + n_px, ...``, which balance the
work: contiguous windows differed 1.27-2.53x on the TPU), the wavefront
engines (``wavefront``, ``wavefront_pallas``, ``wavefront_bvh``: a
contiguous window each), and the chunked ``bruteforce`` / ``bvh`` (each
chunk of ``per_dev * n_px`` ids split contiguously over px).  ``mega``
raises, as JAX's chunk path does.

Not ported: JAX's ``_put_replicated`` (``make_array_from_callback``)
places host arrays on a global XLA sharding; here each rank packs its own
tables, and nothing is placed across processes.  JAX's ``TILE_RAYS``
span padding is a Mosaic layout; K1 takes any pixel count.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..scene.compiler import SceneArrays, SceneMeta
from ..utils.config import RenderConfig

AXIS_PX = "px"
AXIS_SP = "sp"

CHUNKED = ("bruteforce", "bvh")
WAVEFRONT = ("wavefront", "wavefront_pallas", "wavefront_bvh")


class Mesh:
    """A (px, sp) mesh of the process group's ranks, seen from one rank.

    ``shape`` is ``{px: n_px, sp: n_sp}``, ``coord`` this rank's ``(i, j)
    = divmod(rank, n_sp)``, ``device`` its device.  ``px_group`` (the
    ranks with this rank's j) and ``sp_group`` (the ranks with its i) are
    process groups, or None on a mesh of one rank, where no collective
    runs."""

    def __init__(self, n_px: int, n_sp: int, rank: int, device,
                 px_group=None, sp_group=None):
        self.shape = {AXIS_PX: n_px, AXIS_SP: n_sp}
        self.coord = divmod(rank, n_sp)
        self.device = torch.device(device)
        self.px_group = px_group
        self.sp_group = sp_group

    @property
    def dims(self) -> tuple:
        return self.shape[AXIS_PX], self.shape[AXIS_SP]

    def __repr__(self) -> str:
        return (f"Mesh(px={self.shape[AXIS_PX]}, sp={self.shape[AXIS_SP]}, "
                f"coord={self.coord}, device={self.device})")


def make_mesh(world: int | None = None, sample_shards: int | None = None,
              device="cuda") -> Mesh:
    """The (px, sp) mesh over the process group's ranks on ``device``.

    Without an initialized process group it is the 1x1 mesh (``world``
    must then be None or 1), and no collective is ever called.  With one,
    it spans the world (``world``, if given, must equal its size) and
    creates every px and sp group, on every rank in one order, as
    ``new_group`` requires."""
    if not dist.is_initialized():
        if world not in (None, 1):
            raise ValueError(f"a mesh of {world} ranks needs an initialized "
                             f"process group (parallel/distributed.py)")
        if sample_shards not in (None, 1):
            raise ValueError("a mesh of one rank has one sample shard")
        return Mesh(1, 1, 0, device)
    n = dist.get_world_size()
    if world is not None and world != n:
        raise ValueError(f"world {world} but the process group has {n} "
                         f"ranks")
    if sample_shards is None:      # JAX's default: samples are the cheaper
        sample_shards = 2 if n % 2 == 0 and n > 1 else 1     # axis to split
    if n % sample_shards != 0:
        raise ValueError(f"{n} ranks not divisible by sample_shards="
                         f"{sample_shards}")
    n_sp = sample_shards
    n_px = n // n_sp
    rank = dist.get_rank()
    i, j = divmod(rank, n_sp)
    px_group = sp_group = None
    for jj in range(n_sp):                   # ranks with the same j
        g = dist.new_group([ii * n_sp + jj for ii in range(n_px)])
        if jj == j:
            px_group = g
    for ii in range(n_px):                   # ranks with the same i
        g = dist.new_group([ii * n_sp + jj for jj in range(n_sp)])
        if ii == i:
            sp_group = g
    return Mesh(n_px, n_sp, rank, device, px_group, sp_group)


def _local_spp(cfg: RenderConfig, n_sp: int) -> int:
    spp = cfg.samples_per_pixel
    if spp % n_sp != 0:
        raise ValueError(f"spp={spp} must be divisible by sample shards "
                         f"{n_sp}")
    return spp // n_sp


def _chunking(cfg: RenderConfig, n_px: int) -> tuple:
    """(per_dev, chunk, n_chunks) of the chunked engines: chunks of
    ``per_dev * n_px`` ids, close to ``rays_per_batch`` a shard (JAX
    ``render_sharded``)."""
    npix = cfg.width * cfg.height
    per_dev = min(cfg.rays_per_batch, -(-npix // n_px))
    chunk = per_dev * n_px
    return per_dev, chunk, -(-npix // chunk)


def _t_min(scene: SceneArrays, cfg: RenderConfig) -> float:
    return float(np.asarray(cfg.t_min, np.asarray(scene.sph_rad).dtype))


def _chunk_sums(scene, meta, cfg, shape, coord, device):
    """Chunked engines: shard (i, j)'s slice of each chunk, samples
    ``j * spp_local ..``; radiance sums [n_chunks * per_dev, 3] (ids past
    the frame repeat its last pixel, as JAX clamps them)."""
    from ..ops.hit import scene_tensors
    from ..ops.render import chunk_sums

    n_px, n_sp = shape
    i, j = coord
    spp_local = _local_spp(cfg, n_sp)
    npix = cfg.width * cfg.height
    per_dev, chunk, n_chunks = _chunking(cfg, n_px)
    st = scene_tensors(scene, device)
    bvh = None
    if cfg.engine == "bvh":
        from ..scene.bvh import build_scene_bvh

        bvh = build_scene_bvh(scene)
    parts = []
    for c in range(n_chunks):
        ids = torch.arange(c * chunk + i * per_dev,
                           c * chunk + (i + 1) * per_dev, device=device)
        parts.append(chunk_sums(
            st, meta, torch.clamp_max(ids, npix - 1),
            range(j * spp_local, (j + 1) * spp_local), width=cfg.width,
            height=cfg.height, seed=cfg.seed, max_bounces=cfg.max_bounces,
            t_min=_t_min(scene, cfg), differentiable=cfg.differentiable,
            engine=cfg.engine, bvh=bvh))
    return torch.cat(parts)


def _wavefront_sums(scene, meta, cfg, shape, coord, device):
    """Wavefront engines: shard (i, j)'s contiguous window of
    ``ceil(npix / n_px)`` pixels from ``i * npix_local``, samples ``j *
    spp_local ..`` (JAX ``_sharded_wavefront``); sums [npix_local, 3]."""
    from ..ops.wavefront import render_wavefront_frame, wavefront_hit_fn

    n_px, n_sp = shape
    i, j = coord
    spp_local = _local_spp(cfg, n_sp)
    npix_local = -(-cfg.width * cfg.height // n_px)
    st, hit_fn = wavefront_hit_fn(scene, meta, cfg.engine, device)
    return render_wavefront_frame(
        st, meta, hit_fn, width=cfg.width, height=cfg.height, spp=spp_local,
        seed=cfg.seed, max_bounces=cfg.max_bounces, t_min=_t_min(scene, cfg),
        pool=cfg.rays_per_batch, npix_local=npix_local,
        pix_base=i * npix_local, samp_base=j * spp_local)


def mega2_shard_pixels(npix: int, n_px: int, i: int, device) -> torch.Tensor:
    """Px shard i's interleaved pixel ids ``i, i + n_px, ...`` [span] int32,
    ``span = ceil(npix / n_px)``; ids at or past ``npix`` are -1 (K1 and
    the plain version give zeros there)."""
    span = -(-npix // n_px)
    ids = i + n_px * torch.arange(span, dtype=torch.int64, device=device)
    return torch.where(ids < npix, ids, -1).to(torch.int32)


def _mega2_sums(scene, meta, cfg, shape, coord, device):
    """mega2: K1 over px shard i's interleaved pixels, its sample window
    ``samp0 = j * spp_local`` (JAX ``_sharded_mega2``); sums [span, 3]."""
    from ..ops.mega2 import frame_params, pack_mega2_tables, render_radiance

    n_px, n_sp = shape
    i, j = coord
    spp_local = _local_spp(cfg, n_sp)
    tab = pack_mega2_tables(scene, meta, device)
    fp = frame_params(scene, cfg.with_(samples_per_pixel=spp_local),
                      samp0=j * spp_local)
    pix = mega2_shard_pixels(cfg.width * cfg.height, n_px, i, device)
    return render_radiance(tab, pix, fp)


def _check_engine(cfg: RenderConfig) -> None:
    if cfg.engine not in ("mega2", *WAVEFRONT, *CHUNKED):
        raise ValueError(f"no sharded render for engine {cfg.engine!r} "
                         f"(the JAX package's chunk path refuses it too); "
                         f"use mega2, a wavefront engine, bruteforce or "
                         f"bvh")


def shard_sums(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
               shape: tuple, coord: tuple, *, device):
    """Radiance sums of shard ``coord = (i, j)`` of a mesh ``shape = (n_px,
    n_sp)``: its pixels (the engine's slots) over its sample window,
    [n_slots, 3] in the scene's dtype, no collective.  Summed over j and
    stacked over i, they give `frame_sums`."""
    _check_engine(cfg)
    device = torch.device(device)
    _local_spp(cfg, shape[1])
    if cfg.engine == "mega2":
        return _mega2_sums(scene, meta, cfg, shape, coord, device)
    if cfg.engine in WAVEFRONT:
        return _wavefront_sums(scene, meta, cfg, shape, coord, device)
    return _chunk_sums(scene, meta, cfg, shape, coord, device)


def frame_sums(cfg: RenderConfig, shape: tuple,
               stacked: torch.Tensor) -> torch.Tensor:
    """The frame's radiance sums [npix, 3] in pixel order (id j*W + i, j
    from the bottom row) from the px shards' sums ``stacked`` [n_px,
    n_slots, 3], each already summed over sp."""
    n_px = shape[0]
    npix = cfg.width * cfg.height
    if cfg.engine == "mega2":         # stacked[i, k] holds pixel i + n_px*k
        fb = stacked.transpose(0, 1).reshape(-1, 3)
    elif cfg.engine in WAVEFRONT:     # contiguous windows
        fb = stacked.reshape(-1, 3)
    else:                             # [n_px, n_chunks, per_dev] by chunk
        per_dev = _chunking(cfg, n_px)[0]
        fb = stacked.reshape(n_px, -1, per_dev, 3).transpose(0, 1) \
            .reshape(-1, 3)
    return fb[:npix]


def finish_frame(fb: torch.Tensor, cfg: RenderConfig, gamma: bool = True,
                 out_u8: bool = False) -> np.ndarray:
    """The frame's sums [npix, 3] -> numpy [H, W, 3], top row first, with
    the epilogue `ops/render.render` gives the engine: ``render_chunk``'s
    average and gamma (then u8 in f64 numpy) for the chunked engines,
    ``finalize`` for the others."""
    from ..ops.render import average_chunk, finalize

    H, W = cfg.height, cfg.width
    if cfg.engine in CHUNKED:
        col = average_chunk(fb, cfg.samples_per_pixel, gamma)
        img = col.cpu().numpy().astype(np.float64).reshape(H, W, 3)
        if out_u8:
            img = (256.0 * np.clip(img, 0.0, 0.999)).astype(np.uint8)
        return img[::-1]
    img = finalize(fb, cfg.samples_per_pixel, gamma, out_u8)
    return img.cpu().numpy().reshape(H, W, 3)[::-1]


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (None: the whole world), in place.
    Both backends take the tensor where it lies: NCCL on its card, gloo
    on the CPU or on a card (gloo copies through the host itself; on an
    H100 it took CUDA tensors for ``all_reduce`` and ``all_gather``,
    ``chip_smoke.py`` phase 17)."""
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def _collect(mesh: Mesh, part: torch.Tensor) -> torch.Tensor:
    """This rank's sums [n_slots, 3] -> every px shard's sums [n_px,
    n_slots, 3], summed over sp: ``all_reduce`` over the sp group, then
    ``all_gather`` over the px group.  On a 1x1 mesh no collective runs."""
    n_px, n_sp = mesh.dims
    if n_sp > 1:
        part = all_reduce(part, mesh.sp_group)
    if n_px == 1:
        return part[None]
    part = part.contiguous()
    out = [torch.empty_like(part) for _ in range(n_px)]
    dist.all_gather(out, part, group=mesh.px_group)
    return torch.stack(out)


def render_sharded(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                   mesh: Mesh | None = None, *, device, gamma: bool = True,
                   out_u8: bool = False) -> np.ndarray:
    """Render a full frame on the mesh -> numpy [H, W, 3], top row first,
    on every rank (float; uint8 when ``out_u8``, as `ops/render.render`).
    ``mesh`` defaults to `make_mesh` over the process group (the 1x1 mesh
    without one).  Raises ``ValueError`` for engine ``mega`` and for an
    spp that the sample shards do not divide."""
    from ..ops.render import resolve_device

    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(device=device)
    _check_engine(cfg)
    _local_spp(cfg, mesh.dims[1])
    part = shard_sums(scene, meta, cfg, mesh.dims, mesh.coord, device=device)
    fb = frame_sums(cfg, mesh.dims, _collect(mesh, part))
    return finish_frame(fb, cfg, gamma, out_u8)


def shard_work_stats(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                     mesh: Mesh | None = None, *, device) -> np.ndarray:
    """Path segments of each px shard of the mega2 sharded render, [n_px]
    int64: the bounces every (pixel, sample) path of the shard's pixels
    runs, counted from K2's tapes of those lanes at the frame's depth
    (`tools/lane_share.path_bounces`, as ``chip_smoke.py`` counts K1's
    lane-bounces), all samples of every sp shard.  The load-balance
    measure behind interleaved pixels.  Computed on this rank for every
    px shard, no collective.  JAX's second output, the lane-slots of the
    TPU's tile passes, measures that pass schedule, which the port does
    not have (K1 refills lanes from a queue; ``ROADMAP.md`` item 9)."""
    from ..ops.mega2 import (
        frame_params, pack_mega2_tables, tape_lanes, trace_tapes,
    )
    from ..ops.render import resolve_device
    from ..tools.lane_share import path_bounces

    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(device=device)
    n_px = mesh.dims[0]
    tab = pack_mega2_tables(scene, meta, device)
    fp = frame_params(scene, cfg)
    npix = cfg.width * cfg.height
    segs = np.zeros(n_px, np.int64)
    for i in range(n_px):
        pix = mega2_shard_pixels(npix, n_px, i, device)
        pix = pix[pix >= 0]
        lane_pix, lane_samp = tape_lanes(pix, cfg.samples_per_pixel)
        tape = trace_tapes(tab, lane_pix, lane_samp, fp)
        segs[i] = int(path_bounces(tape, tab.attr, tab.np_rows).sum())
    return segs
