"""The replay's kernels on the card: K3 (forward) and K4 (backward).

Counterpart of ``raytracinginoneweekendincuda_tpu/ops/pallas_replay.py``.
K3 (``csrc/replay_fwd.cu``) replaces ``_fwd_kernel_factory`` and K4
(``csrc/replay_bwd.cu``, with its fixed-order sum ``csrc/rep_sum.cu``)
replaces ``_bwd_kernel_factory``; K3 and K4 share the bounce of
``csrc/replay_bounce.cuh``.  `ReplayFunction` is the pair as one
``torch.autograd.Function`` (the TPU's ``jax.custom_vjp``): its forward
launches K3, its backward launches K4 and returns the cotangents of the
table, the rays and the background.

`replay` dispatches the way ``mega2.render_radiance`` does: CPU tensors go
to the plain version (``ops/replay.replay_plain``, differentiated by
autograd), CUDA tensors to the kernels, anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from .hit import row_sum
from .replay import REP_COLS, ReplayTables, replay_plain


class _Params(ctypes.Structure):
    """Mirror of ``replay::Params`` in ``csrc/replay_bounce.cuh``."""
    _fields_ = [
        ("rep", ctypes.c_void_p), ("med", ctypes.c_void_p),
        ("perm", ctypes.c_void_p), ("vec", ctypes.c_void_p),
        ("texels", ctypes.c_void_p), ("img_dims", ctypes.c_void_p),
        ("bg", ctypes.c_void_p), ("t_min", ctypes.c_float),
        ("np_rows", ctypes.c_int), ("S", ctypes.c_int),
        ("med_base", ctypes.c_int), ("n_media", ctypes.c_int),
        ("n_noise", ctypes.c_int), ("n_images", ctypes.c_int),
        ("tex_cols", ctypes.c_int), ("has_checker", ctypes.c_int),
        ("has_noise", ctypes.c_int), ("has_image", ctypes.c_int),
        ("K", ctypes.c_int), ("n", ctypes.c_int), ("samp", ctypes.c_uint32),
    ]


def _load(name: str, entry: str, argtypes: list):
    from ..utils.cuda_build import load_library

    lib, record = load_library(name)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.replay_params_size.argtypes = []
    lib.replay_params_size.restype = ctypes.c_int
    if lib.replay_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("replay::Params and its ctypes mirror differ")
    return lib, record


_P = ctypes.c_void_p


def load_fwd_kernel():
    """Build (at first use) and load K3; returns (CDLL, build record)."""
    return _load("replay_fwd", "replay_fwd_launch",
                 [ctypes.POINTER(_Params), _P, _P, _P, _P, _P,
                  ctypes.POINTER(ctypes.c_int), _P])


def load_bwd_kernel():
    """Build (at first use) and load K4; returns (CDLL, build record)."""
    lib, record = _load("replay_bwd", "replay_bwd_launch",
                        [ctypes.POINTER(_Params), _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, ctypes.POINTER(ctypes.c_int), _P])
    lib.replay_bwd_kmax.argtypes = []
    lib.replay_bwd_kmax.restype = ctypes.c_int
    return lib, record


# sorted entries a chunk of the fixed-order sum (``kChunk`` in
# csrc/rep_sum.cu; the loader checks the two agree)
REP_CHUNK = 2048


def load_rep_sum_kernel():
    """Build (at first use) and load K4's fixed-order sum; returns (CDLL,
    build record)."""
    from ..utils.cuda_build import load_library

    lib, record = load_library("rep_sum")
    lib.rep_sum_launch.argtypes = [_P, _P, _P, _P, ctypes.c_int,
                                   ctypes.c_int, _P, _P, _P]
    lib.rep_sum_launch.restype = ctypes.c_int
    lib.rep_sum_chunk.argtypes = []
    lib.rep_sum_chunk.restype = ctypes.c_int
    if lib.rep_sum_chunk() != REP_CHUNK:
        raise RuntimeError("rep_sum.cu's chunk and REP_CHUNK differ")
    return lib, record


def rep_sum_plain(keys: torch.Tensor, rows: torch.Tensor,
                  np_rows: int) -> torch.Tensor:
    """d_rep [np_rows, 27] from K4's per lane-bounce slots: ``keys`` [K, N]
    int32, the winner row of each slot (-1: none), and ``rows`` [K, N,
    27], its row cotangent (read only where the key is >= 0).  Each row
    sums its slots in an order fixed by the keys alone (`hit.row_sum`: a
    stable sort, chunk sums), so the result repeats bit for bit; the
    slots without a row go to an extra bucket that is dropped.  The plain
    version of `rep_sum_cuda`."""
    ids = torch.where(keys >= 0, keys, np_rows).reshape(-1).long()
    return row_sum(ids, rows.reshape(-1, REP_COLS), np_rows + 1)[:np_rows]


def rep_sum_chunks(keys: torch.Tensor, np_rows: int):
    """The host half of `rep_sum_cuda`: (order [S] int64, the stable sort
    of the keys (-1 after every row); starts [np_rows + 1] int32, row r's
    sorted positions starts[r] .. starts[r + 1] - 1; chunk_first
    [np_rows + 1] int32, the chunks of `REP_CHUNK` sorted entries before
    row r; max_chunks, a bound of the chunks fixed by the shapes)."""
    dev = keys.device
    k = torch.where(keys >= 0, keys, np_rows).reshape(-1).to(torch.int32)
    seg, order = torch.sort(k, stable=True)
    starts = torch.searchsorted(
        seg, torch.arange(np_rows + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    nch = (starts[1:] - starts[:-1] + (REP_CHUNK - 1)) // REP_CHUNK
    chunk_first = torch.zeros(np_rows + 1, dtype=torch.int32, device=dev)
    chunk_first[1:] = torch.cumsum(nch, 0, dtype=torch.int32)
    return order, starts, chunk_first, -(-k.numel() // REP_CHUNK) + np_rows


def rep_sum_cuda(keys: torch.Tensor, rows: torch.Tensor,
                 np_rows: int) -> torch.Tensor:
    """`rep_sum_plain`'s d_rep on the card (csrc/rep_sum.cu): the keys'
    stable sort and chunk bounds (`rep_sum_chunks`), then a block a chunk
    of 2048 sorted entries and a thread a (row, column) over its chunks,
    every sum in an order fixed by the keys.  Launches on the current
    stream, no synchronisation."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"rep_sum_cuda needs CUDA tensors, got {dev}")
    if keys.dtype != torch.int32 or rows.dtype != torch.float32 \
            or rows.shape != (*keys.shape, REP_COLS) or rows.device != dev:
        raise ValueError("keys must be int32 [K, N] and rows f32 "
                         "[K, N, 27] on one device")
    rows = rows.contiguous()
    lib, _ = load_rep_sum_kernel()
    order, starts, chunk_first, max_chunks = rep_sum_chunks(keys, np_rows)
    partial = torch.empty((max_chunks, REP_COLS), dtype=torch.float32,
                          device=dev)
    d_rep = torch.empty((np_rows, REP_COLS), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rep_sum_launch(rows.data_ptr(), order.data_ptr(),
                                 starts.data_ptr(), chunk_first.data_ptr(),
                                 np_rows, max_chunks, partial.data_ptr(),
                                 d_rep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rep_sum kernel launch failed: CUDA error {err}")
    rep_sum_cuda.launches += 1
    return d_rep


rep_sum_cuda.launches = 0


def rep_sum(keys: torch.Tensor, rows: torch.Tensor,
            np_rows: int) -> torch.Tensor:
    """K4's d_rep from its slots: the plain version for CPU tensors, the
    kernel for CUDA tensors.  No fallback between them."""
    if keys.device.type == "cpu":
        return rep_sum_plain(keys, rows, np_rows)
    if keys.device.type == "cuda":
        return rep_sum_cuda(keys, rows, np_rows)
    raise ValueError(f"no rep_sum for device {keys.device}")


def _params(tt: ReplayTables, rep, bg, n: int, K: int, sample: int,
            t_min: float) -> _Params:
    return _Params(
        rep=rep.data_ptr(), med=tt.med.data_ptr(), perm=tt.perm.data_ptr(),
        vec=tt.vec.data_ptr(), texels=tt.texels.data_ptr(),
        img_dims=tt.img_dims.data_ptr(), bg=bg.data_ptr(), t_min=t_min,
        np_rows=tt.NP, S=tt.S, med_base=tt.med_base, n_media=tt.n_media,
        n_noise=tt.n_noise, n_images=tt.n_images,
        tex_cols=tt.texels.shape[1], has_checker=int(tt.has_checker),
        has_noise=int(tt.has_noise), has_image=int(tt.has_image), K=K, n=n,
        samp=int(sample) & 0xFFFFFFFF)


def _check(tt: ReplayTables, rep, rays, tape, pix_ctr, bg):
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"the replay kernels need CUDA tensors, got {dev}")
    n = rays.shape[0]
    if rays.dtype != torch.float32 or rays.shape != (n, 7):
        raise ValueError("rays must be f32 [N, 7]")
    if tape.dtype != torch.int32 or tape.dim() != 2 or tape.shape[1] != n:
        raise ValueError("tape must be int32 [K, N]")
    if pix_ctr.dtype != torch.int32 or pix_ctr.shape != (n,):
        raise ValueError("pix_ctr must be int32 [N]")
    if rep.dtype != torch.float32 or rep.shape != (tt.NP, REP_COLS):
        raise ValueError(f"rep must be f32 [NP, {REP_COLS}]")
    if bg.dtype != torch.float32 or bg.shape != (3,):
        raise ValueError("bg must be f32 [3]")
    for name, t in (("rep", rep), ("tape", tape), ("pix_ctr", pix_ctr),
                    ("bg", bg), ("med", tt.med), ("perm", tt.perm),
                    ("vec", tt.vec), ("texels", tt.texels),
                    ("img_dims", tt.img_dims)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")


def replay_fwd_cuda(tt: ReplayTables, rep, rays, tape, pix_ctr, sample: int,
                    bg, *, t_min: float) -> torch.Tensor:
    """K3: radiance [N, 3] of the replay (no autograd; see `replay`).
    Launches on the current stream, no synchronisation.
    ``replay_fwd_cuda.shape`` holds the last launch's (blocks, threads a
    block, shared bytes)."""
    rep, rays, tape, pix_ctr, bg = (x.contiguous() for x in
                                    (rep, rays, tape, pix_ctr, bg))
    _check(tt, rep, rays, tape, pix_ctr, bg)
    n, K = rays.shape[0], tape.shape[0]
    lib, _ = load_fwd_kernel()
    dev = rays.device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    prm = _params(tt, rep, bg, n, K, sample, t_min)
    shape = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.replay_fwd_launch(ctypes.byref(prm), rays.data_ptr(),
                                    tape.data_ptr(), pix_ctr.data_ptr(),
                                    out.data_ptr(), queue.data_ptr(), shape,
                                    stream)
    if err != 0:
        raise RuntimeError(f"replay forward kernel launch failed: CUDA error "
                           f"{err}")
    replay_fwd_cuda.launches += 1
    replay_fwd_cuda.shape = tuple(shape)
    return out


replay_fwd_cuda.launches = 0
replay_fwd_cuda.shape = None


def replay_bwd_slots_cuda(tt: ReplayTables, rep, rays, tape, pix_ctr,
                          sample: int, bg, g, *, t_min: float):
    """K4's launch: (keys [K, N] int32, rows [K, N, 27], d_rays [N, 7],
    d_bg [N, 3]) for the radiance cotangent ``g`` [N, 3] (see
    `rep_sum`; the rows of slots whose key is -1 are not written).
    ``replay_bwd_slots_cuda.shape`` holds the last launch's (blocks,
    threads a block, shared bytes)."""
    rep, rays, tape, pix_ctr, bg, g = (x.contiguous() for x in
                                       (rep, rays, tape, pix_ctr, bg, g))
    _check(tt, rep, rays, tape, pix_ctr, bg)
    n, K = rays.shape[0], tape.shape[0]
    if g.dtype != torch.float32 or g.shape != (n, 3) \
            or g.device != rays.device:
        raise ValueError("g must be f32 [N, 3] on the rays' device")
    lib, _ = load_bwd_kernel()
    if K > lib.replay_bwd_kmax():
        raise ValueError(f"the replay backward keeps at most "
                         f"{lib.replay_bwd_kmax()} bounces, got {K}")
    dev = rays.device
    d_rays = torch.empty((n, 7), dtype=torch.float32, device=dev)
    d_bg = torch.empty((n, 3), dtype=torch.float32, device=dev)
    keys = torch.empty((K, n), dtype=torch.int32, device=dev)
    rows = torch.empty((K, n, REP_COLS), dtype=torch.float32, device=dev)
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    prm = _params(tt, rep, bg, n, K, sample, t_min)
    shape = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.replay_bwd_launch(
            ctypes.byref(prm), rays.data_ptr(), tape.data_ptr(),
            pix_ctr.data_ptr(), g.data_ptr(), d_rays.data_ptr(),
            d_bg.data_ptr(), rows.data_ptr(), keys.data_ptr(),
            queue.data_ptr(), shape, stream)
    if err != 0:
        raise RuntimeError(f"replay backward kernel launch failed: CUDA "
                           f"error {err}")
    replay_bwd_slots_cuda.shape = tuple(shape)
    return keys, rows, d_rays, d_bg


replay_bwd_slots_cuda.shape = None


def replay_bwd_cuda(tt: ReplayTables, rep, rays, tape, pix_ctr, sample: int,
                    bg, g, *, t_min: float):
    """K4: (d_rep [NP, 27], d_rays [N, 7], d_bg [N, 3]) for the radiance
    cotangent ``g`` [N, 3]: the kernel's per lane-bounce slots
    (`replay_bwd_slots_cuda`) summed by `rep_sum_cuda` in an order fixed
    by the data, so all three repeat bit for bit from run to run.
    Launches on the current stream, no synchronisation."""
    keys, rows, d_rays, d_bg = replay_bwd_slots_cuda(
        tt, rep, rays, tape, pix_ctr, sample, bg, g, t_min=t_min)
    replay_bwd_cuda.launches += 1
    return rep_sum_cuda(keys, rows, tt.NP), d_rays, d_bg


replay_bwd_cuda.launches = 0


class ReplayFunction(torch.autograd.Function):
    """K3 forward, K4 backward; differentiable in ``rep``, ``rays`` and
    ``bg`` (the tape, counters and sample id are integers)."""

    @staticmethod
    def forward(ctx, rep, rays, bg, tt, tape, pix_ctr, sample, t_min):
        ctx.save_for_backward(rep, rays, bg, tape, pix_ctr)
        ctx.tt, ctx.sample, ctx.t_min = tt, sample, t_min
        return replay_fwd_cuda(tt, rep, rays, tape, pix_ctr, sample, bg,
                               t_min=t_min)

    @staticmethod
    def backward(ctx, g):
        rep, rays, bg, tape, pix_ctr = ctx.saved_tensors
        d_rep, d_rays, d_bg = replay_bwd_cuda(
            ctx.tt, rep, rays, tape, pix_ctr, ctx.sample, bg,
            g.to(torch.float32), t_min=ctx.t_min)
        return d_rep, d_rays, d_bg.sum(0), None, None, None, None, None


def replay(tt: ReplayTables, rays: torch.Tensor, tape: torch.Tensor,
           pix_ctr: torch.Tensor, sample: int, bg: torch.Tensor, *,
           t_min: float) -> torch.Tensor:
    """Radiance [N, 3] with winners fixed by ``tape`` [K, N] (rows of
    ``tt.rep``), differentiable in ``tt.rep``, ``rays`` [N, 7] and ``bg``
    [3]: the plain version for CPU tensors, K3 / K4 for CUDA tensors."""
    if rays.device.type == "cpu":
        return replay_plain(tt, rays, tape, pix_ctr, sample, bg, t_min=t_min)
    if rays.device.type == "cuda":
        return ReplayFunction.apply(tt.rep, rays, bg, tt,
                                    tape.to(torch.int32),
                                    pix_ctr.to(torch.int32), int(sample),
                                    float(t_min))
    raise ValueError(f"no replay for device {rays.device}")
