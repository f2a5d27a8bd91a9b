"""The replay's kernels on the card: K3 (forward) and K4 (backward).

Counterpart of ``raytracinginoneweekendincuda_tpu/ops/pallas_replay.py``.
K3 (``csrc/replay_fwd.cu``) replaces ``_fwd_kernel_factory`` and K4
(``csrc/replay_bwd.cu``) replaces ``_bwd_kernel_factory``; both share the
bounce of ``csrc/replay_bounce.cuh``.  `ReplayFunction` is the pair as one
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


# K4's largest block (``kBlock`` in csrc/replay_bwd.cu; the loader checks
# the two agree) and the words of a bounce state (o, d, thr).
BWD_BLOCK = 384
STATE_WORDS = 9


def bwd_rep_in_shared(np_rows: int, K: int, smem_optin: int,
                      threads: int = BWD_BLOCK) -> bool:
    """Whether K4 sums d_rep in shared memory: its bounce states (K x 9
    words a thread) and the table's cotangent (np_rows x 27 words) fit a
    block's opt-in shared memory.  Otherwise the other instantiation adds
    into the global d_rep.  Scene 0 (512 rows) at K 8 fits the H100's
    232,448 bytes; scene 9 (3,522 rows) does not."""
    need = 4 * (STATE_WORDS * K * threads + REP_COLS * np_rows)
    return need <= smem_optin


def load_bwd_kernel():
    """Build (at first use) and load K4; returns (CDLL, build record)."""
    lib, record = _load("replay_bwd", "replay_bwd_launch",
                        [ctypes.POINTER(_Params), _P, _P, _P, _P, _P, _P,
                         _P, _P, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                         _P])
    for name in ("replay_bwd_kmax", "replay_bwd_block",
                 "replay_bwd_smem_optin"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if lib.replay_bwd_block() != BWD_BLOCK:
        raise RuntimeError("K4's block and BWD_BLOCK differ")
    return lib, record


def bwd_smem_optin() -> int:
    """The opt-in shared memory a block may use on the current CUDA
    device, bytes (K4's query, for `bwd_rep_in_shared`)."""
    return load_bwd_kernel()[0].replay_bwd_smem_optin()


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


def replay_bwd_cuda(tt: ReplayTables, rep, rays, tape, pix_ctr, sample: int,
                    bg, g, *, t_min: float):
    """K4: (d_rep [NP, 27], d_rays [N, 7], d_bg [N, 3]) for the radiance
    cotangent ``g`` [N, 3].  d_rep is summed over lanes with atomics (in
    shared memory first where `bwd_rep_in_shared` says it fits), so its
    last bits vary from run to run; d_rays and d_bg do not.
    ``replay_bwd_cuda.shape`` holds the last launch's (blocks, threads a
    block, shared bytes) and ``replay_bwd_cuda.rep_shared`` whether it
    summed d_rep in shared memory."""
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
    d_rep = torch.zeros((tt.NP, REP_COLS), dtype=torch.float32, device=dev)
    d_rays = torch.empty((n, 7), dtype=torch.float32, device=dev)
    d_bg = torch.empty((n, 3), dtype=torch.float32, device=dev)
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    prm = _params(tt, rep, bg, n, K, sample, t_min)
    shape = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        rep_shared = bwd_rep_in_shared(tt.NP, K, bwd_smem_optin())
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.replay_bwd_launch(
            ctypes.byref(prm), rays.data_ptr(), tape.data_ptr(),
            pix_ctr.data_ptr(), g.data_ptr(), d_rays.data_ptr(),
            d_rep.data_ptr(), d_bg.data_ptr(), queue.data_ptr(),
            int(rep_shared), shape, stream)
    if err != 0:
        raise RuntimeError(f"replay backward kernel launch failed: CUDA "
                           f"error {err}")
    replay_bwd_cuda.launches += 1
    replay_bwd_cuda.shape = tuple(shape)
    replay_bwd_cuda.rep_shared = rep_shared
    return d_rep, d_rays, d_bg


replay_bwd_cuda.launches = 0
replay_bwd_cuda.shape = None
replay_bwd_cuda.rep_shared = None


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
