"""Multi-process bootstrap of the port: ``torch.distributed``.

Counterpart of ``raytracinginoneweekendincuda_tpu/parallel/distributed.py``
(``initialize``, ``global_mesh``, ``is_primary``).  The JAX package
stitches hosts into one runtime with ``jax.distributed.initialize``; here
each rank is one process with one device, joined by a process group.  The
same sharded programs (`parallel/render.py`, the mesh forms of
`parallel/train.py`) run in every rank.  Typical launch, one process a
card:

    python -m torch.distributed.run --nproc_per_node N \\
        -m raytracinginoneweekendincuda_torch.utils.cli --sharded ...

``torch.distributed.run`` sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``; `initialize` reads them.  Backends:
NCCL for CUDA tensors (one card a rank), gloo for the CPU, and gloo on
CUDA where several ranks share one card (NCCL refuses two ranks on one
device).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, else the global
    rank, else 0)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``device`` as given when it names an index
    or is not CUDA, else ``cuda:{LOCAL_RANK}``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, device="cuda") -> bool:
    """Join the default process group, once; True when there is one.

    Without arguments it reads ``torch.distributed.run``'s environment
    (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK`` picks the
    card) and returns False when there is none, as a single process.
    ``init_method`` (e.g. ``tcp://localhost:29500``) with ``world_size``
    and ``rank`` joins without the environment.  ``backend`` defaults to
    NCCL for a CUDA ``device`` and gloo for the CPU; ``backend="gloo"``
    on CUDA lets several ranks share one card.  NCCL with two ranks on
    one device raises ``ValueError``."""
    if dist.is_initialized():
        return True
    have_env = all(k in os.environ for k in _ENV)
    if init_method is None and not have_env:
        return False
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA tensors; use gloo "
                             "on the CPU")
        n_dev = torch.cuda.device_count()
        here = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        card = rank_device(device)
        if card.index >= n_dev or here > n_dev:
            raise ValueError(
                f"NCCL puts one rank on one device: {here} ranks on this "
                f"host, rank device {card}, {n_dev} CUDA device(s); use "
                f"backend='gloo' to let ranks share a card")
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def global_mesh(sample_shards: int | None = None, device="cuda"):
    """The (px, sp) mesh over every rank of the process group (the 1x1
    mesh without one), on this rank's device."""
    from .render import make_mesh

    return make_mesh(sample_shards=sample_shards, device=rank_device(device))


def is_primary() -> bool:
    """True on the process that writes output files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0
