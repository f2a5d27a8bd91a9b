"""Counter-based RNG (pcg4d) on int32 tensors.

Port of ``raytracinginoneweekendincuda_tpu/core/rng.py``: every draw is a
pure hash of ``(seed ^ pixel, sample, stream | bounce, slot)``, so there is
no generator state and a draw does not depend on how rays are batched.

PyTorch has no uint32 arithmetic on the CPU, so the words live in int32
tensors.  Two's-complement add and multiply wrap exactly like uint32, XOR
is bitwise, and the logical right shift is an arithmetic shift with the
sign-extended bits masked off.  The results are bit-identical to the numpy
uint32 reference; ``as_uint32`` reinterprets them for comparison.
"""

from __future__ import annotations

import numpy as np
import torch

# stream words (the third counter word), as in the JAX package's rng.py
CAMERA_STREAM = 0x0CA30000
SCATTER_STREAM = 0x5CA70000
MEDIUM_STREAM = 0x3ED00000

INV_2POW24 = float(np.float32(1.0 / 16777216.0))

_MUL = 1664525
_INC = 1013904223


def pcg4d_numpy(v0, v1, v2, v3):
    """The same hash over numpy uint32 arrays (the JAX package's numpy
    reference; arrays wrap silently where scalars would warn)."""
    v0 = v0 * 1664525 + 1013904223
    v1 = v1 * 1664525 + 1013904223
    v2 = v2 * 1664525 + 1013904223
    v3 = v3 * 1664525 + 1013904223

    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2

    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)

    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def to_word(x: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 words."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def pcg4d(v0, v1, v2, v3):
    """4-lane counter hash over int32 tensors of one shape (uint32 bits)."""
    v0 = v0 * _MUL + _INC
    v1 = v1 * _MUL + _INC
    v2 = v2 * _MUL + _INC
    v3 = v3 * _MUL + _INC

    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2

    v0 = v0 ^ _shr(v0, 16)
    v1 = v1 ^ _shr(v1, 16)
    v2 = v2 ^ _shr(v2, 16)
    v3 = v3 ^ _shr(v3, 16)

    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def unit(word: torch.Tensor) -> torch.Tensor:
    """Word -> f32 in [0, 1) from its top 24 bits (exact in f32)."""
    return _shr(word, 8).to(torch.float32) * INV_2POW24


def uniform4(pix_ctr, sample, stream, slot):
    """Four uniforms in [0, 1) for one counter tuple (int32 tensors or ints
    broadcast against ``pix_ctr``)."""
    full = lambda v: torch.broadcast_to(
        torch.as_tensor(v, dtype=torch.int32, device=pix_ctr.device),
        pix_ctr.shape)
    words = pcg4d(pix_ctr, full(sample), full(stream), full(slot))
    return tuple(unit(w) for w in words)


def as_uint32(x: torch.Tensor) -> np.ndarray:
    """int32 words -> numpy uint32 with the same bits."""
    return x.cpu().numpy().view(np.uint32)
