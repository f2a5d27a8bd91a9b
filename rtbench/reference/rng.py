"""Counter-based RNG (pcg4d) on int32 tensors: every draw is a hash of
(seed ^ pixel, sample, stream | bounce, slot), with no generator state.

int32 add and multiply wrap as uint32 does, XOR is bitwise, and the
logical right shift masks off the sign-extended bits.
"""

from __future__ import annotations

import numpy as np
import torch

CAMERA_STREAM = 0x0CA30000
SCATTER_STREAM = 0x5CA70000
INV_2POW24 = float(np.float32(1.0 / 16777216.0))
_MUL = 1664525
_INC = 1013904223


def to_word(x: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (32 - n)) - 1)


def pcg4d(v0, v1, v2, v3):
    """The 4-word counter hash over int32 tensors of one shape."""
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


def unit(word: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Word -> float in [0, 1) from its top 24 bits (exact in f32)."""
    return (_shr(word, 8).to(torch.float32) * INV_2POW24).to(dtype)


def uniform4(pix_ctr: torch.Tensor, sample, stream: int, slot: int,
             dtype=torch.float32):
    """Four uniforms in [0, 1) for the counter (pix_ctr, sample, stream,
    slot); ``sample`` an int or a tensor like ``pix_ctr``."""
    def word(v):
        return torch.broadcast_to(torch.as_tensor(
            v, dtype=torch.int32, device=pix_ctr.device), pix_ctr.shape)
    return tuple(unit(w, dtype) for w in pcg4d(
        pix_ctr, word(sample), word(to_word(stream)), word(slot)))
