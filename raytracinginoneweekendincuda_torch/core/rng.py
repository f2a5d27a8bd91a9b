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


def _unit_numpy(word, float_dtype):
    """uint32 word -> float in [0, 1) from its top 24 bits (numpy)."""
    scale = np.dtype(float_dtype).type(1.0 / 16777216.0)
    return (word >> 8).astype(float_dtype) * scale


def uniform4_numpy(pixel, sample, stream, slot, *, float_dtype):
    """`uniform4` over numpy uint32 arrays (the JAX package's numpy path,
    expression for expression): four uniforms in [0, 1)."""
    return tuple(_unit_numpy(w, float_dtype)
                 for w in pcg4d_numpy(pixel, sample, stream, slot))


def uniform_open4_numpy(pixel, sample, stream, slot, *, float_dtype):
    """`uniform_open4` over numpy uint32 arrays: four uniforms in (0, 1]."""
    one = np.dtype(float_dtype).type(1.0 / 16777216.0)
    return tuple(_unit_numpy(w, float_dtype) + one
                 for w in pcg4d_numpy(pixel, sample, stream, slot))


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


def unit(word: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Word -> float in [0, 1) from its top 24 bits (exact in f32 and
    f64)."""
    return _shr(word, 8).to(dtype) * INV_2POW24


def _words(pix_ctr, sample, stream, slot):
    """pcg4d of one counter tuple: int32 tensors or ints, broadcast to a
    common shape."""
    dev = pix_ctr.device
    args = [torch.as_tensor(v, dtype=torch.int32, device=dev)
            for v in (pix_ctr, sample, stream, slot)]
    shape = torch.broadcast_shapes(*(a.shape for a in args))
    return pcg4d(*(torch.broadcast_to(a, shape) for a in args))


def uniform4(pix_ctr, sample, stream, slot, dtype=torch.float32):
    """Four uniforms in [0, 1) for one counter tuple (int32 tensors or ints,
    broadcast against each other)."""
    return tuple(unit(w, dtype) for w in _words(pix_ctr, sample, stream,
                                                slot))


def uniform_open4(pix_ctr, sample, stream, slot, dtype=torch.float32):
    """Four uniforms in (0, 1] -- curand_uniform's range, so log() of a
    draw is finite (ConstantMedium.h:26)."""
    return tuple(unit(w, dtype) + INV_2POW24
                 for w in _words(pix_ctr, sample, stream, slot))


def as_uint32(x: torch.Tensor) -> np.ndarray:
    """int32 words -> numpy uint32 with the same bits."""
    return x.cpu().numpy().view(np.uint32)
