"""Image output (PPM / PNG) and texture-image input.

Reproduces the reference's exact pixel pipelines:

* PPM writer: `kernel.cu:696-724` — P3, scanlines written bottom-up, clamp
  to [0, 0.999], quantize ``int(256 * c)``.
* Texture-image loader: `RtwImage.h:51-87` + stb's ``stbi_loadf`` defaults —
  8-bit sRGB decoded, converted to linear floats with gamma 2.2
  (stb ldr->hdr default), re-quantized to bytes via ``FloatToByte``
  (`RtwImage.h:100-105`), sampled as ``byte / 255`` (`Texture.h:129-132`).

The port's own copy of ``raytracinginoneweekendincuda_tpu/core/image.py``:
the PPM is serialized by numpy only (the JAX package's optional C++ writer
in ``native/`` writes the same bytes and is not carried over).
"""

from __future__ import annotations

import os

import numpy as np


def framebuffer_to_bytes(image: np.ndarray) -> np.ndarray:
    """Gamma-corrected framebuffer [H,W,3] float -> uint8 per kernel.cu:709-718.

    Input rows are top-down (row 0 = top of image); values already
    gamma-corrected (sqrt applied by the render epilogue, kernel.cu:150-152).
    """
    image = np.asarray(image)
    if image.dtype == np.uint8:       # already quantized on device
        return image
    c = np.clip(image.astype(np.float64), 0.0, 0.999)
    return (256.0 * c).astype(np.uint8)


def write_ppm(path: str, image: np.ndarray) -> None:
    """Write a P3 PPM exactly as the reference does (kernel.cu:696-724).

    ``image`` is [H,W,3] float, row 0 = top (the reference iterates its
    bottom-origin framebuffer from j=H-1 down, producing a top-down file —
    our top-down rows map 1:1).
    """
    q = framebuffer_to_bytes(image).astype(np.int32)
    h, w, _ = q.shape
    flat = q.reshape(-1, 3)
    body = "\n".join(" ".join(map(str, px)) for px in flat)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write(body)
        f.write("\n")


def write_png(path: str, image: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(framebuffer_to_bytes(image), "RGB").save(path)


def load_texture_image(path: str) -> np.ndarray | None:
    """Decode an image to the reference's RGB byte buffer, as float [H,W,3].

    Pipeline parity with `RtwImage::Load` (RtwImage.h:51-87):
      bytes --(/255)--> sRGB float --(^2.2, stb ldr->hdr default)--> linear
      float --(FloatToByte: clamp, *256, trunc)--> byte --(/255)--> float.

    Returns ``None`` when the file is missing/unreadable — the texture layer
    then shows debug cyan (Texture.h:112-114).
    """
    if not os.path.exists(path):
        return None
    try:
        from PIL import Image

        raw = np.asarray(Image.open(path).convert("RGB"), np.float64)
    except Exception:
        return None
    linear = (raw / 255.0) ** 2.2
    byte = np.clip(256.0 * linear, 0.0, 255.0).astype(np.uint8)
    byte = np.where(linear >= 1.0, np.uint8(255), byte)
    return byte.astype(np.float32) / 255.0


def default_asset(name: str) -> str:
    """Path of a bundled asset (assets/ at the repo root)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "assets", name)
