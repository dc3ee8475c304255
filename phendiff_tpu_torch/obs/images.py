"""Image conversion, grids and the originals/transfers panel.

Counterpart of ``phendiff_tpu/obs/images.py``, over NHWC numpy arrays:
``to_pil``, ``latents_to_grayscale`` (how SD latents are shown),
``image_grid`` and ``side_by_side``.  PIL is imported inside the
functions.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def to_pil(images, normalize: str = "clip") -> List["Image.Image"]:  # noqa: F821
    """[B, H, W, C] or [H, W, C], uint8 or float, to PIL images.
    ``normalize``: "clip" ([-1, 1] -> [0, 1]), "minmax" per image, or
    "channel_minmax" per image and channel; uint8 passes through."""
    from PIL import Image

    arr = np.asarray(images)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.dtype == np.uint8:
        scaled = arr.astype(np.float32) / 255.0
    elif normalize == "clip":
        scaled = np.clip(arr / 2.0 + 0.5, 0.0, 1.0)
    elif normalize in ("minmax", "channel_minmax"):
        axes = (1, 2, 3) if normalize == "minmax" else (1, 2)
        lo = arr.min(axis=axes, keepdims=True)
        hi = arr.max(axis=axes, keepdims=True)
        scaled = (arr - lo) / np.maximum(hi - lo, 1e-12)
    else:
        raise ValueError(f"unknown normalize mode: {normalize}")
    out = []
    for img in (scaled * 255).astype(np.uint8):
        out.append(Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img))
    return out


def latents_to_grayscale(latents) -> np.ndarray:
    """Channel mean, then min-max per sample: [B, H, W, C] -> [B, H, W, 1]
    float32 in [0, 1]."""
    arr = np.asarray(latents, dtype=np.float32).mean(axis=-1, keepdims=True)
    lo = arr.min(axis=(1, 2, 3), keepdims=True)
    hi = arr.max(axis=(1, 2, 3), keepdims=True)
    return (arr - lo) / np.maximum(hi - lo, 1e-12)


def image_grid(images, cols: Optional[int] = None, normalize: str = "clip") -> "Image.Image":  # noqa: F821
    """A batch tiled row by row into one RGB image, ``cols`` wide (by
    default the ceiling of the square root of the batch)."""
    from PIL import Image

    pils = to_pil(images, normalize)
    n = len(pils)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    w, h = pils[0].size
    grid = Image.new("RGB", (cols * w, rows * h))
    for i, img in enumerate(pils):
        grid.paste(img.convert("RGB"), ((i % cols) * w, (i // cols) * h))
    return grid


def side_by_side(originals, transferred, normalize: str = "clip") -> "Image.Image":  # noqa: F821
    """Pairs panel: row i is (original i, transferred i)."""
    from PIL import Image

    a = to_pil(originals, normalize)
    b = to_pil(transferred, normalize)
    w, h = a[0].size
    grid = Image.new("RGB", (2 * w, len(a) * h))
    for i, (o, t) in enumerate(zip(a, b)):
        grid.paste(o.convert("RGB"), (0, i * h))
        grid.paste(t.convert("RGB"), (w, i * h))
    return grid
