"""Image conversion and the originals/transfers panel.

Counterpart of ``to_pil`` and ``side_by_side`` in
``phendiff_tpu/obs/images.py``, over NHWC numpy arrays.  PIL is imported
inside the functions.
"""

from __future__ import annotations

from typing import List

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
