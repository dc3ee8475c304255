"""Generate a small learnable 2-class image folder for trained-model
numerics runs (``phendiff_tpu_torch/tools/reco_err.py``).

The port's own copy of ``tools/make_toy_dataset.py``: the same draws from
the same seed, so both write byte-equal PNGs.  Class "blobs": gaussian
bumps on a dark background.  Class "stripes": oriented sinusoidal gratings.
Both at ``--res`` with mild colour jitter, so a conditional DDIM at
``super_small`` scale learns them quickly.

    python -m phendiff_tpu_torch.tools.make_toy_dataset OUTDIR [--n 256] [--res 128] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image


def blobs(rng: np.random.Generator, res: int) -> np.ndarray:
    img = np.zeros((res, res, 3), np.float32)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    for _ in range(rng.integers(3, 7)):
        cy, cx = rng.uniform(0.15, 0.85, 2) * res
        s = rng.uniform(0.05, 0.12) * res
        g = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
        color = rng.uniform(0.4, 1.0, 3)
        img += g[..., None] * color
    return np.clip(img, 0, 1)


def stripes(rng: np.random.Generator, res: int) -> np.ndarray:
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    theta = rng.uniform(0, np.pi)
    freq = rng.uniform(4, 9)
    phase = rng.uniform(0, 2 * np.pi)
    wave = 0.5 + 0.5 * np.sin(
        2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy) + phase
    )
    color = rng.uniform(0.4, 1.0, 3)
    base = rng.uniform(0.0, 0.15, 3)
    return np.clip(wave[..., None] * color + base, 0, 1)


def write(outdir: str, n: int = 256, res: int = 128, seed: int = 0) -> None:
    """``n`` PNGs a class under ``outdir/blobs`` and ``outdir/stripes``."""
    rng = np.random.default_rng(seed)
    for name, fn in (("blobs", blobs), ("stripes", stripes)):
        d = os.path.join(outdir, name)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            arr = (fn(rng, res) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i:04d}.png"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write(args.outdir, args.n, args.res, args.seed)
    print(f"wrote 2x{args.n} images at {args.res}px to {args.outdir}")


if __name__ == "__main__":
    main()
