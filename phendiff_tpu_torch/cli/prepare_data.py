"""Offline dataset preparation tool.

Counterpart of ``phendiff_tpu/cli/prepare_data.py``: given a source
imagefolder, produce a training-ready dataset by

1. balanced per-class selection (equal counts per class),
2. a reproducible 50/50 (configurable) train/test split,
3. optional on-disk Dih4 augmentation of the TRAIN split: all 8 symmetries
   of the square (4 rotations x optional flip), written as
   ``<stem>_rot{k}[_flip].png``.

The same source, fraction and seed give the same files as the JAX
package's tool.

Usage:
    python -m phendiff_tpu_torch.cli.prepare_data --source raw/ --dest prepared/ \\
        [--test_frac 0.5] [--augment_dih4] [--seed 0]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
from PIL import Image

from phendiff_tpu_torch.data.imagefolder import scan_imagefolder


def dih4_variants(img: Image.Image):
    """All 8 symmetries of the square, keyed by (rotation_quarters, flipped)."""
    for k in range(4):
        rotated = img.rotate(90 * k, expand=True)
        yield (k, False), rotated
        yield (k, True), rotated.transpose(Image.FLIP_LEFT_RIGHT)


def prepare(source: str, dest: str, test_frac: float, augment: bool, seed: int):
    """Write the split (and augmented) dataset under ``dest``; returns
    ``{"<split>/<class>": images written}``."""
    index = scan_imagefolder(source)
    per_class = int(index.class_counts().min())
    rng = np.random.default_rng(seed)
    labels = np.array(index.labels)

    stats = {}
    for ci, cname in enumerate(index.classes):
        cls_idx = np.nonzero(labels == ci)[0]
        keep = rng.choice(cls_idx, size=per_class, replace=False)
        rng.shuffle(keep)
        n_test = int(round(per_class * test_frac))
        splits = {"test": keep[:n_test], "train": keep[n_test:]}
        for split, idxs in splits.items():
            out_dir = Path(dest) / split / cname
            out_dir.mkdir(parents=True, exist_ok=True)
            n_written = 0
            for i in idxs:
                src_path = Path(index.paths[i])
                with Image.open(src_path) as im:
                    im = im.convert("RGB")
                    if augment and split == "train":
                        for (k, flipped), variant in dih4_variants(im):
                            suffix = f"_rot{k}" + ("_flip" if flipped else "")
                            variant.save(out_dir / f"{src_path.stem}{suffix}.png")
                            n_written += 1
                    else:
                        im.save(out_dir / f"{src_path.stem}.png")
                        n_written += 1
            stats[f"{split}/{cname}"] = n_written
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser("phendiff-prepare-data")
    p.add_argument("--source", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--test_frac", type=float, default=0.5)
    p.add_argument("--augment_dih4", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    stats = prepare(args.source, args.dest, args.test_frac, args.augment_dih4, args.seed)
    for k in sorted(stats):
        print(f"{k}: {stats[k]} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
