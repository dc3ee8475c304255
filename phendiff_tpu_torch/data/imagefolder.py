"""Host-side image-folder dataset and epoch batch iterator.

The port's own copy of ``phendiff_tpu/data/imagefolder.py``, same
semantics:

* ``ImageFolder`` layout: one subdirectory per class, sorted class names
  give the integer labels;
* bilinear resize to ``definition``, scale to [-1, 1], optional random
  horizontal and vertical flips (the native C++ library, ``data/native.py``);
* class-balanced subsampling to ``perc_samples`` percent per class with a
  dedicated seed;
* an epoch order fixed by ``(seed, epoch)``, so a resumed run skips the
  batches it already consumed exactly, and a background thread that
  prefetches batches as numpy NHWC arrays;
* data-parallel shards (``num_shards``, ``shard_index``): each takes a
  contiguous part of the epoch's shared permutation, ``len`` counts one
  shard's batches and a shard's flips come from ``(seed, epoch,
  shard_index, 1)``;
* a "raw" view (resize only, uint8, ``normalize=False``) read in file
  order by ``all_images``: the metrics' reference set and the comparison
  engine's inputs.

PIL is imported inside the decode function only, so the package imports
without it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}


@dataclasses.dataclass(frozen=True)
class DatasetIndex:
    """Immutable file index: paths, integer labels, class names."""

    paths: Tuple[str, ...]
    labels: Tuple[int, ...]
    classes: Tuple[str, ...]

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def nb_classes(self) -> int:
        return len(self.classes)

    def class_counts(self) -> np.ndarray:
        return np.bincount(np.array(self.labels), minlength=self.nb_classes)

    def subset(self, indices: Sequence[int]) -> "DatasetIndex":
        return DatasetIndex(
            paths=tuple(self.paths[i] for i in indices),
            labels=tuple(self.labels[i] for i in indices),
            classes=self.classes,
        )

    def for_class(self, label: int) -> "DatasetIndex":
        return self.subset([i for i, lab in enumerate(self.labels) if lab == label])


def scan_imagefolder(root) -> DatasetIndex:
    root = Path(root)
    if not root.is_dir():
        raise FileNotFoundError(f"dataset root not found: {root}")
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if not classes:
        raise ValueError(f"no class subdirectories under {root}")
    paths: List[str] = []
    labels: List[int] = []
    for ci, cname in enumerate(classes):
        files = sorted(p for p in (root / cname).rglob("*") if p.suffix.lower() in IMG_EXTENSIONS)
        paths.extend(str(p) for p in files)
        labels.extend([ci] * len(files))
    if not paths:
        raise ValueError(f"no images found under {root}")
    return DatasetIndex(tuple(paths), tuple(labels), tuple(classes))


def balanced_subsample(index: DatasetIndex, perc_samples: float, seed: int) -> DatasetIndex:
    """Keep ``perc_samples`` percent of each class, chosen with a dedicated
    RNG so resumed runs see the same subset; the classes must be balanced."""
    if not 0 < perc_samples <= 100:
        raise ValueError("perc_samples must be in (0, 100]")
    if perc_samples == 100:
        return index
    counts = index.class_counts()
    if not np.all(counts == counts[0]):
        raise ValueError(f"balanced_subsample requires a class-balanced dataset; got {counts}")
    per_class = max(1, round(counts[0] * perc_samples / 100))
    rng = np.random.default_rng(seed)
    keep: List[int] = []
    labels = np.array(index.labels)
    for ci in range(index.nb_classes):
        cls_idx = np.nonzero(labels == ci)[0]
        keep.extend(rng.choice(cls_idx, size=per_class, replace=False).tolist())
    keep.sort()
    return index.subset(keep)


def decode_image(path: str) -> np.ndarray:
    """Decode to HWC uint8 RGB at native resolution."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_image(path: str, definition: Tuple[int, int], normalize: bool = True) -> np.ndarray:
    """Decode and resize one image (the native library's bilinear resize):
    float32 in [-1, 1], or with ``normalize=False`` the raw uint8 pixels."""
    from phendiff_tpu_torch.data import native

    raw = decode_image(path)
    if not normalize:
        return native.resize_u8(raw, definition)
    return native.batch_resize_normalize([raw], definition)[0]


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 16
    definition: Tuple[int, int] = (128, 128)
    normalize: bool = True  # False: the raw uint8 view
    # "f32": normalised [-1, 1] float32 batches; "uint8": the resized pixels
    # quantised back to uint8 (the train step normalises on the device)
    transport: str = "f32"
    random_flip: bool = False  # H and V flips, each with p = 0.5
    seed: int = 0
    prefetch: int = 2
    num_shards: int = 1  # data-parallel process count
    shard_index: int = 0


def shard_order(n: int, config: LoaderConfig, epoch: int) -> np.ndarray:
    """This shard's part of epoch ``epoch``'s order of ``n`` samples: the
    permutation every shard draws from ``(seed, epoch)``, split into
    ``num_shards`` contiguous parts."""
    order = np.arange(n)
    np.random.default_rng((config.seed, epoch)).shuffle(order)
    per = n // config.num_shards
    return order[config.shard_index * per:(config.shard_index + 1) * per]


class ImageFolderLoader:
    """Epoch-based batch iterator over a ``DatasetIndex``, deterministic
    given (seed, epoch): a shuffled order, full batches only."""

    def __init__(self, index: DatasetIndex, config: LoaderConfig):
        self.index = index
        self.config = config

    def __len__(self) -> int:  # batches per epoch of this shard
        return len(self.index) // self.config.num_shards // self.config.batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        return shard_order(len(self.index), self.config, epoch)

    def _make_batch(self, idxs: np.ndarray, rng: np.random.Generator):
        from phendiff_tpu_torch.data import native

        cfg = self.config
        labels = np.array([self.index.labels[i] for i in idxs], dtype=np.int32)
        if not cfg.normalize:
            return np.stack([load_image(self.index.paths[i], cfg.definition, False)
                             for i in idxs]), labels
        raws = [decode_image(self.index.paths[i]) for i in idxs]
        flips = None
        if cfg.random_flip:
            flips = (rng.random((len(idxs), 2)) < 0.5).astype(np.int32)
        imgs = native.batch_resize_normalize(raws, cfg.definition, flips=flips)
        if cfg.transport == "uint8":
            imgs = np.clip(np.round((imgs + 1.0) * 127.5), 0, 255).astype(np.uint8)
        return imgs, labels

    def epoch(self, epoch: int = 0, skip_batches: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The batches of ``epoch`` from ``skip_batches`` on."""
        cfg = self.config
        order = self._epoch_order(epoch)
        nb = len(self)
        rng = np.random.default_rng((cfg.seed, epoch, cfg.shard_index, 1))

        def producer(q: queue.Queue):
            try:
                for b in range(skip_batches, nb):
                    idxs = order[b * cfg.batch_size:(b + 1) * cfg.batch_size]
                    q.put(self._make_batch(idxs, rng))
            finally:
                q.put(None)

        q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch, 1))
        threading.Thread(target=producer, args=(q,), daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    def all_images(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One pass over the whole index in file order, the last batch
        possibly short."""
        rng = np.random.default_rng(0)
        n, bs = len(self.index), self.config.batch_size
        for start in range(0, n, bs):
            yield self._make_batch(np.arange(start, min(start + bs, n)), rng)
