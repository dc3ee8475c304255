"""HuggingFace-datasets ingestion.

Counterpart of ``phendiff_tpu/data/hf_datasets.py``: an HF dataset (an
image folder loaded as ``"imagefolder"``, an arrow dataset saved to disk,
or any dataset with an image and a label column) feeds the same batches as
``ImageFolderLoader``: decoded to uint8 RGB, then resized, scaled to
[-1, 1] and flipped by the port's native library (``data/native.py``).

The epoch order, its data-parallel shards and the flips come from the same
``np.random.default_rng`` seeds as the JAX adapter's with its defaults
(shuffled, full batches only), so both packages' adapters yield equal
batches, shard for shard.
``datasets`` is imported only by the loaders; the adapter takes any object
with the ``datasets.Dataset`` calls it makes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from phendiff_tpu_torch.data import native
from phendiff_tpu_torch.data.imagefolder import LoaderConfig, shard_order


def _to_uint8_rgb(img) -> np.ndarray:
    """PIL image or array -> HWC uint8 RGB."""
    if hasattr(img, "convert"):  # PIL
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


@dataclasses.dataclass
class HFDatasetAdapter:
    """An HF dataset behind the batch-loader interface (``epoch``,
    ``len``), with the Evaluator's (``classes``, ``for_class``,
    ``raw_images``).

    ``classes`` are the label feature's names for a ``ClassLabel`` column;
    a plain integer or string label column is remapped to dense 0..n-1 in
    sorted order (numeric where the values are integers).
    """

    dataset: "object"  # datasets.Dataset
    config: LoaderConfig
    image_key: str = "image"
    label_key: str = "label"

    def __post_init__(self):
        feat = self.dataset.features.get(self.label_key)
        if hasattr(feat, "names"):  # ClassLabel: values are 0..n-1 already
            self.classes: Tuple[str, ...] = tuple(feat.names)
            self._label_map = None
        else:
            raw = sorted(
                set(self.dataset[self.label_key]),
                key=lambda v: (0, int(v)) if str(v).lstrip("-").isdigit() else (1, str(v)),
            )
            self.classes = tuple(str(v) for v in raw)
            self._label_map = {v: i for i, v in enumerate(raw)}

    def _map_labels(self, values) -> np.ndarray:
        if self._label_map is None:
            return np.asarray(values, dtype=np.int32)
        return np.asarray([self._label_map[v] for v in values], dtype=np.int32)

    def __len__(self) -> int:  # full batches per epoch of this shard
        return len(self.dataset) // self.config.num_shards // self.config.batch_size

    @property
    def nb_classes(self) -> int:
        return len(self.classes)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        return shard_order(len(self.dataset), self.config, epoch)

    def _rows(self, idxs):
        """(decoded uint8 images, dense labels) of the given rows."""
        rows = self.dataset[[int(i) for i in idxs]]
        raws = [_to_uint8_rgb(im) for im in rows[self.image_key]]
        return raws, self._map_labels(rows[self.label_key])

    def epoch(self, epoch: int = 0, skip_batches: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The batches of ``epoch`` from ``skip_batches`` on."""
        cfg = self.config
        order = self._epoch_order(epoch)
        rng = np.random.default_rng((cfg.seed, epoch, cfg.shard_index, 1))
        for b in range(skip_batches, len(self)):
            raws, labels = self._rows(order[b * cfg.batch_size:(b + 1) * cfg.batch_size])
            if cfg.normalize:
                flips = None
                if cfg.random_flip:
                    flips = (rng.random((len(raws), 2)) < 0.5).astype(np.int32)
                imgs = native.batch_resize_normalize(raws, cfg.definition, flips=flips)
            else:
                imgs = np.stack([native.resize_u8(r, cfg.definition) for r in raws])
            yield imgs, labels

    # -- evaluation support --------------------------------------------------
    def for_class(self, class_label: int) -> "HFDatasetAdapter":
        """The adapter over one class's rows (``class_label`` is the dense
        index; a remapped column is filtered by its raw value)."""
        if self._label_map is None:
            def keep(label):
                return int(label) == int(class_label)
        else:
            target = {i: v for v, i in self._label_map.items()}[int(class_label)]

            def keep(label):
                return label == target
        sub = self.dataset.filter(keep, input_columns=self.label_key)
        return HFDatasetAdapter(sub, self.config, self.image_key, self.label_key)

    def raw_images(self, batch_size: int, definition: Tuple[int, int]
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One pass in dataset order of resized uint8 images (the metrics'
        reference set), the last batch possibly short."""
        n = len(self.dataset)
        for start in range(0, n, batch_size):
            raws, labels = self._rows(range(start, min(start + batch_size, n)))
            yield np.stack([native.resize_u8(r, definition) for r in raws]), labels


def load_hf_imagefolder(path: str, config: LoaderConfig, split: str = "train",
                        image_key: str = "image", label_key: str = "label") -> HFDatasetAdapter:
    """``datasets.load_dataset("imagefolder", data_dir=path)`` as an adapter."""
    import datasets

    ds = datasets.load_dataset("imagefolder", data_dir=path, split=split)
    return HFDatasetAdapter(ds, config, image_key, label_key)


def load_hf_dataset(
    name: str, config: LoaderConfig, *, split: str = "train",
    config_name: Optional[str] = None, cache_dir: Optional[str] = None,
    image_key: str = "image", label_key: str = "label",
) -> HFDatasetAdapter:
    """An HF dataset by path or name (the reference's ``--dataset_name``,
    ``--dataset_config_name``, ``--split`` and ``--cache_dir``).

    A directory holding an arrow dataset (``save_to_disk``'s
    ``dataset_info.json``, ``dataset_dict.json`` or ``*.arrow`` files)
    loads from disk; any other directory loads as an ``"imagefolder"``;
    anything else is a hub id, which needs the network.
    """
    import datasets

    if os.path.isdir(name):
        if (os.path.exists(os.path.join(name, "dataset_info.json"))
                or os.path.exists(os.path.join(name, "dataset_dict.json"))
                or any(f.endswith(".arrow") for f in os.listdir(name))):
            ds = datasets.load_from_disk(name)
            if isinstance(ds, datasets.DatasetDict):
                ds = ds[split] if split else ds[next(iter(ds))]
        else:
            ds = datasets.load_dataset("imagefolder", data_dir=name, split=split or "train",
                                       cache_dir=cache_dir)
    else:
        ds = datasets.load_dataset(name, config_name, split=split or "train",
                                   cache_dir=cache_dir)
    return HFDatasetAdapter(ds, config, image_key, label_key)
