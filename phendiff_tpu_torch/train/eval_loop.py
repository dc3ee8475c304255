"""Evaluation: per-class generation -> FID/ISC/KID -> best-model tracking.

Counterpart of ``phendiff_tpu/train/eval_loop.py``:

* generation uses the EMA weights (the trainer's ``generate_fn``);
* a fixed eval seed (``rng.EVAL_SEED``): the generator of batch ``i`` of
  class ``c`` is seeded from ``(EVAL_SEED, c, i)``, so sample panels repeat
  across evaluations;
* per-class generation in full batches trimmed to ``nb_generated_images``;
  unconditional mode is one pseudo-class;
* per-class FID/ISC/KID against the raw (uint8, resized) dataset, the
  reference features cached on disk under a key tied to the reference
  set (definition and file list), not to the class name alone;
* best model = lower mean ``main_metric`` across classes, from +inf;
* ``inception_pretrained`` (1.0 or 0.0) in every record.

Generated images stay on the device through the Inception extractor; only
features and the first batch's panel come back to the host.

Under data parallelism (``parallel/mesh.py``) each process generates its
rows of every (class, batch), the batch padded by cycling to a multiple of
the data size (the JAX Trainer's eval sharding); its start noise is its
rows of the whole batch's draw (``core.rng.RowsOf``), the noise world 1
draws.  Features, logits and the first batch's panel are all-gathered
and trimmed to the real rows (the JAX Evaluator's ``_gather``); rank 0
computes the metrics (one host FID a class) and hands them to every rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from phendiff_tpu_torch.core.device import DeviceLike
from phendiff_tpu_torch.core.rng import EVAL_SEED, RowsOf, derive_seed
from phendiff_tpu_torch.data.imagefolder import DatasetIndex, ImageFolderLoader, LoaderConfig
from phendiff_tpu_torch.metrics.fidelity import FeatureCache, MetricsConfig, calculate_metrics
from phendiff_tpu_torch.metrics.inception import InceptionExtractor
from phendiff_tpu_torch.parallel.mesh import (
    all_gather_rows,
    broadcast_object,
    is_main,
    padded_rows,
)
from phendiff_tpu_torch.pipelines.conditional_ddim import to_images

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalConfig:
    # Reference default: 1000 generated images per class, enough for a
    # usable FID and for KID's subset_size=1000.
    nb_generated_images: int = 1000
    eval_batch_size: int = 32
    num_inference_steps: int = 50
    guidance_factor: float = 0.0  # CFG weight used for eval generation
    main_metric: str = "frechet_inception_distance"  # lower is better
    metrics: MetricsConfig = dataclasses.field(default_factory=MetricsConfig)
    unconditional: bool = False  # proba_uncond == 1 mode


def get_initial_best_metric() -> float:
    return math.inf


def is_it_best_model(current: float, best: float) -> bool:
    """Lower is better."""
    return current < best


class Evaluator:
    def __init__(
        self,
        config: EvalConfig,
        raw_index,  # the reference set: a DatasetIndex or an HFDatasetAdapter
        definition,
        cache_root: Optional[str] = None,
        extractor: Optional[InceptionExtractor] = None,
        device: DeviceLike = None,
    ):
        self.config = config
        self.raw_index = raw_index
        self.definition = tuple(definition)
        self.extractor = extractor or InceptionExtractor(device=device)
        self.device = self.extractor.device
        self.cache = FeatureCache(cache_root) if cache_root else None
        if not self.extractor.pretrained:
            logger.warning(
                "InceptionV3 is RANDOM-INIT (no pretrained weights found): FID/ISC/KID "
                "values are not comparable to torch-fidelity or across machines, and "
                "best-model selection runs on random-projection features. Set "
                "PHENDIFF_INCEPTION_WEIGHTS for reference-parity metrics."
            )
        cfg = config
        if cfg.metrics.kid and cfg.nb_generated_images < cfg.metrics.kid_subset_size:
            logger.warning(
                "KID will be SKIPPED: nb_generated_images=%d < kid_subset_size=%d",
                cfg.nb_generated_images, cfg.metrics.kid_subset_size,
            )
        if cfg.metrics.fid and cfg.nb_generated_images < 500:
            logger.warning("FID over %d samples is high-variance; the reference "
                           "default is 1000 per class.", cfg.nb_generated_images)

    # -- reference features (cached per class) -----------------------------
    def _cache_key(self, class_label: int, class_name: str) -> str:
        """Tied to the reference set's identity (definition and the class's
        file list, or an HF dataset's fingerprint and the class): one shared
        ``.fidelity_cache`` serves runs with other definitions, subsets or
        sources without handing them the wrong features.  An HF adapter's
        ``for_class`` scans the whole dataset, so the key does without it."""
        h = hashlib.md5()
        h.update(repr(self.definition).encode())
        if isinstance(self.raw_index, DatasetIndex):
            for p in self.raw_index.for_class(class_label).paths:
                h.update(p.encode())
        else:
            ds = self.raw_index.dataset
            h.update(str(getattr(ds, "_fingerprint", len(ds))).encode())
            h.update(str(class_label).encode())
        return f"{class_name}_{h.hexdigest()[:10]}"

    def _reference_features(self, class_label: int, class_name: str) -> np.ndarray:
        def compute():
            src = self.raw_index.for_class(class_label)
            if isinstance(src, DatasetIndex):
                stream = ImageFolderLoader(
                    src, LoaderConfig(batch_size=self.config.eval_batch_size,
                                      definition=self.definition, normalize=False),
                ).all_images()
            else:  # HFDatasetAdapter
                stream = src.raw_images(self.config.eval_batch_size, self.definition)
            feats, _ = self.extractor.features_for(
                batch.astype(np.float32) / 255.0 for batch, _ in stream)
            return {"features": feats}

        if self.cache is not None:
            key = self._cache_key(class_label, class_name)
            return self.cache.get_or_compute(key, compute)["features"]
        return compute()["features"]

    # -- generation --------------------------------------------------------
    def _generate_class(self, generate_fn: Callable, class_label: int):
        """generate_fn(labels, generator, num_inference_steps) -> [-1, 1]
        NHWC images on the device, given this process's rows of each batch
        (all of them at world 1) and a ``RowsOf`` generator."""
        cfg = self.config
        feats, logits, first_batch = [], [], None
        bs = cfg.eval_batch_size
        rows = torch.from_numpy(padded_rows(bs, "cycle"))
        for i in range(-(-cfg.nb_generated_images // bs)):
            generator = RowsOf(torch.Generator().manual_seed(
                derive_seed(EVAL_SEED, class_label, i)), bs, rows)
            labels = torch.full((len(rows),), class_label, dtype=torch.int64, device=self.device)
            imgs01 = to_images(generate_fn(labels, generator, cfg.num_inference_steps))
            f, lg = self.extractor(imgs01)
            feats.append(all_gather_rows(f)[:bs].cpu().numpy())
            logits.append(all_gather_rows(lg)[:bs].cpu().numpy())
            if first_batch is None:
                panel = all_gather_rows(imgs01.contiguous())[:min(bs, 50)]
                first_batch = panel.float().cpu().numpy()
        n = cfg.nb_generated_images
        return np.concatenate(feats)[:n], np.concatenate(logits)[:n], first_batch

    # -- full pass ---------------------------------------------------------
    def evaluate(self, generate_fn: Callable, step: int, tracker=None) -> Dict[str, float]:
        """Flat metrics, with ``main_metric_mean`` over the classes."""
        cfg = self.config
        if cfg.unconditional:
            class_items = [(0, "unconditional")]
        else:
            class_items = list(enumerate(self.raw_index.classes))
        all_metrics: Dict[str, float] = {}
        mains: List[float] = []
        for label, name in class_items:
            feats, logits, panel = self._generate_class(generate_fn, label)
            if not is_main():  # rank 0 computes the metrics
                continue
            real = None
            if cfg.metrics.fid or cfg.metrics.kid:
                real = self._reference_features(label, name)
            m = calculate_metrics(feats, real, logits, cfg.metrics)
            all_metrics.update({f"{name}/{k}": v for k, v in m.items()})
            if cfg.main_metric in m:
                mains.append(m[cfg.main_metric])
            if tracker is not None:
                tracker.log_images(f"samples/{name}", panel, step)
        if mains:
            all_metrics["main_metric_mean"] = float(np.mean(mains))
        # 1.0: pinned FID-Inception weights; 0.0: the random-init fallback
        all_metrics["inception_pretrained"] = float(self.extractor.pretrained)
        all_metrics = broadcast_object(all_metrics)
        if tracker is not None:
            tracker.log(all_metrics, step)
        return all_metrics
