"""Img2img class-transfer comparison experiment engine.

Counterpart of ``phendiff_tpu/experiments/comparison.py`` for
``ConditionalDDIMPipeline`` and ``SDImg2ImgPipeline`` folders on one device:

* loads the train (and test) image-folder splits, file names kept for
  output naming, and each named pipeline with ``from_pretrained``, its conv
  and linear layers stored and computed in ``inference_param_dtype``;
* loops methods x pipelines x splits x batches with the binary-class
  assumption ``target = 1 - orig``;
* saves ``output_dir/method/pipe/split/target_class/<stem>_to_<class>.png``,
  a ``_pairs.png`` panel of each split's first batch, and ``timings.json``
  (wall seconds and images/s per method and pipeline);
* debug mode stops after one batch;
* ``compute_metrics``: pooled FID/ISC/KID of all transfers against the
  whole true split, then per target class against that class's images
  (KID skipped when too few samples), ``metrics.json`` and an optional
  flat ``sweep_metric``.  Each image's features are extracted once: the
  per-class sets are rows of the pooled ones, and a split's real features
  serve every method and pipeline.

An SD pipeline's transfer runs in its VAE's latent space: the images are
encoded to their posterior means (times ``scaling_factor``), the method
runs on the latents with the SD denoiser and ``encode_class``'s
sequences, and the result is decoded.  The JAX engine's segmented and
pipeline-parallel SD routes (stages placed on devices) are a later slice: a
config that asks for them (``segmented_sd: true``, ``pipeline_parallel:
true``) raises.

Under data parallelism (``parallel/mesh.py``, one process a card) each
transfer batch is padded to a multiple of the data size by repeating its
last row and split over the ranks, as the JAX engine shards it over its
mesh's data axis; the cfg method's noise is each rank's rows of the whole
batch's draw (``core.rng.RowsOf``), the numbers world 1 draws.  The
outputs are all-gathered and trimmed to the real rows, and rank 0 alone
writes the PNGs, the panels, ``timings.json`` and the metrics (one host
FID pass), which it hands to every rank.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from phendiff_tpu_torch.core.device import DeviceLike, resolve_device
from phendiff_tpu_torch.core.rng import KeyStream, RowsOf
from phendiff_tpu_torch.data.imagefolder import (
    DatasetIndex,
    ImageFolderLoader,
    LoaderConfig,
    load_image,
    scan_imagefolder,
)
from phendiff_tpu_torch.metrics.fidelity import MetricsConfig, calculate_metrics
from phendiff_tpu_torch.metrics.inception import InceptionExtractor
from phendiff_tpu_torch.parallel.mesh import (
    all_gather_rows,
    broadcast_object,
    is_main,
    padded_rows,
)
from phendiff_tpu_torch.pipelines import transfer as T
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.pipelines.io import load_model_index
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline

METHODS = T.TRANSFER_METHODS
logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MethodParams:
    """Per-method knobs (the reference's class_transfer_method config group)."""

    guidance_scale: float = 2.5
    frac_diffusion_skipped: float = 0.5
    guidance_loss_scale: float = 1e-3
    p: float = 2.0
    batch_size: int = 16


@dataclasses.dataclass
class ComparisonConfig:
    output_dir: str = "comparison_out"
    pipelines: Dict[str, str] = dataclasses.field(default_factory=dict)  # name -> folder
    dataset_train: str = ""
    dataset_test: Optional[str] = None
    definition: Tuple[int, int] = (128, 128)
    methods: Tuple[str, ...] = ("ddib",)
    method_params: Dict[str, MethodParams] = dataclasses.field(default_factory=dict)
    num_inference_steps: int = 100
    metrics: MetricsConfig = dataclasses.field(
        default_factory=lambda: MetricsConfig(fid=True, isc=True, kid=True)
    )
    sweep_metric: Optional[str] = None  # "method/pipe/split/metric"
    debug: bool = False
    seed: int = 0
    # Storage and compute dtype of the loaded checkpoints' conv and linear
    # layers: the reference's comparison app runs under half-precision
    # autocast, and the JAX engine's f32 matmuls over bf16 weights run as
    # bf16 passes on the TPU.  None: float32, weights as stored.
    inference_param_dtype: Optional[str] = "bfloat16"
    # The JAX engine's segmented and pipeline-parallel SD routes (SD stages
    # placed on devices): a later slice, so None and False are the only
    # values the port takes.
    segmented_sd: Optional[bool] = None
    pipeline_parallel: bool = False

    @classmethod
    def from_dict(cls, raw: dict) -> "ComparisonConfig":
        """A config from the YAML file's mapping (nested ``method_params``
        and ``metrics``; lists become tuples)."""
        raw = dict(raw)
        mp = {k: MethodParams(**v) for k, v in (raw.pop("method_params", {}) or {}).items()}
        metrics = MetricsConfig(**raw.pop("metrics", {}))
        for key in ("definition", "methods"):
            if isinstance(raw.get(key), list):
                raw[key] = tuple(raw[key])
        return cls(method_params=mp, metrics=metrics, **raw)

    @classmethod
    def from_yaml(cls, path: str) -> "ComparisonConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


def _make_transfer_fn(pipe, method: str, params: MethodParams, steps: int) -> Callable:
    """(images, src_labels, tgt_labels, generator) -> [-1, 1] images.  An SD
    pipeline runs the method on the VAE latents of the images."""
    denoiser, schedule = pipe.denoiser_fn(), pipe.schedule
    is_sd = isinstance(pipe, SDImg2ImgPipeline)
    embed = pipe.encode_class if is_sd else pipe.class_embeddings

    def transfer(x, src_emb, tgt_emb, generator):
        if method == "ddib":
            return T.ddib(denoiser, schedule, x, src_emb, tgt_emb, num_inference_steps=steps)
        if method == "inverted_regeneration":
            return T.inverted_regeneration(denoiser, schedule, x, src_emb,
                                           num_inference_steps=steps)
        if method == "classifier_free_guidance_forward_start":
            return T.cfg_forward_start(
                denoiser, schedule, x, tgt_emb, generator,
                guidance_scale=params.guidance_scale,
                frac_diffusion_skipped=params.frac_diffusion_skipped,
                num_inference_steps=steps,
            )
        if method == "linear_interp_custom_guidance_inverted_start":
            with pipe.frozen():
                return T.guided_inverted_start(
                    denoiser, schedule, x, src_emb, tgt_emb,
                    guidance_loss_scale=params.guidance_loss_scale, p=params.p,
                    num_inference_steps=steps,
                )
        raise ValueError(f"unknown transfer method: {method}")

    def fn(images, src_labels, tgt_labels, generator):
        x = pipe.encode_images(images) if is_sd else images
        out = transfer(x, embed(src_labels), embed(tgt_labels), generator)
        return pipe.decode_latents(out) if is_sd else out

    return fn


def _save_batch(images01: np.ndarray, basenames: List[str], tgt_labels: np.ndarray,
                classes: Tuple[str, ...], out_dir: str) -> None:
    from PIL import Image

    arr = (np.clip(images01, 0, 1) * 255).astype(np.uint8)
    for img, base, tgt in zip(arr, basenames, tgt_labels):
        cls = classes[int(tgt)]
        d = os.path.join(out_dir, cls)
        os.makedirs(d, exist_ok=True)
        stem = os.path.splitext(os.path.basename(base))[0]
        Image.fromarray(img).save(os.path.join(d, f"{stem}_to_{cls}.png"))


class ComparisonExperiment:
    def __init__(self, config: ComparisonConfig, tracker=None, device: DeviceLike = None):
        self.config = config
        self.tracker = tracker
        self.device = resolve_device(device)
        if config.segmented_sd or config.pipeline_parallel:
            raise NotImplementedError(
                "segmented_sd and pipeline_parallel select the JAX engine's stage-per-device SD "
                "routes (written for the TPU's compile transport), not ported to "
                "phendiff_tpu_torch yet (ROADMAP.md Queue 1 item 6, slice 2: the "
                "stage-per-device SD route); set segmented_sd to null or false and "
                "pipeline_parallel to false")
        self.pipes = {name: self._load_pipeline(path) for name, path in config.pipelines.items()}
        self.splits: Dict[str, DatasetIndex] = {"train": scan_imagefolder(config.dataset_train)}
        if config.dataset_test:
            self.splits["test"] = scan_imagefolder(config.dataset_test)
        self.extractor = InceptionExtractor(device=self.device)
        if not self.extractor.pretrained:
            logger.warning("InceptionV3 is RANDOM-INIT: comparison FID/ISC/KID are not "
                           "comparable to torch-fidelity or across machines.")

    def _load_pipeline(self, path: str):
        kind = load_model_index(path).get("_class_name")
        classes = {"ConditionalDDIMPipeline": ConditionalDDIMPipeline,
                   "SDImg2ImgPipeline": SDImg2ImgPipeline}
        if kind not in classes:
            raise ValueError(f"unknown pipeline kind {kind} at {path}")
        name = self.config.inference_param_dtype
        if name is None:
            return classes[kind].from_pretrained(path, device=self.device)
        dtype = getattr(torch, name)
        return classes[kind].from_pretrained(path, dtype=dtype, device=self.device).cast_params(
            dtype)

    # -- transfers ---------------------------------------------------------
    def run_transfers(self) -> None:
        from phendiff_tpu_torch.obs.images import side_by_side

        cfg = self.config
        stream = KeyStream(cfg.seed)
        # per-(method, pipeline) wall seconds and images/s, beside metrics.json
        self.transfer_timings: Dict[str, Dict[str, float]] = {}
        for method in cfg.methods:
            params = cfg.method_params.get(method, MethodParams())
            for pipe_name, pipe in self.pipes.items():
                t_pipe = time.perf_counter()
                n_images = 0
                fn = _make_transfer_fn(pipe, method, params, cfg.num_inference_steps)
                for split_name, index in self.splits.items():
                    out_dir = os.path.join(cfg.output_dir, method, pipe_name, split_name)
                    bs = params.batch_size
                    for start in range(0, len(index), bs):
                        idxs = range(start, min(start + bs, len(index)))
                        images = np.stack([load_image(index.paths[i], cfg.definition)
                                           for i in idxs])
                        src = np.array([index.labels[i] for i in idxs], dtype=np.int64)
                        tgt = 1 - src  # binary-class flip
                        out = self._transfer_rows(fn, images, src, tgt, stream.next())
                        if is_main():
                            _save_batch(out / 2.0 + 0.5, [index.paths[i] for i in idxs], tgt,
                                        index.classes, out_dir)
                            if start == 0:
                                side_by_side(images[:8], out[:8]).save(
                                    os.path.join(out_dir, "_pairs.png"))
                        n_images += len(idxs)
                        if cfg.debug:
                            break
                wall = time.perf_counter() - t_pipe
                self.transfer_timings[f"{method}/{pipe_name}"] = {
                    "wall_s": round(wall, 3),
                    "images": n_images,
                    "images_per_sec": round(n_images / wall, 4) if wall else 0.0,
                }
                logger.info("transfers %s/%s: %.1f s for %d images (%.3f img/s)",
                            method, pipe_name, wall, n_images, n_images / wall if wall else 0.0)
        if is_main():
            with open(os.path.join(cfg.output_dir, "timings.json"), "w") as f:
                json.dump(self.transfer_timings, f, indent=2, sort_keys=True)

    def _transfer_rows(self, fn: Callable, images: np.ndarray, src: np.ndarray,
                       tgt: np.ndarray, generator: torch.Generator) -> np.ndarray:
        """One batch through ``fn``, split over the data group: this rank
        transfers its rows of the batch padded by repeating the last row,
        and every rank gets the whole batch back, f32 on the host."""
        n = len(images)
        rows = padded_rows(n, "repeat_last")
        images, src, tgt = images[rows], src[rows], tgt[rows]
        out = fn(torch.from_numpy(images).to(self.device), torch.from_numpy(src),
                 torch.from_numpy(tgt), RowsOf(generator, n, torch.from_numpy(rows)))
        return all_gather_rows(out.float().contiguous())[:n].cpu().numpy()

    # -- metrics -----------------------------------------------------------
    def _features(self, index: DatasetIndex) -> Tuple[np.ndarray, np.ndarray]:
        loader = ImageFolderLoader(index, LoaderConfig(
            batch_size=32, definition=self.config.definition, normalize=False))
        return self.extractor.features_for(
            b.astype(np.float32) / 255.0 for b, _ in loader.all_images())

    def compute_metrics(self) -> Dict[str, float]:
        """Rank 0 computes the metrics from the PNGs it wrote; every rank
        returns them."""
        results = self._metrics() if is_main() else None
        return broadcast_object(results)

    def _metrics(self) -> Dict[str, float]:
        cfg = self.config
        results: Dict[str, float] = {}
        real: Dict[str, np.ndarray] = {}  # split -> features, extracted once
        for method in cfg.methods:
            for pipe_name in self.pipes:
                for split_name, index in self.splits.items():
                    out_dir = os.path.join(cfg.output_dir, method, pipe_name, split_name)
                    if not os.path.isdir(out_dir):
                        continue
                    if split_name not in real:
                        real[split_name] = self._features(index)[0]
                    real_feats, real_labels = real[split_name], np.array(index.labels)
                    fake_idx = scan_imagefolder(out_dir)
                    fake_feats, fake_logits = self._features(fake_idx)
                    fake_labels = np.array(fake_idx.labels)
                    prefix = f"{method}/{pipe_name}/{split_name}"
                    pooled = calculate_metrics(fake_feats, real_feats, fake_logits, cfg.metrics)
                    results.update({f"{prefix}/{k}": v for k, v in pooled.items()})
                    # per target class, against that class's true images
                    per_class = dataclasses.replace(cfg.metrics, isc=False)
                    for label, cname in enumerate(index.classes):
                        if cname not in fake_idx.classes:
                            continue
                        ff = fake_feats[fake_labels == fake_idx.classes.index(cname)]
                        m = calculate_metrics(ff, real_feats[real_labels == label], None,
                                              per_class)
                        results.update({f"{prefix}/{cname}/{k}": v for k, v in m.items()})
        if cfg.sweep_metric and cfg.sweep_metric in results:
            results["sweep_metric"] = results[cfg.sweep_metric]
        with open(os.path.join(cfg.output_dir, "metrics.json"), "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
        if self.tracker is not None:
            self.tracker.log(results, 0)
        return results

    def run(self) -> Dict[str, float]:
        self.run_transfers()
        return self.compute_metrics()
