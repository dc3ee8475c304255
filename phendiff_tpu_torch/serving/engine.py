"""Batched inference engine for deployment.

Counterpart of ``phendiff_tpu/serving/engine.py``: load a pipeline once,
prepare one fixed-shape program per op a service needs (class-conditional
generation, DDIB class transfer, inversion) at ``max_batch`` during
``warmup()``, and serve requests of any size up to that by zero-padding
and slicing.  The public API takes and returns numpy.

On the card the counterpart of the JAX engine's program compiled ahead is
a CUDA graph captured per op at ``max_batch``:

* each op reads static input buffers (images, source and target labels,
  start noise) and writes one static output; a request copies its padded
  inputs into the buffers, replays the graph and slices the output;
* before its capture an op runs once eagerly on the capture's side stream,
  so cuDNN and cuBLAS pick their kernels and the kernel libraries set
  their attributes outside the capture;
* the graphs share one memory pool: ops never run at once, and a request
  copies its output to the host before the next replay;
* ``generate`` draws its start noise outside the graph, [max_batch, ...]
  from ``torch.Generator(device).manual_seed(seed)``, so a request's rows
  do not depend on its padding rows;
* ``swap_params`` copies a same-architecture checkpoint in place into the
  tensors the graphs read (the served pipeline's own modules): no
  recapture;
* a replay runs none of the kernel wrappers' Python, so their launch
  counters do not move: each op keeps the launches its capture made
  (``stats()["launches_per_replay"]``), and a path's launches are those
  times its replays.

A capture that fails raises, and a CUDA pipeline is never served eagerly.
On a pipeline the caller put on the CPU, ``warmup()`` captures nothing and
each request runs the same op function eagerly.  Like the JAX engine, it
serves on one device: that engine makes a mesh and imports ``shard_batch``
but compiles every op without a sharding and never places a request on
the mesh (``phendiff_tpu/serving/engine.py:33,52``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from phendiff_tpu_torch.obs.profiling import annotate, force_sync
from phendiff_tpu_torch.ops.flash_attention import flash_attention
from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm
from phendiff_tpu_torch.pipelines import conditional_ddim as sampler
from phendiff_tpu_torch.pipelines import transfer as T
from phendiff_tpu_torch.pipelines.conditional_ddim import to_images
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 32
    num_inference_steps: int = 50
    guidance_factor: float = 0.0
    ops: tuple = ("generate", "transfer", "invert")


def _kernel_launches() -> Dict[str, int]:
    """The forward kernel wrappers' launch counters (serving runs no
    backward)."""
    return {"flash_attn_fwd": flash_attention.launches,
            "group_norm_silu": fused_group_norm.launches,
            "group_norm_silu_stream": fused_group_norm.stream_launches}


@dataclasses.dataclass
class _Op:
    run: Callable[..., torch.Tensor]  # the op body over ``inputs``
    inputs: Dict[str, torch.Tensor]  # static buffers at max_batch
    graph: Optional[torch.cuda.CUDAGraph] = None
    output: Optional[torch.Tensor] = None  # the graph's static output
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    replays: int = 0


def _flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


class InferenceEngine:
    def __init__(self, pipeline, config: EngineConfig = EngineConfig()):
        if not isinstance(pipeline, (ConditionalDDIMPipeline, SDImg2ImgPipeline)):
            raise TypeError(f"unsupported pipeline type {type(pipeline)}")
        self.pipe = pipeline
        self.config = config
        self.is_sd = isinstance(pipeline, SDImg2ImgPipeline)
        self.device = pipeline.device
        self._ops: Dict[str, _Op] = {}
        self._pool = None
        self._stats = {"requests": 0, "images": 0, "total_s": 0.0, "captures": 0, "swaps": 0}

    def swap_params(self, pipeline) -> None:
        """Serve ``pipeline``'s checkpoint (same architecture) from now on:
        its tensors are copied in place into the served pipeline's (which
        the captured graphs read), so no op is captured again.  The
        pipeline given to the constructor is overwritten."""
        if pipeline.arch_fingerprint() != self.pipe.arch_fingerprint():
            raise ValueError(
                "swap_params requires an identical architecture (arch_fingerprint mismatch)")
        served, new = _flatten(self.pipe.params_tree), _flatten(pipeline.params_tree)
        with torch.no_grad():
            for name, t in served.items():
                t.copy_(new[name])
        self._stats["swaps"] += 1

    # -- shapes ------------------------------------------------------------
    @property
    def image_shape(self):
        if self.is_sd:
            res = self.pipe.unet_config.sample_size * 8  # VAE downscale
            return (res, res, 3)
        res = self.pipe.unet_config.sample_size
        return (res, res, self.pipe.unet_config.in_channels)

    @property
    def _noise_shape(self):
        c = self.pipe.unet_config
        return (self.config.max_batch, c.sample_size, c.sample_size, c.in_channels)

    @property
    def _num_classes(self) -> int:
        return self.pipe.num_classes or 0

    def _pad(self, arr: np.ndarray, item_shape: tuple = ()) -> np.ndarray:
        b = arr.shape[0]
        if b > self.config.max_batch:
            raise ValueError(f"batch {b} exceeds max_batch {self.config.max_batch}")
        if tuple(arr.shape[1:]) != tuple(item_shape):
            raise ValueError(f"expected items of shape {item_shape}, got {arr.shape[1:]}")
        pad = np.zeros((self.config.max_batch - b,) + arr.shape[1:], dtype=arr.dtype)
        return np.concatenate([arr, pad])

    def _labels(self, labels) -> np.ndarray:
        """Padded int64 labels, each a class of the pipeline (an index
        outside the table would fault inside a captured graph)."""
        labels = np.asarray(labels, np.int64)
        if labels.size and (labels.min() < 0 or labels.max() >= self._num_classes):
            raise ValueError(f"class labels must lie in [0, {self._num_classes})")
        return self._pad(labels)

    def _images(self, images01) -> np.ndarray:
        """[k, H, W, C] images in [0, 1] -> padded [-1, 1] float32."""
        return self._pad(np.asarray(images01, np.float32) * 2.0 - 1.0, self.image_shape)

    def start_noise(self, seed: int) -> torch.Tensor:
        """The [max_batch, ...] float32 start noise ``generate`` uses for
        ``seed``: the draw of ``torch.Generator(device).manual_seed(seed)``
        that the pipeline's own ``generate`` makes at ``max_batch``."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return sampler._randn(self._noise_shape, g, self.device)

    # -- op bodies -----------------------------------------------------------
    def _body(self, op: str) -> Callable[..., torch.Tensor]:
        pipe, cfg = self.pipe, self.config
        n = cfg.num_inference_steps
        if self.is_sd:
            def generate(labels, noise):
                return pipe.generate(labels, None, latents=noise, num_inference_steps=n,
                                     guidance_scale=cfg.guidance_factor)

            def transfer(images, src, tgt):
                x = pipe.encode_images(images)
                out = T.ddib(pipe.denoiser_fn(), pipe.schedule, x, pipe.encode_class(src),
                             pipe.encode_class(tgt), num_inference_steps=n)
                return pipe.decode_latents(out).float()
        else:
            def generate(labels, noise):
                return pipe.generate(labels, None, start_image=noise, num_inference_steps=n,
                                     guidance_factor=cfg.guidance_factor)

            def transfer(images, src, tgt):
                return T.ddib(pipe.denoiser_fn(), pipe.schedule, images,
                              pipe.class_embeddings(src), pipe.class_embeddings(tgt),
                              num_inference_steps=n)

        def invert(images, labels):
            return pipe.invert(images, labels, num_inference_steps=n)

        return {"generate": generate, "transfer": transfer, "invert": invert}[op]

    def _buffers(self, op: str) -> Dict[str, torch.Tensor]:
        b, dev = self.config.max_batch, self.device

        def labels():
            return torch.zeros(b, dtype=torch.int64, device=dev)

        def images():
            return torch.zeros((b,) + self.image_shape, dtype=torch.float32, device=dev)

        if op == "generate":
            return {"labels": labels(),
                    "noise": torch.zeros(self._noise_shape, dtype=torch.float32, device=dev)}
        if op == "transfer":
            return {"images": images(), "src": labels(), "tgt": labels()}
        return {"images": images(), "labels": labels()}

    # -- lifecycle ---------------------------------------------------------
    def _capture(self, o: _Op) -> None:
        """Run ``o`` once eagerly on a side stream, then capture it into
        one CUDA graph in the engine's pool."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            o.run(**o.inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _kernel_launches()
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            out = o.run(**o.inputs)
        o.launches = {k: v - before[k] for k, v in _kernel_launches().items()}
        o.graph, o.output = graph, out
        self._stats["captures"] += 1

    def warmup(self) -> Dict[str, float]:
        """Prepare every configured op (on the card: capture its graph);
        returns seconds per op."""
        times = {}
        for op in self.config.ops:
            t0 = time.perf_counter()
            o = _Op(self._body(op), self._buffers(op))
            if self.device.type == "cuda":
                self._capture(o)
            self._ops[op] = o
            times[op] = time.perf_counter() - t0
        return times

    def _get(self, op: str) -> _Op:
        if op not in self._ops:
            raise RuntimeError(f"op '{op}' not warmed up (ops={self.config.ops})")
        return self._ops[op]

    def _serve(self, op: str, **inputs) -> torch.Tensor:
        """Copy the padded inputs into the op's buffers and run it: a
        replay of its graph, or its body on the CPU."""
        o = self._get(op)
        with annotate(f"engine/{op}"):
            for name, value in inputs.items():
                o.inputs[name].copy_(torch.as_tensor(value))
            if o.graph is None:
                out = o.run(**o.inputs)
            else:
                o.graph.replay()
                out = o.output
            force_sync(out)
        o.replays += 1
        return out

    # -- public API --------------------------------------------------------
    def generate(self, class_labels: np.ndarray, seed: int = 0) -> np.ndarray:
        """labels [k] -> images [k, H, W, C] in [0, 1]."""
        k = len(class_labels)
        labels = self._labels(class_labels)
        t0 = time.perf_counter()
        out = self._serve("generate", labels=labels, noise=self.start_noise(seed))
        out = to_images(out[:k]).cpu().numpy()
        self._account(k, t0)
        return out

    def transfer(
        self,
        images01: np.ndarray,  # [k, H, W, C] in [0, 1]
        source_labels: np.ndarray,
        target_labels: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """DDIB class transfer; the target defaults to the binary flip."""
        k = len(images01)
        src = np.asarray(source_labels, np.int64)
        tgt = np.asarray(target_labels, np.int64) if target_labels is not None else 1 - src
        x = self._images(images01)
        src, tgt = self._labels(src), self._labels(tgt)
        t0 = time.perf_counter()
        out = self._serve("transfer", images=x, src=src, tgt=tgt)
        out = to_images(out[:k]).cpu().numpy()
        self._account(k, t0)
        return out

    def invert(self, images01: np.ndarray, labels: np.ndarray) -> np.ndarray:
        """Images in [0, 1] -> their DDIM-inverted latents (raw, float32)."""
        k = len(images01)
        x, labels = self._images(images01), self._labels(labels)
        t0 = time.perf_counter()
        out = self._serve("invert", images=x, labels=labels)
        out = out[:k].float().cpu().numpy()
        self._account(k, t0)
        return out

    def _account(self, k: int, t0: float):
        self._stats["requests"] += 1
        self._stats["images"] += k
        self._stats["total_s"] += time.perf_counter() - t0

    def stats(self) -> Dict[str, object]:
        """Requests, images and seconds served; captures and swaps; per
        warmed op its replays (or eager runs on the CPU) and the kernel
        launches its capture made."""
        s: Dict[str, object] = dict(self._stats)
        if s["total_s"] > 0:
            s["images_per_sec"] = s["images"] / s["total_s"]
        s["replays"] = {op: o.replays for op, o in self._ops.items()}
        s["launches_per_replay"] = {op: dict(o.launches) for op, o in self._ops.items()}
        return s
