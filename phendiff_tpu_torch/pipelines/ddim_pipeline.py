"""ConditionalDDIMPipeline: the conditional UNet plus a DDIM schedule, with
folder save/load.

Counterpart of ``phendiff_tpu/pipelines/ddim_pipeline.py``.  It reads the
folders the JAX package saves (``model_index.json``; ``unet/config.json``
and ``unet/params.safetensors`` of the flattened Flax tree;
``scheduler/config.json``) and writes the same layout.  The pipeline owns
an ``nn.Module`` on one device; sampling runs the host loops of
``conditional_ddim.py``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Optional, Union

import torch

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.core.device import DeviceLike, device_of, resolve_device
from phendiff_tpu_torch.core.precision import cast_matmul_weights
from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.convert import from_flax_params, to_flax_params
from phendiff_tpu_torch.models.unet2d import CondUNet2D
from phendiff_tpu_torch.pipelines import conditional_ddim as sampler
from phendiff_tpu_torch.pipelines import io


@dataclasses.dataclass
class ConditionalDDIMPipeline:
    unet_config: UNet2DConfig
    scheduler_config: S.SchedulerConfig
    model: CondUNet2D  # holds the weights; its ``dtype`` is the compute dtype

    def __post_init__(self):
        self._schedule = S.make_schedule(self.scheduler_config, device=self.device)

    # -- construction -----------------------------------------------------
    @classmethod
    def init_random(
        cls,
        unet_config: UNet2DConfig,
        scheduler_config: S.SchedulerConfig,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ) -> "ConditionalDDIMPipeline":
        """Random weights drawn from ``seed`` (Flax's initialisers), on the
        card unless ``device`` says otherwise."""
        dev = resolve_device(device)
        model = CondUNet2D(unet_config, dtype=dtype)
        model.init_weights(torch.Generator().manual_seed(seed))
        return cls(unet_config, scheduler_config, model.to(dev))

    @classmethod
    def from_pretrained(
        cls, dirpath: str, dtype: torch.dtype = torch.float32, device: DeviceLike = None
    ) -> "ConditionalDDIMPipeline":
        """Load a folder saved by either package; weights load as float32."""
        dev = resolve_device(device)
        index = io.load_model_index(dirpath)
        if index.get("_class_name") != "ConditionalDDIMPipeline":
            raise ValueError(f"not a ConditionalDDIMPipeline folder: {dirpath}")
        unet_raw, flat = io.load_component(os.path.join(dirpath, "unet"))
        sched_raw, _ = io.load_component(os.path.join(dirpath, "scheduler"))
        if flat is None:
            raise ValueError(f"no unet weights in {dirpath}")
        unet_config = UNet2DConfig.from_json(unet_raw)
        model = CondUNet2D(unet_config, dtype=dtype)
        model.load_state_dict(from_flax_params(flat, unet_config))
        return cls(unet_config, S.SchedulerConfig.from_json(sched_raw), model.to(dev))

    def save_pretrained(self, dirpath: str) -> None:
        io.save_model_index(
            dirpath, "ConditionalDDIMPipeline", {"unet": "unet", "scheduler": "scheduler"}
        )
        io.save_component(
            os.path.join(dirpath, "unet"), self.unet_config.to_json_dict(),
            to_flax_params(self.model.state_dict()),
        )
        io.save_component(
            os.path.join(dirpath, "scheduler"), self.scheduler_config.to_json_dict()
        )

    # -- component access --------------------------------------------------
    @property
    def device(self) -> torch.device:
        return device_of(self.model)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    @property
    def schedule(self) -> S.NoiseSchedule:
        return self._schedule

    @property
    def num_classes(self) -> Optional[int]:
        return self.unet_config.num_class_embeds

    def class_embeddings(self, class_labels: torch.Tensor) -> torch.Tensor:
        """Rows of the internal class-embedding table for the given labels."""
        if self.model.class_embedding is None:
            raise ValueError("model is unconditional: no class embedding table")
        table = self.model.class_embedding.weight.detach()
        return table[torch.as_tensor(class_labels, device=table.device)]

    def denoiser_fn(self) -> sampler.DenoiserFn:
        """The model as a denoiser.  It records no autograd graph unless
        its input requires a gradient (the guided transfer's step)."""
        model = self.model

        def fn(x, t, class_emb):
            with torch.set_grad_enabled(torch.is_grad_enabled() and x.requires_grad):
                return model(x, t, class_emb=class_emb)

        return fn

    @contextlib.contextmanager
    def frozen(self):
        """The model's parameters frozen inside the block and restored
        after, so autograd through the denoiser forms input gradients only."""
        flags = [(p, p.requires_grad) for p in self.model.parameters()]
        for p, _ in flags:
            p.requires_grad_(False)
        try:
            yield self
        finally:
            for p, flag in flags:
                p.requires_grad_(flag)

    def cast_params(self, dtype: torch.dtype = torch.bfloat16) -> "ConditionalDDIMPipeline":
        """A pipeline whose conv and linear weights are stored in ``dtype``,
        for inference; GroupNorm params and the class table stay float32."""
        model = cast_matmul_weights(copy.deepcopy(self.model), dtype)
        return dataclasses.replace(self, model=model)

    # -- sampling ----------------------------------------------------------
    def generate(
        self,
        class_labels: Optional[torch.Tensor],
        generator: torch.Generator,
        *,
        num_inference_steps: int = sampler.DEFAULT_NUM_INFERENCE_STEPS,
        guidance_factor: Union[float, torch.Tensor] = 0.0,
        guidance_equation: str = "imagen",
        eta: float = 0.0,
        start_image: Optional[torch.Tensor] = None,
        add_forward_noise: bool = False,
        frac_diffusion_skipped: float = 0.0,
        batch_size: Optional[int] = None,
        unconditional: bool = False,
    ) -> torch.Tensor:
        """Sample images; returns [-1, 1] NHWC float32.  ``unconditional``
        (or ``class_labels=None``) samples with a zeros class embedding."""
        if class_labels is None:
            unconditional = True
        if unconditional:
            b = batch_size or (len(class_labels) if class_labels is not None else 1)
            class_emb = torch.zeros((b, self.unet_config.time_embed_dim), device=self.device)
        else:
            b = len(class_labels)
            class_emb = self.class_embeddings(class_labels)
        res = self.unet_config.sample_size
        return sampler.ddim_sample(
            self.denoiser_fn(), self._schedule, class_emb,
            shape=(b, res, res, self.unet_config.in_channels),
            generator=generator,
            start_image=start_image,
            add_forward_noise=add_forward_noise,
            num_inference_steps=num_inference_steps,
            frac_diffusion_skipped=frac_diffusion_skipped,
            guidance=sampler.GuidanceConfig(guidance_factor, guidance_equation),
            eta=eta,
        )

    def invert(
        self,
        image: torch.Tensor,
        class_labels: torch.Tensor,
        *,
        num_inference_steps: int = sampler.DEFAULT_NUM_INFERENCE_STEPS,
    ) -> torch.Tensor:
        return sampler.ddim_invert(
            self.denoiser_fn(), self._schedule, image, self.class_embeddings(class_labels),
            num_inference_steps=num_inference_steps,
        )
