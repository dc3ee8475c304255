"""SDImg2ImgPipeline: SD-2.1's UNet and VAE with a class embedding in place
of the text encoder.

Counterpart of ``phendiff_tpu/pipelines/sd_img2img.py``:

* components: the VAE (frozen), the SD UNet, the DDIM schedule and the
  custom class embedding;
* ``encode_class``: int labels -> embedding rows -> (B, 77, D) sequences,
  the row in slot 0 and zeros elsewhere; classifier-free guidance uses a
  zeros sequence as the unconditional branch, and cond + uncond run as one
  batched UNet pass;
* ``prepare_latents``: no image -> pure noise at the latent shape; a
  4-channel input passes through as latents; a 3-channel image is
  VAE-encoded (its posterior sampled) times ``scaling_factor``, optionally
  forward-noised by the sampler;
* ``strength`` truncates the schedule by count;
* output: latents, decoded images, or both.

The denoise loop is the port's ``conditional_ddim.ddim_sample`` /
``ddim_invert``; the conditioning sequence is opaque to it.  Folders use
the JAX package's layout (``model_index.json``; ``unet/``, ``vae/``,
``class_embedding/`` with ``config.json`` and ``params.safetensors`` of the
flattened Flax tree; ``scheduler/config.json``), read and written by
``models/convert.py``.  Randomness comes from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
from typing import Mapping, Optional

import torch

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.core.device import DeviceLike, device_of, resolve_device
from phendiff_tpu_torch.core.precision import cast_matmul_weights
from phendiff_tpu_torch.core.rng import derive_seed
from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
from phendiff_tpu_torch.models.convert import from_flax_params, to_flax_params
from phendiff_tpu_torch.models.embeddings import ClassEmbedding, pad_to_clip_sequence
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig
from phendiff_tpu_torch.models.unet2d import init_flax_weights
from phendiff_tpu_torch.pipelines import conditional_ddim as sampler
from phendiff_tpu_torch.pipelines import io
from phendiff_tpu_torch.pipelines.latent_vae import VAELatents, build_on

CLIP_SEQ_LEN = 77


@dataclasses.dataclass
class SDImg2ImgPipeline(VAELatents):
    unet_config: SDUNetConfig
    vae_config: AutoencoderKLConfig
    scheduler_config: S.SchedulerConfig
    unet: SDUNet  # its ``dtype`` is the compute dtype of the UNet
    vae: AutoencoderKL
    class_embedding: ClassEmbedding

    def __post_init__(self):
        self._schedule = S.make_schedule(self.scheduler_config, device=self.device)

    # -- construction -----------------------------------------------------
    @classmethod
    def init_random(
        cls,
        unet_config: SDUNetConfig,
        vae_config: AutoencoderKLConfig,
        scheduler_config: S.SchedulerConfig,
        num_classes: int = 2,
        class_embedding_dim: int = 1024,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ) -> "SDImg2ImgPipeline":
        """Random weights (Flax's initialisers), each component from its own
        generator seeded from ``seed``, drawn on the device; on the card
        unless ``device`` says otherwise."""
        dev = resolve_device(device)
        gens = [torch.Generator(device=dev).manual_seed(derive_seed(seed, i)) for i in range(3)]
        unet = build_on(lambda: SDUNet(unet_config, dtype=dtype), dev).init_weights(gens[0])
        vae = build_on(lambda: AutoencoderKL(vae_config, dtype=dtype), dev).init_weights(gens[1])
        ce = init_flax_weights(
            build_on(lambda: ClassEmbedding(num_classes, class_embedding_dim), dev), gens[2])
        return cls(unet_config, vae_config, scheduler_config, unet, vae, ce)

    @classmethod
    def from_pretrained(cls, dirpath: str, dtype: torch.dtype = torch.float32,
                        device: DeviceLike = None) -> "SDImg2ImgPipeline":
        """Load a folder saved by either package; weights load as float32,
        ``dtype`` is the compute dtype."""
        dev = resolve_device(device)
        index = io.load_model_index(dirpath)
        if index.get("_class_name") != "SDImg2ImgPipeline":
            raise ValueError(f"not an SDImg2ImgPipeline folder: {dirpath}")
        parts = {}
        for name in ("unet", "vae", "class_embedding"):
            raw, flat = io.load_component(os.path.join(dirpath, name))
            if flat is None:
                raise ValueError(f"no {name} weights in {dirpath}")
            parts[name] = raw, flat
        sched_raw, _ = io.load_component(os.path.join(dirpath, "scheduler"))
        unet_config = SDUNetConfig.from_json(parts["unet"][0])
        vae_config = AutoencoderKLConfig.from_json(parts["vae"][0])
        ce_raw = parts["class_embedding"][0]

        def load(module_fn, name):
            module = build_on(module_fn, dev)
            module.load_state_dict(from_flax_params(parts[name][1], module))
            return module

        return cls(
            unet_config, vae_config, S.SchedulerConfig.from_json(sched_raw),
            load(lambda: SDUNet(unet_config, dtype=dtype), "unet"),
            load(lambda: AutoencoderKL(vae_config, dtype=dtype), "vae"),
            load(lambda: ClassEmbedding(ce_raw["num_classes"], ce_raw["embedding_dim"]),
                 "class_embedding"),
        )

    def save_pretrained(self, dirpath: str) -> None:
        io.save_model_index(dirpath, "SDImg2ImgPipeline", {
            "unet": "unet", "vae": "vae", "scheduler": "scheduler",
            "class_embedding": "class_embedding"})
        io.save_component(os.path.join(dirpath, "unet"), self.unet_config.to_json_dict(),
                          to_flax_params(self.unet.state_dict()))
        io.save_component(os.path.join(dirpath, "vae"), self.vae_config.to_json_dict(),
                          to_flax_params(self.vae.state_dict()))
        io.save_component(os.path.join(dirpath, "scheduler"),
                          self.scheduler_config.to_json_dict())
        io.save_component(
            os.path.join(dirpath, "class_embedding"),
            {"_class_name": "CustomEmbedding", "num_classes": self.num_classes,
             "embedding_dim": self.class_embedding_dim},
            to_flax_params(self.class_embedding.state_dict()))

    def replace_params(
        self,
        unet_params: Optional[Mapping[str, torch.Tensor]] = None,
        class_embedding_params: Optional[Mapping[str, torch.Tensor]] = None,
        vae_params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> "SDImg2ImgPipeline":
        """A pipeline whose components given here load these state dicts
        (copies; this pipeline is unchanged)."""
        def swap(module, params):
            if params is None:
                return module
            module = copy.deepcopy(module)
            module.load_state_dict(params)
            return module

        return dataclasses.replace(
            self, unet=swap(self.unet, unet_params), vae=swap(self.vae, vae_params),
            class_embedding=swap(self.class_embedding, class_embedding_params))

    def cast_params(self, dtype: torch.dtype = torch.bfloat16) -> "SDImg2ImgPipeline":
        """A pipeline whose UNet and VAE conv and linear weights are stored
        in ``dtype``, for inference; GroupNorm and LayerNorm params and the
        class table stay float32."""
        return dataclasses.replace(
            self, unet=cast_matmul_weights(copy.deepcopy(self.unet), dtype),
            vae=cast_matmul_weights(copy.deepcopy(self.vae), dtype))

    # -- checkpoint-as-data ---------------------------------------------------
    @property
    def params_tree(self) -> dict:
        """Every served tensor, by component: the state dicts of the UNet,
        the VAE and the class embedding, sharing storage with the modules."""
        return {"unet": dict(self.unet.state_dict()), "vae": dict(self.vae.state_dict()),
                "class_embedding": dict(self.class_embedding.state_dict())}

    def arch_fingerprint(self) -> str:
        """Architecture identity (configs and compute dtype, not weights):
        pipelines with equal fingerprints can be served by one engine's
        captured programs."""
        return json.dumps({
            "kind": "SDImg2ImgPipeline",
            "unet": self.unet_config.to_json_dict(),
            "vae": self.vae_config.to_json_dict(),
            "scheduler": self.scheduler_config.to_json_dict(),
            "num_classes": self.num_classes,
            "class_embedding_dim": self.class_embedding_dim,
            "dtype": str(self.dtype),
        }, sort_keys=True)

    # -- components ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return device_of(self.unet)

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.dtype

    @property
    def schedule(self) -> S.NoiseSchedule:
        return self._schedule

    @property
    def num_classes(self) -> int:
        return self.class_embedding.embedding.num_embeddings

    @property
    def class_embedding_dim(self) -> int:
        return self.class_embedding.embedding.embedding_dim

    def encode_class(self, class_labels: torch.Tensor) -> torch.Tensor:
        """labels -> (B, 77, D) conditioning sequences (no gradient)."""
        with torch.no_grad():
            emb = self.class_embedding(torch.as_tensor(class_labels, device=self.device))
        return pad_to_clip_sequence(emb, CLIP_SEQ_LEN)

    def denoiser_fn(self) -> sampler.DenoiserFn:
        """The UNet as a denoiser over (latents, t, class sequence).  It
        records no autograd graph unless its input requires a gradient (the
        guided transfer's step)."""
        unet = self.unet

        def fn(x, t, class_seq):
            with torch.set_grad_enabled(torch.is_grad_enabled() and x.requires_grad):
                return unet(x, t, class_seq)

        return fn

    @contextlib.contextmanager
    def frozen(self):
        """Every component's parameters frozen inside the block and restored
        after, so autograd through the denoiser forms input gradients only."""
        modules = (self.unet, self.vae, self.class_embedding)
        flags = [(p, p.requires_grad) for m in modules for p in m.parameters()]
        for p, _ in flags:
            p.requires_grad_(False)
        try:
            yield self
        finally:
            for p, flag in flags:
                p.requires_grad_(flag)

    # -- latent plumbing -----------------------------------------------------
    def prepare_latents(self, image: Optional[torch.Tensor], batch_size: int,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
        res, c = self.unet_config.sample_size, self.unet_config.in_channels
        if image is None:
            if generator is None:
                raise ValueError("a pure-noise start needs a generator")
            return sampler._randn((batch_size, res, res, c), generator, self.device)
        if image.shape[-1] == c:
            return image  # already latents
        return self.encode_images(image, generator)

    # -- sampling ------------------------------------------------------------
    def generate(
        self,
        class_labels: torch.Tensor,
        generator: Optional[torch.Generator],
        *,
        image: Optional[torch.Tensor] = None,
        latents: Optional[torch.Tensor] = None,
        strength: Optional[float] = None,
        add_forward_noise: bool = False,
        num_inference_steps: int = sampler.DEFAULT_NUM_INFERENCE_STEPS,
        guidance_scale: float = 0.0,
        guidance_equation: str = "imagen",
        eta: float = 0.0,
        output_type: str = "image",  # "image" | "latent" | "image+latent"
    ):
        """Sample latents from noise (or from ``image`` / ``latents``) under
        the given classes; returns float32 images in [-1, 1], latents, or
        both.  Every draw (start noise, posterior sample, forward noise, eta
        noise) comes from ``generator``, in that order."""
        if output_type not in ("image", "latent", "image+latent"):
            raise ValueError(f"unknown output_type: {output_type}")
        b = len(class_labels)
        start = latents if latents is not None else self.prepare_latents(image, b, generator)
        out = sampler.ddim_sample(
            self.denoiser_fn(), self._schedule, self.encode_class(class_labels),
            start_image=start, generator=generator, add_forward_noise=add_forward_noise,
            num_inference_steps=num_inference_steps, strength=strength,
            guidance=sampler.GuidanceConfig(guidance_scale, guidance_equation), eta=eta,
        )
        if output_type == "latent":
            return out
        images = self.decode_latents(out).float()
        return (images, out) if output_type == "image+latent" else images

    def invert(self, image_or_latents: torch.Tensor, class_labels: torch.Tensor, *,
               num_inference_steps: int = sampler.DEFAULT_NUM_INFERENCE_STEPS) -> torch.Tensor:
        """Deterministic DDIM inversion in latent space (an image is encoded
        to its posterior mean first)."""
        x = image_or_latents
        if x.shape[-1] != self.unet_config.in_channels:
            x = self.encode_images(x)
        return sampler.ddim_invert(self.denoiser_fn(), self._schedule, x,
                                   self.encode_class(class_labels),
                                   num_inference_steps=num_inference_steps)
