"""Model/pipeline factory: dispatch on (model_type x pretrained-or-config).

Counterpart of ``phendiff_tpu/cli/factory.py``:

* DDIM from a pretrained pipeline folder, or from JSON denoiser/scheduler
  configs;
* StableDiffusion from a pretrained folder;
* DiT from a pretrained ``DiTImg2ImgPipeline`` folder (its patch grid fixes
  the definition: 8 x ``input_size`` px);
* noise-scheduler config precedence: command-line values >
  ``noise_scheduler_config_path`` JSON > the pretrained config;
* ``sample_size`` set from the requested definition (divided by the VAE's
  8x downsampling for StableDiffusion);
* ``--learn_denoiser_from_scratch`` keeps the pretrained scheduler (and the
  SD family's VAE and class embedding) and draws new denoiser weights from
  ``--seed``, from the pretrained denoiser's config or an explicit one.

Pipelines are built on ``device`` (the card unless it names another).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from phendiff_tpu_torch.core.device import DeviceLike, resolve_device
from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.pipelines.dit_img2img import DiTImg2ImgPipeline
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline

SCHEDULER_CL_OVERRIDES = (
    "prediction_type",
    "num_train_timesteps",
    "beta_start",
    "beta_end",
    "beta_schedule",
)


def override_scheduler_config(
    base: SchedulerConfig, args=None, config_path: Optional[str] = None
) -> SchedulerConfig:
    """The reference's precedence: command-line values > JSON file > base."""
    cfg = base
    if config_path:
        cfg = SchedulerConfig.from_json(config_path)
    if args is not None:
        overrides = {
            k: getattr(args, k)
            for k in SCHEDULER_CL_OVERRIDES
            if getattr(args, k, None) is not None
        }
        if overrides:
            cfg = cfg.replace(**overrides)
    return cfg


def load_initial_pipeline(args, dtype: torch.dtype = torch.float32, device: DeviceLike = None):
    """Build the starting pipeline from parsed CLI args."""
    dev = resolve_device(device)
    definition = args.definition[0]
    from_scratch = getattr(args, "learn_denoiser_from_scratch", False)
    if args.model_type == "DDIM":
        if args.pretrained_model_name_or_path:
            pipe = ConditionalDDIMPipeline.from_pretrained(
                args.pretrained_model_name_or_path, dtype=dtype, device=dev)
            unet_cfg = pipe.unet_config.replace(sample_size=definition)
            sched_cfg = override_scheduler_config(
                pipe.scheduler_config, args, args.noise_scheduler_config_path)
            if from_scratch:
                if args.denoiser_config_path:
                    unet_cfg = UNet2DConfig.from_json(
                        args.denoiser_config_path).replace(sample_size=definition)
                return ConditionalDDIMPipeline.init_random(
                    unet_cfg, sched_cfg, seed=args.seed, dtype=dtype, device=dev)
            return ConditionalDDIMPipeline(unet_cfg, sched_cfg, pipe.model)
        unet_cfg = UNet2DConfig.from_json(args.denoiser_config_path).replace(
            sample_size=definition)
        sched_cfg = override_scheduler_config(
            SchedulerConfig(), args, args.noise_scheduler_config_path)
        return ConditionalDDIMPipeline.init_random(
            unet_cfg, sched_cfg, seed=args.seed, dtype=dtype, device=dev)

    if args.model_type == "StableDiffusion":
        pipe = SDImg2ImgPipeline.from_pretrained(
            args.pretrained_model_name_or_path, dtype=dtype, device=dev)
        # latent-space sample size = pixel definition / the VAE's 8x downsampling
        unet_cfg = pipe.unet_config.replace(sample_size=definition // 8)
        sched_cfg = override_scheduler_config(
            pipe.scheduler_config, args, args.noise_scheduler_config_path)
        unet = pipe.unet
        if from_scratch:
            if args.denoiser_config_path:
                unet_cfg = SDUNetConfig.from_json(
                    args.denoiser_config_path).replace(sample_size=definition // 8)
            with torch.device("meta"):
                unet = SDUNet(unet_cfg, dtype=dtype)
            unet = unet.to_empty(device=dev).init_weights(
                torch.Generator(device=dev).manual_seed(args.seed))
        return dataclasses.replace(pipe, unet_config=unet_cfg, scheduler_config=sched_cfg,
                                   unet=unet)
    if args.model_type == "DiT":
        pipe = DiTImg2ImgPipeline.from_pretrained(
            args.pretrained_model_name_or_path, dtype=dtype, device=dev)
        dit_cfg = pipe.dit_config
        if dit_cfg.input_size != definition // 8:
            raise ValueError(f"a DiT of input_size {dit_cfg.input_size} takes "
                             f"{8 * dit_cfg.input_size} px, not {definition}")
        sched_cfg = override_scheduler_config(
            pipe.scheduler_config, args, args.noise_scheduler_config_path)
        return dataclasses.replace(pipe, scheduler_config=sched_cfg)
    raise ValueError(f"unknown model_type: {args.model_type}")
