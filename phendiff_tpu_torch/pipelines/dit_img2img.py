"""DiTImg2ImgPipeline: DiT (``models/dit.py``) over the SD VAE's latents.

The class-conditional latent model DiT deploys (``sample.py``: DiT-XL/2,
``stabilityai/sd-vae-ft-ema`` or ``-mse``, which has SD's VAE
architecture, scaling 0.18215), on the port's transfer path:

* components: the frozen VAE (its encode and decode shared with
  ``SDImg2ImgPipeline``, ``latent_vae.VAELatents``), the DiT, the DDIM
  schedule.  DiT's ``create_diffusion`` with DDIM spacing is
  ``SchedulerConfig(beta_schedule="linear", beta_start=1e-4,
  beta_end=0.02, prediction_type="epsilon", clip_sample=False,
  set_alpha_to_one=True, steps_offset=0, timestep_spacing="leading")``
  (``DIT_SCHEDULER``): 50 steps are 0, 20, ..., 980;
* ``encode_class``: labels -> their rows of DiT's label table;
  ``uncond_class`` the null class's row (``num_classes``), which
  classifier-free guidance pairs with them;
* ``denoiser_fn``: the eps half of DiT's learned-sigma output, as DiT's
  ``ddim_sample`` with eta 0 reads it.

Folders: ``model_index.json``, ``dit/`` (config and the state dict under
DiT's names, float32), ``vae/`` (as an SD folder's), ``scheduler/``.
Training a DiT (its variational bound term for the learned sigma) is not
ported; the trainer refuses ``--model_type DiT``.
"""

from __future__ import annotations

import copy
import dataclasses
import os

import torch

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.core.device import DeviceLike, device_of, resolve_device
from phendiff_tpu_torch.core.precision import cast_matmul_weights
from phendiff_tpu_torch.core.rng import derive_seed
from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
from phendiff_tpu_torch.models.convert import from_flax_params, to_flax_params
from phendiff_tpu_torch.models.dit import DiT, DiTConfig
from phendiff_tpu_torch.pipelines import conditional_ddim as sampler
from phendiff_tpu_torch.pipelines import io
from phendiff_tpu_torch.pipelines.latent_vae import VAELatents, build_on

DIT_SCHEDULER = S.SchedulerConfig(
    num_train_timesteps=1000, beta_start=1e-4, beta_end=0.02, beta_schedule="linear",
    prediction_type="epsilon", clip_sample=False, set_alpha_to_one=True, steps_offset=0,
    timestep_spacing="leading")


@dataclasses.dataclass
class DiTImg2ImgPipeline(VAELatents):
    dit_config: DiTConfig
    vae_config: AutoencoderKLConfig
    scheduler_config: S.SchedulerConfig
    dit: DiT  # its ``dtype`` is the compute dtype
    vae: AutoencoderKL

    def __post_init__(self):
        self._schedule = S.make_schedule(self.scheduler_config, device=self.device)

    # -- construction -----------------------------------------------------
    @classmethod
    def init_random(cls, dit_config: DiTConfig, vae_config: AutoencoderKLConfig,
                    scheduler_config: S.SchedulerConfig = DIT_SCHEDULER, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> "DiTImg2ImgPipeline":
        """Random weights (Flax's initialisers, not DiT's zero init), each
        component from its own generator seeded from ``seed``."""
        dev = resolve_device(device)
        gens = [torch.Generator(device=dev).manual_seed(derive_seed(seed, i)) for i in range(2)]
        dit = build_on(lambda: DiT(dit_config, dtype=dtype), dev).init_weights(gens[0])
        vae = build_on(lambda: AutoencoderKL(vae_config, dtype=dtype), dev).init_weights(gens[1])
        return cls(dit_config, vae_config, scheduler_config, dit, vae)

    @classmethod
    def from_pretrained(cls, dirpath: str, dtype: torch.dtype = torch.float32,
                        device: DeviceLike = None) -> "DiTImg2ImgPipeline":
        """Load a folder ``save_pretrained`` wrote; weights load as float32,
        ``dtype`` is the compute dtype."""
        dev = resolve_device(device)
        if io.load_model_index(dirpath).get("_class_name") != "DiTImg2ImgPipeline":
            raise ValueError(f"not a DiTImg2ImgPipeline folder: {dirpath}")
        parts = {name: io.load_component(os.path.join(dirpath, name)) for name in ("dit", "vae")}
        for name, (_, flat) in parts.items():
            if flat is None:
                raise ValueError(f"no {name} weights in {dirpath}")
        sched_raw, _ = io.load_component(os.path.join(dirpath, "scheduler"))
        dit_config = DiTConfig.from_json(parts["dit"][0])
        vae_config = AutoencoderKLConfig.from_json(parts["vae"][0])
        dit = build_on(lambda: DiT(dit_config, dtype=dtype), dev)
        dit.load_state_dict({k: torch.from_numpy(v) for k, v in parts["dit"][1].items()})
        vae = build_on(lambda: AutoencoderKL(vae_config, dtype=dtype), dev)
        vae.load_state_dict(from_flax_params(parts["vae"][1], vae))
        return cls(dit_config, vae_config, S.SchedulerConfig.from_json(sched_raw), dit, vae)

    def save_pretrained(self, dirpath: str) -> None:
        io.save_model_index(dirpath, "DiTImg2ImgPipeline",
                            {"dit": "dit", "vae": "vae", "scheduler": "scheduler"})
        io.save_component(os.path.join(dirpath, "dit"), self.dit_config.to_json_dict(),
                          {k: v.detach().float().cpu().numpy()
                           for k, v in self.dit.state_dict().items()})
        io.save_component(os.path.join(dirpath, "vae"), self.vae_config.to_json_dict(),
                          to_flax_params(self.vae.state_dict()))
        io.save_component(os.path.join(dirpath, "scheduler"),
                          self.scheduler_config.to_json_dict())

    def cast_params(self, dtype: torch.dtype = torch.bfloat16) -> "DiTImg2ImgPipeline":
        """A pipeline whose DiT and VAE conv and linear weights are stored in
        ``dtype``, for inference; the label table, ``pos_embed`` and the
        VAE's GroupNorm params stay float32."""
        return dataclasses.replace(
            self, dit=cast_matmul_weights(copy.deepcopy(self.dit), dtype),
            vae=cast_matmul_weights(copy.deepcopy(self.vae), dtype))

    # -- components ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return device_of(self.dit)

    @property
    def schedule(self) -> S.NoiseSchedule:
        return self._schedule

    @property
    def num_classes(self) -> int:
        return self.dit_config.num_classes

    def encode_class(self, class_labels) -> torch.Tensor:
        """labels -> their [B, hidden] rows of DiT's label table (no
        gradient)."""
        labels = torch.as_tensor(class_labels, dtype=torch.int64, device=self.device)
        with torch.no_grad():
            return self.dit.y_embedder(labels)

    def uncond_class(self, class_emb: torch.Tensor) -> torch.Tensor:
        """The null class's row for each row of ``class_emb``."""
        with torch.no_grad():
            null = self.dit.y_embedder.embedding_table.weight[self.num_classes]
        return null.expand_as(class_emb)

    def denoiser_fn(self) -> sampler.DenoiserFn:
        """DiT over (latents, t, label rows) -> the eps half of its output
        (no autograd graph unless the input requires a gradient)."""
        dit = self.dit

        def fn(x, t, class_emb):
            with torch.set_grad_enabled(torch.is_grad_enabled() and x.requires_grad):
                return dit.eps_of(dit(x, t, class_emb))

        return fn
