"""What the latent pipelines (``SDImg2ImgPipeline``, ``DiTImg2ImgPipeline``)
share: modules built on the meta device and given storage on the card, and
the frozen VAE's encode and decode of NHWC images."""

from __future__ import annotations

from typing import Optional

import torch

from phendiff_tpu_torch.models.autoencoder_kl import decode_from_latents, encode_to_latents


def build_on(module_fn, device: torch.device) -> torch.nn.Module:
    """A module built on the meta device, then given storage on ``device``
    (no default initialisation of the full-width weights on the host)."""
    with torch.device("meta"):
        module = module_fn()
    return module.to_empty(device=device)


class VAELatents:
    """The VAE plumbing of a pipeline with a ``vae`` and a ``device``."""

    @torch.no_grad()
    def encode_images(self, images: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[-1, 1] NHWC images -> scaled latents in the VAE's dtype: the
        posterior's mean, or a sample of it drawn from ``generator``."""
        return encode_to_latents(self.vae, images.to(self.device), generator)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> [-1, 1] NHWC images in the VAE's dtype."""
        return decode_from_latents(self.vae, latents.to(self.device))
