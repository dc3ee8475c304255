"""The GroupNorm and attention calls of the port's models by shape, from the
model run on the meta device (no card needed): ``ops.routes.record_calls``
of a ``CondUNet2D`` forward (``unet_calls``, ``group_norm_calls``), an
``SDUNet`` forward (``sd_unet_calls``), a VAE encode and decode
(``vae_calls``) and an SD train step (``sd_train_calls``).  The one recorder
of those calls, which ``chip_smoke.py`` and the tests share.
"""

from __future__ import annotations

import collections

import torch

from phendiff_tpu_torch.ops.routes import record_calls


def unet_calls(cfg, res: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``record_calls`` of one ``CondUNet2D(cfg)`` forward at ``res`` px."""
    from phendiff_tpu_torch.models.unet2d import CondUNet2D

    def run():
        with torch.device("meta"):
            model = CondUNet2D(cfg, dtype=dtype)
            labels = torch.zeros(1, dtype=torch.long) if cfg.num_class_embeds else None
            model(torch.zeros(1, res, res, cfg.in_channels), torch.zeros(1, dtype=torch.long),
                  class_labels=labels)

    return record_calls(run)


def sd_unet_calls(cfg, latent: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``record_calls`` of one ``SDUNet(cfg)`` forward on ``latent`` x
    ``latent`` latents with a 77-token class sequence."""
    from phendiff_tpu_torch.models.sd_unet import SDUNet

    def run():
        with torch.device("meta"):
            SDUNet(cfg, dtype=dtype)(torch.zeros(1, latent, latent, cfg.in_channels),
                                     torch.zeros(1, dtype=torch.long),
                                     torch.zeros(1, 77, cfg.cross_attention_dim))

    return record_calls(run)


def vae_calls(cfg, res: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``record_calls`` of one ``AutoencoderKL(cfg)`` encode and decode of a
    ``res`` px image."""
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL

    def run():
        with torch.device("meta"):
            vae = AutoencoderKL(cfg, dtype=dtype)
            mean, _ = vae.encode(torch.zeros(1, res, res, cfg.in_channels))
            vae.decode(mean)

    return record_calls(run)


def sd_train_calls(ucfg, vcfg, res: int, remat: bool = False,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The calls of one SD train step on ``res`` px images over a frozen VAE:
    ``{"forward": record_calls`` of the VAE encode and the UNet's forward
    and backward (under ``remat`` the blocks' recomputed forwards too),
    ``"backward": record_calls`` of the UNet forward whose calls each run
    one backward``}``."""
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from phendiff_tpu_torch.models.sd_unet import SDUNet

    def run():
        with torch.device("meta"):
            vae = AutoencoderKL(vcfg, dtype=dtype)
            unet = SDUNet(ucfg, dtype=dtype, remat=remat)
            with torch.no_grad():
                lat, _ = vae.encode(torch.zeros(1, res, res, vcfg.in_channels))
            out = unet(lat, torch.zeros(1, dtype=torch.long),
                       torch.zeros(1, 77, ucfg.cross_attention_dim))
            torch.autograd.grad(out.float().sum(), list(unet.parameters()))

    return {"forward": record_calls(run), "backward": sd_unet_calls(ucfg, res // 8, dtype)}


def group_norm_calls(res: int = 128) -> dict:
    """{(S, C, G, act): calls} of one ``super_small`` forward at ``res`` px,
    in bf16 (``unet_calls``)."""
    from phendiff_tpu_torch.models.config import super_small

    calls = collections.Counter()
    for (s, c, g, act, _), n in unet_calls(super_small(), res)["group_norm"].items():
        calls[(s, c, g, act)] += n
    return dict(calls)
