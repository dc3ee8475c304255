"""The DiT family: DiT-XL/2 (``reference/dit.py``) on the SD VAE's latents,
labels of a 1000-class table, eps the first half of the learned-sigma
output.  The interface is the one ``ddim.py`` describes; transfers only
(training a DiT is not ported)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.families.ddim import Transfer, _part
from portbench.harness import work
from portbench.harness.weights import specs_of
from portbench.reference import dit as RD
from portbench.reference import models as R

HAS_VAE = True


def reference(cfg: dict) -> Dict[str, torch.nn.Module]:
    return {"dit": RD.DiT(cfg["dit"]), "vae": R.AutoencoderKL(cfg["vae"])}


def specs(cfg: dict):
    with torch.device("meta"):
        return specs_of(reference(cfg))


def image_shape(cfg: dict):
    r = cfg["resolution"]
    return (r, r, cfg["vae"]["in_channels"])


def diffusion_shape(cfg: dict):
    lat = cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return (lat, lat, cfg["vae"]["latent_channels"])


def program_transfer(cfg: dict, weights, dtype, device) -> Transfer:
    """The comparison's DiT route: VAE encode (the posterior's mean), the
    method on the latents with the labels' table rows as conditioning, VAE
    decode; DiT and VAE weights stored in ``dtype`` (``cast_params``)."""
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
    from phendiff_tpu_torch.models.dit import DiT, DiTConfig
    from phendiff_tpu_torch.pipelines.dit_img2img import DiTImg2ImgPipeline
    from phendiff_tpu_torch.pipelines.latent_vae import build_on

    dcfg = DiTConfig.from_json(cfg["dit"])
    vcfg = AutoencoderKLConfig.from_json(cfg["vae"])
    dit = build_on(lambda: DiT(dcfg, dtype=dtype), device)
    dit.load_state_dict({**_part(weights, "dit"), "pos_embed": dit.fixed_pos_embed()})
    vae = build_on(lambda: AutoencoderKL(vcfg, dtype=dtype), device)
    vae.load_state_dict(_part(weights, "vae"))
    pipe = DiTImg2ImgPipeline(dcfg, vcfg, SchedulerConfig.from_json(cfg["scheduler"]), dit,
                              vae).cast_params(dtype)
    return Transfer(embed=pipe.encode_class, denoiser=pipe.denoiser_fn(),
                    schedule=pipe.schedule, encode=pipe.encode_images,
                    decode=pipe.decode_latents)


def ref_embed(models, labels):
    return models["dit"].embed(labels)


def ref_denoise(ar, models, x, t: torch.Tensor, y_emb):
    """The eps half of DiT's output."""
    return models["dit"](ar, x, t, y_emb)[..., :x.shape[-1]]


def ref_encode(ar, models, images, noise=None):
    return models["vae"].encode_to_latents(ar, images, noise)


def ref_decode(ar, models, latents):
    return models["vae"].decode_from_latents(ar, latents)


def _dit(cfg, rec):
    with torch.device("meta"), torch.no_grad():
        model = RD.DiT(cfg["dit"])
        x = torch.zeros(1, *diffusion_shape(cfg))
        label = torch.zeros(1, dtype=torch.long)
        model(rec, x, label, model.embed(label))


def _vae(cfg, rec, which: str):
    with torch.device("meta"), torch.no_grad():
        vae = R.AutoencoderKL(cfg["vae"])
        if which == "encode":
            vae.encode_to_latents(rec, torch.zeros(1, *image_shape(cfg)))
        else:
            vae.decode_from_latents(rec, torch.zeros(1, *diffusion_shape(cfg)))


def work_transfer(cfg: dict) -> dict:
    """Per image: the denoiser call's FLOPs (1,049 G for DiT-XL/2 at 64 x
    64 latents) and its self-attention calls at their head dim, D = 72
    (the kernel's padding to 80 is waste, not work); the encode's and the
    decode's FLOPs and GroupNorm calls (the VAE's single-head attention
    runs on plain products)."""
    out = {"denoiser": work.count(lambda rec: _dit(cfg, rec))}
    for which in ("encode", "decode"):
        flops, calls = work.count(lambda rec, w=which: _vae(cfg, rec, w))
        out[which] = (flops, work.Calls(calls.group_norm, {}))
    return out
