"""The SD-2.1 family: ``SDUNet`` on VAE latents, the class row in slot 0 of
a 77-token context, the frozen ``AutoencoderKL``.  The interface is the
one ``ddim.py`` describes."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.families.ddim import Transfer, TrainProgram, _part, train_config
from portbench.harness import work
from portbench.harness.weights import specs_of
from portbench.reference import models as R

HAS_VAE = True
SEQ_LEN = 77


def reference(cfg: dict) -> Dict[str, torch.nn.Module]:
    ce = cfg["class_embedding"]
    return {"unet": R.SDUNet(cfg["unet"]), "vae": R.AutoencoderKL(cfg["vae"]),
            "class_embedding": R.ClassEmbedding(ce["num_classes"], ce["embedding_dim"])}


def specs(cfg: dict):
    with torch.device("meta"):
        return specs_of(reference(cfg))


def image_shape(cfg: dict):
    r = cfg["resolution"]
    return (r, r, cfg["vae"]["in_channels"])


def diffusion_shape(cfg: dict):
    lat = cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return (lat, lat, cfg["vae"]["latent_channels"])


def _pipeline(cfg: dict, weights, dtype, device):
    """An ``SDImg2ImgPipeline`` computing in ``dtype``, its weights f32."""
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
    from phendiff_tpu_torch.models.embeddings import ClassEmbedding
    from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig
    from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline

    ucfg = SDUNetConfig.from_json(cfg["unet"])
    vcfg = AutoencoderKLConfig.from_json(cfg["vae"])
    ce = cfg["class_embedding"]

    def build(fn, part):
        with torch.device("meta"):
            module = fn()
        module = module.to_empty(device=device)
        module.load_state_dict(_part(weights, part))
        return module

    return SDImg2ImgPipeline(
        ucfg, vcfg, SchedulerConfig.from_json(cfg["scheduler"]),
        build(lambda: SDUNet(ucfg, dtype=dtype), "unet"),
        build(lambda: AutoencoderKL(vcfg, dtype=dtype), "vae"),
        build(lambda: ClassEmbedding(ce["num_classes"], ce["embedding_dim"]), "class_embedding"))


def program_transfer(cfg: dict, weights, dtype, device) -> Transfer:
    """The comparison's SD route: VAE encode (the posterior's mean), the
    method on the latents, VAE decode; UNet and VAE weights stored in
    ``dtype`` (``cast_params``)."""
    pipe = _pipeline(cfg, weights, dtype, device).cast_params(dtype)
    return Transfer(embed=pipe.encode_class, denoiser=pipe.denoiser_fn(),
                    schedule=pipe.schedule, encode=pipe.encode_images,
                    decode=pipe.decode_latents)


def program_train(cfg: dict, traffic: dict, weights, device) -> TrainProgram:
    """``Trainer``'s SD step (``sd_trainer_kwargs``): f32 master copies of
    the trained components, the UNet in the compute dtype, the frozen VAE
    encoding each batch in the step (its posterior sampled)."""
    from phendiff_tpu_torch.core.precision import Policy
    from phendiff_tpu_torch.train.train_loop import (
        init_train_state, make_optimizer, make_train_step)
    from phendiff_tpu_torch.train.trainer import TrainerConfig, sd_trainer_kwargs

    policy = Policy.from_mixed_precision(traffic["mixed_precision"])
    pipe = _pipeline(cfg, weights, policy.compute_torch, device)
    tcfg = train_config(traffic)
    kw = sd_trainer_kwargs(pipe, TrainerConfig(mixed_precision=traffic["mixed_precision"],
                                               remat=traffic["remat"], train=tcfg),
                           tuple(traffic["components_to_train"]))
    opt = make_optimizer(tcfg.optimizer, kw["trainable_mask"], sharded=kw["tp_plan"])
    step = make_train_step(kw["model_apply"], kw["embed_fn"], kw["schedule"], tcfg, opt,
                           kw["encode_fn"], kw["encode_inside_grad"])
    state = init_train_state(kw["trainable_params"], opt)
    return TrainProgram(step, state, list(state.opt_state.mu), keep=kw)


def reference_name(program_name: str) -> str:
    return program_name


def ref_embed(models, labels):
    return models["class_embedding"].sequence(labels, SEQ_LEN)


def ref_denoise(ar, models, x, t: torch.Tensor, ctx):
    return models["unet"](ar, x, t, ctx)


def ref_encode(ar, models, images, noise=None):
    return models["vae"].encode_to_latents(ar, images, noise)


def ref_decode(ar, models, latents):
    return models["vae"].decode_from_latents(ar, latents)


def ref_train_loss(ar, models, sched, images, labels, draws, uncond: bool):
    """The summed per-sample loss of these rows: the frozen VAE encodes
    them (its posterior sampled with the step's noise) outside the
    gradient."""
    from portbench.reference import diffusion as D

    with torch.no_grad():
        clean = ref_encode(ar, models, images, draws["enc_noise"])
    ctx = ref_embed(models, labels) * (0.0 if uncond else 1.0)
    xt = D.noisy(sched, clean, draws["noise"], draws["timesteps"])
    out = ref_denoise(ar, models, xt, draws["timesteps"], ctx)
    return D.loss(sched, out, clean, draws["noise"], draws["timesteps"])


def trainable(models) -> Dict[str, torch.nn.Parameter]:
    out = {f"unet.{n}": p for n, p in models["unet"].named_parameters()}
    out.update({f"class_embedding.{n}": p
                for n, p in models["class_embedding"].named_parameters()})
    return out


def _meta_parts(cfg):
    with torch.device("meta"):
        return reference(cfg)


def _unet(cfg, rec, grad: bool):
    with torch.device("meta"):
        parts = _meta_parts(cfg)
        x = torch.zeros(1, *diffusion_shape(cfg))
        ctx = torch.zeros(1, SEQ_LEN, cfg["unet"]["cross_attention_dim"])
        with torch.set_grad_enabled(grad):
            out = parts["unet"](rec, x, torch.zeros(1, dtype=torch.long), ctx)
        if grad:
            out.sum().backward()


def _vae(cfg, rec, which: str):
    with torch.device("meta"), torch.no_grad():
        vae = _meta_parts(cfg)["vae"]
        if which == "encode":
            vae.encode_to_latents(rec, torch.zeros(1, *image_shape(cfg)))
        else:
            vae.decode_from_latents(rec, torch.zeros(1, *diffusion_shape(cfg)))


def work_transfer(cfg: dict) -> dict:
    """Per image: the denoiser call's, the encode's and the decode's FLOPs
    and calls (the VAE's single-head attention runs on plain products, so
    only the UNet's attention calls count for the attention kernels)."""
    out = {"denoiser": work.count(lambda rec: _unet(cfg, rec, False))}
    for which in ("encode", "decode"):
        flops, calls = work.count(lambda rec, w=which: _vae(cfg, rec, w))
        out[which] = (flops, work.Calls(calls.group_norm, {}))
    return out


def work_train(cfg: dict) -> dict:
    """Per sample: the UNet's forward and backward plus the frozen encode's
    FLOPs; the GroupNorm calls run forward (UNet and encoder) and backward
    (UNet), the UNet's self-attention calls both."""
    flops, _ = work.count(lambda rec: _unet(cfg, rec, True))
    enc_flops, enc = work.count(lambda rec: _vae(cfg, rec, "encode"))
    _, unet = work.count(lambda rec: _unet(cfg, rec, False))
    forward = work.Calls({k: unet.group_norm.get(k, 0) + enc.group_norm.get(k, 0)
                          for k in set(unet.group_norm) | set(enc.group_norm)}, unet.attention)
    return {"step_flops": flops + enc_flops, "forward": forward, "backward": unet,
            "attention": unet}
