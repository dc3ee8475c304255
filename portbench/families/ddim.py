"""PhenDiff's pixel-space DDIM family: ``CondUNet2D`` over 128 px images.

What the harness needs of a family: the parameters (names, shapes, kinds)
of its reference modules, the port's transfer pipeline and train step
built on given weights, the reference's denoiser, embedding and training
loss, and the work of a denoiser call or a train step.  The port is
imported inside the functions that build it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from portbench.harness import work
from portbench.harness.weights import specs_of
from portbench.reference import models as R

HAS_VAE = False


def reference(cfg: dict) -> Dict[str, torch.nn.Module]:
    return {"unet": R.CondUNet2D(cfg["unet"])}


def specs(cfg: dict):
    with torch.device("meta"):
        return specs_of(reference(cfg))


def image_shape(cfg: dict):
    r = cfg["resolution"]
    return (r, r, cfg["unet"]["in_channels"])


def diffusion_shape(cfg: dict):
    return image_shape(cfg)


@dataclasses.dataclass
class Transfer:
    """The port's transfer path: labels -> conditioning, the denoiser, the
    schedule, and (SD) the VAE encode and decode."""

    embed: Callable
    denoiser: Callable
    schedule: object
    encode: Optional[Callable] = None
    decode: Optional[Callable] = None


def program_transfer(cfg: dict, weights: Dict[str, torch.Tensor], dtype, device) -> Transfer:
    """The comparison's DDIM pipeline: the UNet computing in ``dtype`` with
    its conv and linear weights stored in it (``cast_params``)."""
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.config import UNet2DConfig
    from phendiff_tpu_torch.models.unet2d import CondUNet2D
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline

    ucfg = UNet2DConfig.from_json(cfg["unet"])
    with torch.device("meta"):
        model = CondUNet2D(ucfg, dtype=dtype)
    model = model.to_empty(device=device)
    model.load_state_dict(_part(weights, "unet"))
    pipe = ConditionalDDIMPipeline(ucfg, SchedulerConfig.from_json(cfg["scheduler"]), model)
    pipe = pipe.cast_params(dtype)
    return Transfer(embed=pipe.class_embeddings, denoiser=pipe.denoiser_fn(),
                    schedule=pipe.schedule)


def _part(weights, part):
    pre = part + "."
    return {n[len(pre):]: w for n, w in weights.items() if n.startswith(pre)}


@dataclasses.dataclass
class TrainProgram:
    step: Callable  # (state, (images, labels), draws) -> (state, metrics)
    state: object  # the port's TrainState
    names: list  # trainable leaves, in the optimizer's order
    keep: object = None  # what the Trainer would hold besides the state


def train_config(traffic: dict):
    from phendiff_tpu_torch.train.train_loop import OptimizerConfig, TrainConfig

    return TrainConfig(proba_uncond=traffic["proba_uncond"], optimizer=OptimizerConfig(
        learning_rate=traffic["learning_rate"], max_grad_norm=traffic["max_grad_norm"],
        moment_dtype=traffic["moment_dtype"]))


def program_train(cfg: dict, traffic: dict, weights, device) -> TrainProgram:
    """``trainer.for_ddim_pipeline``'s step: f32 master copies of every
    parameter, the UNet run in the compute dtype through ``functional_call``."""
    from torch.func import functional_call

    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.core.precision import Policy
    from phendiff_tpu_torch.models.config import UNet2DConfig
    from phendiff_tpu_torch.models.unet2d import CondUNet2D
    from phendiff_tpu_torch.train.train_loop import (
        init_train_state, make_optimizer, make_train_step)

    ucfg = UNet2DConfig.from_json(cfg["unet"])
    policy = Policy.from_mixed_precision(traffic["mixed_precision"])
    with torch.device("meta"):
        model = CondUNet2D(ucfg, dtype=policy.compute_torch, remat=traffic["remat"])
    params = {n: w.detach().clone().requires_grad_(True)
              for n, w in _part(weights, "unet").items()}
    tcfg = train_config(traffic)
    opt = make_optimizer(tcfg.optimizer)
    step = make_train_step(
        lambda p, x, t, ce: functional_call(model, p, (x, t), {"class_emb": ce}),
        lambda p, labels: p["class_embedding.weight"][labels],
        S.make_schedule(S.SchedulerConfig.from_json(cfg["scheduler"]), device=device),
        tcfg, opt)
    state = init_train_state(params, opt)
    return TrainProgram(step, state, list(state.opt_state.mu))


def reference_name(program_name: str) -> str:
    return "unet." + program_name


def ref_embed(models, labels):
    return models["unet"].embed(labels)


def ref_denoise(ar, models, x, t: torch.Tensor, emb):
    return models["unet"](ar, x, t, emb)


def ref_train_loss(ar, models, sched, images, labels, draws, uncond: bool):
    """The summed per-sample loss of these rows (no VAE: the images are
    the clean targets)."""
    from portbench.reference import diffusion as D

    emb = ref_embed(models, labels) * (0.0 if uncond else 1.0)
    xt = D.noisy(sched, images, draws["noise"], draws["timesteps"])
    out = ref_denoise(ar, models, xt, draws["timesteps"], emb)
    return D.loss(sched, out, images, draws["noise"], draws["timesteps"])


def trainable(models) -> Dict[str, torch.nn.Parameter]:
    return {f"unet.{n}": p for n, p in models["unet"].named_parameters()}


def _meta_unet(cfg, rec, grad: bool):
    with torch.device("meta"):
        unet = R.CondUNet2D(cfg["unet"])
        x = torch.zeros(1, *image_shape(cfg))
        t = torch.zeros(1, dtype=torch.long)
        emb = torch.zeros(1, unet.class_embedding.weight.shape[1])
        with torch.set_grad_enabled(grad):
            out = unet(rec, x, t, emb)
        if grad:
            out.sum().backward()


def work_transfer(cfg: dict) -> dict:
    """Per image: the denoiser call's FLOPs and calls."""
    flops, calls = work.count(lambda rec: _meta_unet(cfg, rec, False))
    return {"denoiser": (flops, calls)}


def work_train(cfg: dict) -> dict:
    """Per sample: the UNet's forward and backward FLOPs, the forward's
    calls (whose GroupNorms and attentions each run a backward too)."""
    flops, _ = work.count(lambda rec: _meta_unet(cfg, rec, True))
    _, calls = work.count(lambda rec: _meta_unet(cfg, rec, False))
    return {"step_flops": flops, "forward": calls, "backward": calls,
            "attention": calls}
