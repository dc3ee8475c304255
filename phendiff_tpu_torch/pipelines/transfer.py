"""Image-to-image class transfer: the four methods of the comparison.

Counterpart of ``phendiff_tpu/pipelines/transfer.py``:

* ``ddib`` -- DDIM-invert under the source class, regenerate under the
  target class;
* ``inverted_regeneration`` -- ddib with target == source, the
  reconstruction-error probe;
* ``cfg_forward_start`` -- forward-noise the image part way, then
  CFG-denoise toward the target class;
* ``guided_inverted_start`` -- invert, then reconstruction-guided
  generation: at each step the latent descends the gradient, taken through
  the UNet with ``torch.autograd.grad``, of the Lp distance between the
  clipped pred_x0 and the inverted latent.

PyTorch runs eagerly, so the JAX package's scan and stepwise variants are
one host loop here (``ddib``, ``ddim_invert`` and ``ddim_sample`` serve as
its ``ddib_stepwise`` and ``ddim_sample_stepwise``); the guided method's
stepwise pair takes a forward+input-VJP callable
(``custom_guided_generation_stepwise``, ``guided_inverted_start_stepwise``).
With eta = 0 the DDIM generation update and the inversion update are the
same map,
    x' = sqrt(a[t_tgt]) x0 + sqrt(1 - a[t_tgt]) eps,   (x0, eps) at t_eval,
so the bridge is one host loop over 2N (t_eval, t_target, is_generation)
rows: the inversion rows under the source embedding, then the generation
rows under the target embedding.  Two details hold as in the JAX package:
the network's time is clamped to >= 0 while t_eval = -1 keeps its
final-alpha lookup, and x0-clipping applies on the generation rows only.
Each denoiser call is a ``transfer/denoise`` span, which records its
latency (``obs/profiling.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.obs.profiling import annotate
from phendiff_tpu_torch.pipelines import conditional_ddim as cd
from phendiff_tpu_torch.pipelines.conditional_ddim import DenoiserFn

TRANSFER_METHODS = (
    "ddib",
    "inverted_regeneration",
    "classifier_free_guidance_forward_start",
    "linear_interp_custom_guidance_inverted_start",
)


def ddib_rows(config: S.SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """[2N, 3] int64 rows (t_eval, t_target, is_generation)."""
    inv_t, inv_next = S.inversion_timestep_pairs(config, num_inference_steps)
    gen_t, gen_prev = S.timestep_pairs(config, num_inference_steps)
    return np.stack([
        np.concatenate([inv_t, gen_t]),
        np.concatenate([inv_next, gen_prev]),
        np.concatenate([np.zeros(len(inv_t)), np.ones(len(gen_t))]),
    ], axis=1).astype(np.int64)


@torch.no_grad()
def ddib(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    images: torch.Tensor,
    source_emb: torch.Tensor,
    target_emb: torch.Tensor,
    *,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """Dual diffusion implicit bridge: x --invert(source)--> z --gen(target)--> x'."""
    x = images.to(schedule.device, torch.float32)
    b = x.shape[0]
    for te, tt, is_gen in ddib_rows(schedule.config, num_inference_steps).tolist():
        emb = target_emb if is_gen else source_emb
        t_net = torch.full((b,), max(te, 0), dtype=torch.int64, device=x.device)
        with annotate("transfer/denoise", device=x.device):
            model_out = denoiser(x, t_net, emb)
        x0, eps = S.predict_x0_eps(schedule, model_out, te, x)
        if is_gen:
            x0 = S._maybe_clip_x0(schedule, x0)
        a_tgt = S._gather_alpha(schedule, tt).to(x.dtype)
        x = torch.sqrt(a_tgt) * x0 + torch.sqrt(1.0 - a_tgt) * eps
    return x


def inverted_regeneration(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    images: torch.Tensor,
    source_emb: torch.Tensor,
    *,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """Identity round trip (reconstruction-error probe)."""
    return ddib(denoiser, schedule, images, source_emb, source_emb,
                num_inference_steps=num_inference_steps)


def cfg_forward_start(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    images: torch.Tensor,
    target_emb: torch.Tensor,
    generator: torch.Generator,
    *,
    guidance_scale: float = 2.5,
    frac_diffusion_skipped: float = 0.5,
    num_inference_steps: int = 100,
    guidance_equation: str = "imagen",
    uncond_emb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Partial forward noising (drawn from ``generator``) + CFG
    regeneration toward the target class; the unconditional branch takes
    ``uncond_emb`` (zeros by default)."""
    return cd.ddim_sample(
        denoiser, schedule, target_emb,
        start_image=images,
        add_forward_noise=True,
        generator=generator,
        num_inference_steps=num_inference_steps,
        frac_diffusion_skipped=frac_diffusion_skipped,
        guidance=cd.GuidanceConfig(guidance_scale, guidance_equation),
        uncond_emb=uncond_emb,
    )


def lp_loss(a: torch.Tensor, b: torch.Tensor, p: float = 2.0) -> torch.Tensor:
    """Per-sample p-norm distances, shape [B]."""
    diff = (a.float() - b.float()).abs() ** p
    return diff.reshape(a.shape[0], -1).sum(dim=1) ** (1.0 / p)


def guided_gradient(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    x: torch.Tensor,
    t: int,
    target: torch.Tensor,
    emb: torch.Tensor,
    p: float = 2.0,
):
    """(model_out, d loss / d x) of one guided step, loss the summed Lp
    distance between the clipped pred_x0 and ``target``.  Autograd runs on
    a detached copy of ``x`` only: with the denoiser's parameters frozen it
    forms the input gradient and nothing else."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        t_net = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        model_out = denoiser(x, t_net, emb)
        x0, _ = S.predict_x0_eps(schedule, model_out, t, x)
        loss = lp_loss(S._maybe_clip_x0(schedule, x0), target, p).sum()
        (grad,) = torch.autograd.grad(loss, x)
    return model_out.detach(), grad


@torch.no_grad()
def custom_guided_generation(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    start_latents: torch.Tensor,
    target_emb: torch.Tensor,
    *,
    guidance_loss_scale: float = 1e-3,
    p: float = 2.0,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """Guided denoising from ``start_latents``: at each step the latent
    takes ``x - scale * grad`` before the DDIM update with the same model
    output.  As in the reference, the guidance target is the inverted
    latent the loop starts from, and losses are summed, not averaged, so a
    sample's gradient does not depend on the batch."""
    start = start_latents.to(schedule.device, torch.float32)
    x = start
    ts, t_prev = S.timestep_pairs(schedule.config, num_inference_steps)
    for t, tp in zip(ts.tolist(), t_prev.tolist()):
        model_out, grad = guided_gradient(denoiser, schedule, x, t, start, target_emb, p)
        x = S.ddim_step(schedule, model_out, t, tp, x - guidance_loss_scale * grad)
    return x


def guided_inverted_start(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    images: torch.Tensor,
    source_emb: torch.Tensor,
    target_emb: torch.Tensor,
    *,
    guidance_loss_scale: float = 1e-3,
    p: float = 2.0,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """Invert under the source class, then reconstruction-guided generation
    toward the target."""
    latents = cd.ddim_invert(denoiser, schedule, images, source_emb,
                             num_inference_steps=num_inference_steps)
    return custom_guided_generation(
        denoiser, schedule, latents, target_emb,
        guidance_loss_scale=guidance_loss_scale, p=p,
        num_inference_steps=num_inference_steps,
    )


def guided_head(schedule: S.NoiseSchedule, model_out: torch.Tensor, x: torch.Tensor,
                t: int, target: torch.Tensor, p: float = 2.0):
    """(d loss / d model_out, d loss / d x held fixed model_out) of the
    guided loss ``guided_gradient`` takes: the head's own derivatives,
    which a forward+input-VJP callable chains through the denoiser."""
    with torch.enable_grad():
        mo = model_out.detach().requires_grad_()
        xx = x.detach().requires_grad_()
        x0, _ = S.predict_x0_eps(schedule, mo, t, xx)
        loss = lp_loss(S._maybe_clip_x0(schedule, x0), target, p).sum()
        return torch.autograd.grad(loss, (mo, xx))


@torch.no_grad()
def custom_guided_generation_stepwise(
    fwd_vjp: Callable,  # (x, t[B], emb) -> (model_out, vjp_fn: ct -> d_x)
    schedule: S.NoiseSchedule,
    start_latents: torch.Tensor,
    target_emb: torch.Tensor,
    *,
    guidance_loss_scale: float = 1e-3,
    p: float = 2.0,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """``custom_guided_generation`` over a forward+input-VJP callable (the
    segmented SD UNet's ``forward_with_input_vjp``, which keeps one stage's
    graph alive at a time) instead of autograd through one denoiser call:
    the guided gradient is ``d_x_direct + vjp_fn(d_model_out)``, the same
    chain rule ``guided_gradient`` takes in one piece."""
    start = start_latents.to(schedule.device, torch.float32)
    x = start
    b = x.shape[0]
    ts, t_prev = S.timestep_pairs(schedule.config, num_inference_steps)
    for t, tp in zip(ts.tolist(), t_prev.tolist()):
        t_net = torch.full((b,), t, dtype=torch.int64, device=x.device)
        model_out, vjp_fn = fwd_vjp(x, t_net, target_emb)
        d_mo, d_x_direct = guided_head(schedule, model_out, x, t, start, p)
        grad = d_x_direct + vjp_fn(d_mo)
        x = S.ddim_step(schedule, model_out, t, tp, x - guidance_loss_scale * grad)
    return x


def guided_inverted_start_stepwise(
    denoiser: DenoiserFn,
    fwd_vjp: Callable,
    schedule: S.NoiseSchedule,
    images: torch.Tensor,
    source_emb: torch.Tensor,
    target_emb: torch.Tensor,
    *,
    guidance_loss_scale: float = 1e-3,
    p: float = 2.0,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """``guided_inverted_start`` on the segmented route: DDIM inversion
    through ``denoiser`` under the source class, then
    ``custom_guided_generation_stepwise`` toward the target."""
    latents = cd.ddim_invert(denoiser, schedule, images, source_emb,
                             num_inference_steps=num_inference_steps)
    return custom_guided_generation_stepwise(
        fwd_vjp, schedule, latents, target_emb,
        guidance_loss_scale=guidance_loss_scale, p=p,
        num_inference_steps=num_inference_steps,
    )


@torch.no_grad()
def check_gaussianity(latents: torch.Tensor) -> dict:
    """Moment diagnostics of inverted latents: mean, std, skewness and
    excess kurtosis, all near (0, 1, 0, 0) for a good inversion."""
    x = latents.float().reshape(-1)
    mean = x.mean()
    std = x.std(correction=0)
    z = (x - mean) / (std + 1e-12)
    return {
        "mean": mean,
        "std": std,
        "skewness": (z**3).mean(),
        "excess_kurtosis": (z**4).mean() - 3.0,
    }
