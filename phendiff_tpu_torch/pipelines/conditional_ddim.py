"""Class-conditional DDIM sampling and inversion as host loops.

Counterpart of ``phendiff_tpu/pipelines/conditional_ddim.py``.  PyTorch
runs eagerly, so the JAX package's scan and stepwise variants are one
implementation here: a Python loop over the (t, t_prev) pairs.  Semantics
kept:

* start from noise (``shape`` + ``generator``) or from ``start_image``,
  optionally forward-noised to the first kept timestep;
* partial trajectories via ``frac_diffusion_skipped`` or ``strength``;
* classifier-free guidance with both equations, Imagen
  ``uncond + w (cond - uncond)`` (active iff w > 1) and original CFG
  ``cond + w (cond - uncond)`` (active iff w > 0), a per-sample tensor w,
  and the cond and uncond passes batched into one forward;
* eta > 0 draws its step noise from an explicit ``torch.Generator`` (or a
  ``core.rng.RowsOf``: a process's rows of a batch's draws);
* deterministic inversion with the source class.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.core.rng import RowsOf

# denoiser(x[B,H,W,C] f32, t[B] int64, class_emb[B,D]) -> model_output[B,H,W,C] f32
DenoiserFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

DEFAULT_NUM_INFERENCE_STEPS = 50  # reference: pipeline_conditionial_ddim.py:24


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """CFG configuration; ``guidance_factor`` is a Python scalar or a
    per-sample tensor (a tensor always applies guidance)."""

    guidance_factor: Union[float, torch.Tensor] = 0.0
    equation: str = "imagen"  # "imagen" | "cfg"

    def __post_init__(self):
        if self.equation not in ("imagen", "cfg"):
            raise ValueError(f"unknown guidance equation: {self.equation}")

    @property
    def active(self) -> bool:
        w = self.guidance_factor
        if isinstance(w, (int, float)):
            return (w > 1.0) if self.equation == "imagen" else (w > 0.0)
        return True

    def combine(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        w = self.guidance_factor
        if not isinstance(w, (int, float)):
            w = torch.as_tensor(w, dtype=cond.dtype, device=cond.device)
            w = w.reshape((-1,) + (1,) * (cond.ndim - 1))
        if self.equation == "imagen":
            return uncond + w * (cond - uncond)
        return cond + w * (cond - uncond)


def truncate_pairs_by_strength(ts, t_prev, strength: float):
    """Keep only the last ``int(strength * n)`` steps (SD ``strength``
    semantics: truncation by count)."""
    if not 0.0 <= strength <= 1.0:
        raise ValueError("strength must be in [0, 1]")
    n = len(ts)
    init_timestep = min(int(n * strength), n)
    if init_timestep == 0:
        raise ValueError("strength too small: no denoising steps left")
    start = max(n - init_timestep, 0)
    return ts[start:], t_prev[start:]


def _randn(shape, generator: Union[torch.Generator, RowsOf], device) -> torch.Tensor:
    # draw on the generator's device, then move: a CPU generator serves any device
    if isinstance(generator, RowsOf):  # a share of a batch: its rows of the batch's draw
        if len(generator.rows) != shape[0]:
            raise ValueError(f"{len(generator.rows)} rows of the batch for a draw of {shape}")
        full = _randn((generator.batch, *shape[1:]), generator.generator, generator.device)
        return full[generator.rows.to(full.device)].to(device)
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(device)


def _t_batch(t: int, b: int, device) -> torch.Tensor:
    return torch.full((b,), t, dtype=torch.int64, device=device)


@torch.no_grad()
def ddim_sample(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    class_emb: torch.Tensor,  # [B, D]
    *,
    shape: Optional[tuple] = None,
    generator: Optional[torch.Generator] = None,
    start_image: Optional[torch.Tensor] = None,
    add_forward_noise: bool = False,
    num_inference_steps: int = DEFAULT_NUM_INFERENCE_STEPS,
    frac_diffusion_skipped: float = 0.0,
    strength: Optional[float] = None,
    guidance: GuidanceConfig = GuidanceConfig(),
    eta: float = 0.0,
    uncond_emb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the conditional DDIM sampler; returns float32 samples in [-1, 1]."""
    if num_inference_steps < 1:
        raise ValueError("num_inference_steps must be >= 1")
    if num_inference_steps > schedule.num_train_timesteps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) exceeds "
            f"num_train_timesteps ({schedule.num_train_timesteps})"
        )
    if start_image is not None and shape is not None and tuple(start_image.shape) != tuple(shape):
        raise ValueError(f"start_image shape {tuple(start_image.shape)} != requested shape {shape}")
    if class_emb.ndim < 2:
        raise ValueError("class_emb must be [B, ...] conditioning per sample")
    if start_image is not None and start_image.shape[0] != class_emb.shape[0]:
        raise ValueError("start_image batch != conditioning batch")
    if frac_diffusion_skipped and strength is not None:
        raise ValueError("use either frac_diffusion_skipped or strength, not both")
    if (eta > 0.0 or add_forward_noise or start_image is None) and generator is None:
        raise ValueError("noise (start noise, add_forward_noise, eta > 0) needs a generator")

    device = schedule.device
    x = (_randn(shape, generator, device) if start_image is None
         else start_image.to(device, torch.float32))

    ts, t_prev = S.timestep_pairs(schedule.config, num_inference_steps, frac_diffusion_skipped)
    if strength is not None:
        ts, t_prev = truncate_pairs_by_strength(ts, t_prev, strength)

    if add_forward_noise:
        x = S.add_noise(schedule, x, _randn(x.shape, generator, device), int(ts[0]))

    do_cfg = guidance.active
    if do_cfg and uncond_emb is None:
        uncond_emb = torch.zeros_like(class_emb)
    emb = torch.cat([class_emb, uncond_emb]) if do_cfg else class_emb

    b = x.shape[0]
    for t, tp in zip(ts.tolist(), t_prev.tolist()):
        if do_cfg:
            out2 = denoiser(torch.cat([x, x]), _t_batch(t, 2 * b, device), emb)
            cond, uncond = out2.chunk(2)
            model_out = guidance.combine(cond, uncond)
        else:
            model_out = denoiser(x, _t_batch(t, b, device), emb)
        noise = _randn(x.shape, generator, device) if eta > 0.0 else None
        x = S.ddim_step(schedule, model_out, t, tp, x, eta=eta, noise=noise)
    return x


@torch.no_grad()
def ddim_invert(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    image: torch.Tensor,  # [B, H, W, C] in [-1, 1]
    class_emb: torch.Tensor,  # [B, D]: SOURCE class conditioning
    *,
    num_inference_steps: int = DEFAULT_NUM_INFERENCE_STEPS,
) -> torch.Tensor:
    """Deterministic DDIM inversion (image -> Gaussian-ish latent), unguided.
    The network sees t = max(t, 0): the first pair's t = -1 means "clean
    image" in the alpha tables only."""
    ts, t_next = S.inversion_timestep_pairs(schedule.config, num_inference_steps)
    x = image.to(schedule.device, torch.float32)
    b = x.shape[0]
    for t, tn in zip(ts.tolist(), t_next.tolist()):
        model_out = denoiser(x, _t_batch(max(t, 0), b, x.device), class_emb)
        x = S.ddim_inverse_step(schedule, model_out, t, tn, x)
    return x


def to_images(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] model space -> [0,1] image space."""
    return (x / 2.0 + 0.5).clamp(0.0, 1.0)
