"""DDIM noise schedule: tables and step functions, in PyTorch.

Counterpart of ``phendiff_tpu/core/scheduler.py``, with the same names and
semantics:

* the tables (``alphas_cumprod`` and the final alpha for "t = -1") are built
  on the host in numpy float64 and then moved to the device as float32;
* ``ddim_step`` takes the pair ``(t, t_prev)`` explicitly, and the inverse
  step is the same map with the pair roles swapped;
* a timestep is a Python int or a ``[B]`` integer tensor.

All arithmetic on samples is float32 on the samples' device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

import numpy as np
import torch

from phendiff_tpu_torch.core.device import DeviceLike, resolve_device

PREDICTION_TYPES = ("epsilon", "sample", "v_prediction")
BETA_SCHEDULES = ("linear", "scaled_linear", "squaredcos_cap_v2")
TIMESTEP_SPACINGS = ("leading", "trailing", "linspace")

Timestep = Union[int, np.integer, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static scheduler configuration.

    Field names follow the diffusers JSON config format, so the files in
    ``configs/noise_scheduler/`` load unchanged.
    """

    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    timestep_spacing: str = "leading"
    rescale_betas_zero_snr: bool = False

    def __post_init__(self):
        if self.beta_schedule not in BETA_SCHEDULES:
            raise ValueError(f"unknown beta_schedule: {self.beta_schedule}")
        if self.prediction_type not in PREDICTION_TYPES:
            raise ValueError(f"unknown prediction_type: {self.prediction_type}")
        if self.timestep_spacing not in TIMESTEP_SPACINGS:
            raise ValueError(f"unknown timestep_spacing: {self.timestep_spacing}")

    _JSON_IGNORED = (
        "_class_name",
        "_diffusers_version",
        "trained_betas",
        "skip_prk_steps",
    )

    @classmethod
    def from_json(cls, path_or_dict) -> "SchedulerConfig":
        if isinstance(path_or_dict, dict):
            raw = dict(path_or_dict)
        else:
            with open(path_or_dict) as f:
                raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        dropped = {
            k for k in raw if k not in known and k not in cls._JSON_IGNORED
        }
        if dropped:
            raise ValueError(f"unsupported scheduler config keys: {sorted(dropped)}")
        return cls(**kwargs)

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["_class_name"] = "DDIMScheduler"
        return d

    def replace(self, **kw) -> "SchedulerConfig":
        return dataclasses.replace(self, **kw)


def _make_betas(config: SchedulerConfig) -> np.ndarray:
    T = config.num_train_timesteps
    if config.beta_schedule == "linear":
        return np.linspace(config.beta_start, config.beta_end, T, dtype=np.float64)
    if config.beta_schedule == "scaled_linear":
        return (
            np.linspace(config.beta_start**0.5, config.beta_end**0.5, T, dtype=np.float64)
            ** 2
        )
    # squaredcos_cap_v2: alpha_bar(t) = cos^2((t/T + 0.008) / 1.008 * pi/2)

    def alpha_bar(t_frac):
        return np.cos((t_frac + 0.008) / 1.008 * np.pi / 2) ** 2

    i = np.arange(T, dtype=np.float64)
    return np.minimum(1.0 - alpha_bar((i + 1) / T) / alpha_bar(i / T), 0.999)


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift/scale sqrt(alpha_bar) so the terminal SNR is exactly zero
    (Lin et al., 2023, "Common Diffusion Noise Schedules and Sample Steps
    are Flawed")."""
    s = np.sqrt(alphas_cumprod)
    s0, sT = s[0], s[-1]
    s = s - sT
    s = s * (s0 / (s0 - sT))
    return s**2


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed diffusion tables on one device."""

    alphas_cumprod: torch.Tensor  # [T] float32
    final_alpha_cumprod: torch.Tensor  # 0-d float32: alpha_bar at "t = -1"
    config: SchedulerConfig

    @property
    def num_train_timesteps(self) -> int:
        return self.config.num_train_timesteps

    @property
    def device(self) -> torch.device:
        return self.alphas_cumprod.device


def make_schedule(
    config: SchedulerConfig, device: DeviceLike = None, dtype=torch.float32
) -> NoiseSchedule:
    """Build the tables in float64 on the host, then move them to ``device``
    (the card unless the caller asks for the CPU) as ``dtype``."""
    dev = resolve_device(device)
    alphas_cumprod = np.cumprod(1.0 - _make_betas(config))
    if config.rescale_betas_zero_snr:
        alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)
    final = 1.0 if config.set_alpha_to_one else float(alphas_cumprod[0])
    return NoiseSchedule(
        alphas_cumprod=torch.as_tensor(alphas_cumprod, dtype=dtype).to(dev),
        final_alpha_cumprod=torch.tensor(final, dtype=dtype, device=dev),
        config=config,
    )


# ---------------------------------------------------------------------------
# Timestep schedules (host-side numpy)
# ---------------------------------------------------------------------------


def inference_timesteps(config: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending sampling timesteps, matching the reference's spacing options.

    leading:  round(arange(n) * T//n)[::-1] + steps_offset
    trailing: round(arange(T, 0, -T/n)) - 1      (descending)
    linspace: round(linspace(0, T-1, n))[::-1]
    """
    T = config.num_train_timesteps
    if num_inference_steps > T:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) > num_train_timesteps ({T})"
        )
    if config.timestep_spacing == "leading":
        step_ratio = T // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        ts = ts + config.steps_offset
    elif config.timestep_spacing == "trailing":
        step_ratio = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -step_ratio)) - 1
    else:  # linspace
        ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1]
    return ts.astype(np.int64)


def timestep_pairs(
    config: SchedulerConfig,
    num_inference_steps: int,
    frac_diffusion_skipped: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(t, t_prev) pairs for generation, most-noised first; ``t_prev`` of the
    last pair is -1 (``final_alpha_cumprod``).  ``frac_diffusion_skipped``
    keeps only timesteps ``<= T * (1 - frac)``."""
    ts = inference_timesteps(config, num_inference_steps)
    if frac_diffusion_skipped:
        if not 0.0 <= frac_diffusion_skipped <= 1.0:
            raise ValueError("frac_diffusion_skipped must be in [0, 1]")
        keep = ts <= config.num_train_timesteps * (1.0 - frac_diffusion_skipped)
        ts = ts[keep]
    if len(ts) == 0:
        raise ValueError("no timesteps left after frac_diffusion_skipped filtering")
    t_prev = np.concatenate([ts[1:], np.array([-1], dtype=ts.dtype)])
    return ts, t_prev


def inversion_timestep_pairs(
    config: SchedulerConfig, num_inference_steps: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(t, t_next) pairs for inversion: exactly the generation pairs reversed,
    so invert -> regenerate round-trips by construction.  The first pair has
    ``t = -1`` (the clean image)."""
    ts, t_prev = timestep_pairs(config, num_inference_steps)
    return t_prev[::-1].copy(), ts[::-1].copy()


# ---------------------------------------------------------------------------
# Table lookups
# ---------------------------------------------------------------------------


def _gather_alpha(schedule: NoiseSchedule, t: Timestep) -> torch.Tensor:
    """alpha_bar at integer timestep(s) t; t == -1 -> final_alpha_cumprod.

    A Python int gives a 0-d tensor; a ``[B]`` tensor gives ``[B]``.
    """
    last = schedule.num_train_timesteps - 1
    if isinstance(t, torch.Tensor):
        t = t.to(schedule.device)
        alpha = schedule.alphas_cumprod[t.clamp(0, last).long()]
        return torch.where(t < 0, schedule.final_alpha_cumprod, alpha)
    t = int(t)
    if t < 0:
        return schedule.final_alpha_cumprod
    return schedule.alphas_cumprod[min(t, last)]


def _bcast_to_sample(coef: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Broadcast a 0-d or [B] coefficient over sample's trailing dims."""
    if coef.ndim == 0:
        return coef
    return coef.reshape(coef.shape + (1,) * (sample.ndim - coef.ndim))


def _sqrt_pair(schedule, t, sample):
    a = _gather_alpha(schedule, t).to(sample.dtype)
    return (
        _bcast_to_sample(torch.sqrt(a), sample),
        _bcast_to_sample(torch.sqrt(1.0 - a), sample),
    )


# ---------------------------------------------------------------------------
# Forward diffusion and training targets
# ---------------------------------------------------------------------------


def add_noise(
    schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor, t: Timestep
) -> torch.Tensor:
    """q(x_t | x_0): sqrt(a_t) x0 + sqrt(1-a_t) eps."""
    sqrt_a, sqrt_1ma = _sqrt_pair(schedule, t, x0)
    return sqrt_a * x0 + sqrt_1ma * noise


def velocity(
    schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor, t: Timestep
) -> torch.Tensor:
    """v-prediction target: sqrt(a) eps - sqrt(1-a) x0 (Salimans & Ho 2022)."""
    sqrt_a, sqrt_1ma = _sqrt_pair(schedule, t, x0)
    return sqrt_a * noise - sqrt_1ma * x0


def snr(schedule: NoiseSchedule, t: Timestep) -> torch.Tensor:
    """Signal-to-noise ratio alpha_bar / (1 - alpha_bar), the weight of the
    'sample' prediction loss."""
    a = _gather_alpha(schedule, t)
    return a / (1.0 - a)


# ---------------------------------------------------------------------------
# Model output -> (x0, eps)
# ---------------------------------------------------------------------------


def predict_x0_eps(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    t: Timestep,
    sample: torch.Tensor,
    prediction_type: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convert the network output into (pred_x0, pred_eps) at timestep t."""
    pt = prediction_type or schedule.config.prediction_type
    sqrt_a, sqrt_1ma = _sqrt_pair(schedule, t, sample)
    if pt == "epsilon":
        x0 = (sample - sqrt_1ma * model_output) / sqrt_a
        eps = model_output
    elif pt == "sample":
        x0 = model_output
        eps = (sample - sqrt_a * x0) / sqrt_1ma
    elif pt == "v_prediction":
        x0 = sqrt_a * sample - sqrt_1ma * model_output
        eps = sqrt_a * model_output + sqrt_1ma * sample
    else:
        raise ValueError(f"unknown prediction_type: {pt}")
    return x0, eps


def _threshold_sample(x0: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Imagen-style dynamic thresholding over each sample's flattened pixels."""
    b = x0.shape[0]
    flat = x0.reshape(b, -1).abs().float()
    s = torch.quantile(flat, ratio, dim=1)
    s = s.clamp(1.0, max_value)
    s = s.reshape((b,) + (1,) * (x0.ndim - 1)).to(x0.dtype)
    return torch.maximum(torch.minimum(x0, s), -s) / s


def _maybe_clip_x0(schedule: NoiseSchedule, x0: torch.Tensor) -> torch.Tensor:
    cfg = schedule.config
    if cfg.thresholding:
        return _threshold_sample(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
    if cfg.clip_sample:
        return x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)
    return x0


# ---------------------------------------------------------------------------
# DDIM steps
# ---------------------------------------------------------------------------


def ddim_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    t: Timestep,
    t_prev: Timestep,
    sample: torch.Tensor,
    *,
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    use_clipped_model_output: bool = False,
) -> torch.Tensor:
    """One reverse step x_t -> x_{t_prev} (DDIM eq. 12).

    x_prev = sqrt(a_prev) x0 + sqrt(1 - a_prev - sigma^2) eps + sigma z,
    sigma^2 = eta^2 (1-a_prev)/(1-a_t) (1 - a_t/a_prev).
    """
    x0, eps = predict_x0_eps(schedule, model_output, t, sample)
    x0 = _maybe_clip_x0(schedule, x0)

    a_t = _gather_alpha(schedule, t).to(sample.dtype)
    a_prev = _gather_alpha(schedule, t_prev).to(sample.dtype)

    if use_clipped_model_output:
        sqrt_a = _bcast_to_sample(torch.sqrt(a_t), sample)
        sqrt_1ma = _bcast_to_sample(torch.sqrt(1.0 - a_t), sample)
        eps = (sample - sqrt_a * x0) / sqrt_1ma

    variance = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
    std = eta * torch.sqrt(variance.clamp_min(0.0))

    sqrt_a_prev = _bcast_to_sample(torch.sqrt(a_prev), sample)
    dir_coef = _bcast_to_sample(
        torch.sqrt((1.0 - a_prev - std**2).clamp_min(0.0)), sample
    )
    prev = sqrt_a_prev * x0 + dir_coef * eps
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires `noise`")
        prev = prev + _bcast_to_sample(std, sample) * noise
    return prev


def ddim_inverse_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    t: Timestep,
    t_next: Timestep,
    sample: torch.Tensor,
) -> torch.Tensor:
    """One forward-ODE step x_t -> x_{t_next} (t_next > t), for inversion:
    the mirror of ``ddim_step`` with eta=0 and no x0 clipping."""
    x0, eps = predict_x0_eps(schedule, model_output, t, sample)
    sqrt_a_next, sqrt_1ma_next = _sqrt_pair(schedule, t_next, sample)
    return sqrt_a_next * x0 + sqrt_1ma_next * eps
