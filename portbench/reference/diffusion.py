"""Plain reference of the diffusion arithmetic around the models: the DDIM
tables, one DDIB step, the training loss, the global-norm clip, AdamW and
the EMA, each written from its definition (diffusers' ``DDIMScheduler``,
optax's ``clip_by_global_norm`` + ``adamw``, the EMA warmup law of
diffusers' ``EMAModel``).  Imports nothing of the package under test.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


class Schedule:
    """alpha_bar over the training timesteps, and alpha_bar at "t = -1"."""

    def __init__(self, cfg: dict, device):
        t = cfg["num_train_timesteps"]
        lo, hi = cfg["beta_start"], cfg["beta_end"]
        if cfg["beta_schedule"] == "linear":
            betas = np.linspace(lo, hi, t, dtype=np.float64)
        elif cfg["beta_schedule"] == "scaled_linear":
            betas = np.linspace(lo**0.5, hi**0.5, t, dtype=np.float64) ** 2
        else:
            raise ValueError(f"reference has no beta schedule {cfg['beta_schedule']}")
        if cfg.get("rescale_betas_zero_snr", False):
            raise ValueError("reference has no zero-SNR rescale")
        abar = np.cumprod(1.0 - betas)
        self.cfg = cfg
        self.alphas = torch.as_tensor(abar, dtype=torch.float32).to(device)
        self.final = 1.0 if cfg.get("set_alpha_to_one", True) else float(abar[0])
        self.final = torch.tensor(self.final, dtype=torch.float32, device=device)

    def alpha(self, t: int) -> torch.Tensor:
        return self.final if t < 0 else self.alphas[min(t, len(self.alphas) - 1)]

    def alpha_rows(self, t: torch.Tensor) -> torch.Tensor:
        return self.alphas[t]

    def timesteps(self, n: int) -> np.ndarray:
        """Descending sampling timesteps of ``n`` steps."""
        cfg, big = self.cfg, self.cfg["num_train_timesteps"]
        spacing = cfg.get("timestep_spacing", "leading")
        if spacing == "leading":
            ts = (np.arange(n) * (big // n)).round()[::-1] + cfg.get("steps_offset", 0)
        elif spacing == "trailing":
            ts = np.round(np.arange(big, 0, -big / n)) - 1
        else:
            ts = np.linspace(0, big - 1, n).round()[::-1]
        return ts.astype(np.int64)

    def ddib_rows(self, n: int) -> List[Tuple[int, int, bool]]:
        """(t_eval, t_target, is_generation) of the 2n DDIB steps: inversion
        over the generation pairs reversed, then generation."""
        ts = self.timesteps(n)
        prev = np.concatenate([ts[1:], [-1]])
        inv = list(zip(prev[::-1].tolist(), ts[::-1].tolist(), [False] * n))
        gen = list(zip(ts.tolist(), prev.tolist(), [True] * n))
        return inv + gen


def x0_eps(sched: Schedule, out: torch.Tensor, t: int, x: torch.Tensor):
    a = sched.alpha(t)
    sa, s1 = torch.sqrt(a), torch.sqrt(1.0 - a)
    pt = sched.cfg["prediction_type"]
    if pt == "epsilon":
        return (x - s1 * out) / sa, out
    if pt == "v_prediction":
        return sa * x - s1 * out, sa * out + s1 * x
    if pt == "sample":
        return out, (x - sa * out) / s1
    raise ValueError(pt)


def ddib_step(sched: Schedule, out: torch.Tensor, x: torch.Tensor, t_eval: int, t_target: int,
              generation: bool) -> torch.Tensor:
    """x at t_eval -> x at t_target, given the model's output at t_eval
    (eta 0: the inversion and generation updates are one map; x0 is
    clipped on generation rows when the schedule clips)."""
    x0, eps = x0_eps(sched, out, t_eval, x)
    if generation and sched.cfg.get("clip_sample", True):
        r = sched.cfg.get("clip_sample_range", 1.0)
        x0 = x0.clamp(-r, r)
    a = sched.alpha(t_target)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps


def loss(sched: Schedule, model_out: torch.Tensor, clean: torch.Tensor, noise: torch.Tensor,
         t: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error against the prediction type's target,
    summed over the rows (the caller divides by the batch)."""
    a = sched.alpha_rows(t).reshape(-1, *([1] * (clean.ndim - 1)))
    pt = sched.cfg["prediction_type"]
    if pt == "epsilon":
        target = noise
    elif pt == "v_prediction":
        target = torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * clean
    else:
        raise ValueError(f"reference has no {pt} training target")
    return (model_out - target).square().flatten(1).mean(1).sum()


def noisy(sched: Schedule, clean, noise, t):
    a = sched.alpha_rows(t).reshape(-1, *([1] * (clean.ndim - 1)))
    return torch.sqrt(a) * clean + torch.sqrt(1.0 - a) * noise


class AdamW:
    """clip_by_global_norm(max_norm) then AdamW with a constant learning
    rate, eps outside the square root, decoupled decay on every trainable
    tensor; float32 state."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=1e-2, max_norm=1.0):
        self.lr, self.b1, self.b2, self.eps, self.wd, self.max_norm = \
            lr, b1, b2, eps, weight_decay, max_norm
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def clipped(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        factor = 1.0 if self.max_norm is None or norm < self.max_norm else self.max_norm / norm
        return {n: g * factor for n, g in grads.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.count += 1
        c1, c2 = 1.0 - self.b1**self.count, 1.0 - self.b2**self.count
        for n, g in self.clipped(grads).items():
            mu, nu, p = self.mu[n], self.nu[n], params[n]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.wd * p
            p.add_(upd, alpha=-self.lr)


def ema_decay(step: int, inv_gamma=1.0, power=0.75, min_decay=0.0, max_decay=0.9999) -> float:
    """The EMA's decay after ``step`` updates, in float32."""
    value = 1.0 - (1.0 + torch.tensor(float(step)) / inv_gamma) ** (-power)
    return float(value.clamp(min_decay, max_decay))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], step: int):
    d = ema_decay(step)
    for n, e in ema.items():
        e.mul_(d).add_(params[n], alpha=1.0 - d)


def leaf_norms(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    """float64 norms of each tensor, on the host."""
    return np.array([float(torch.linalg.vector_norm(t.double())) for t in tensors])


def worst_leaf_gap(got: np.ndarray, want: np.ndarray, keep=None) -> Tuple[float, int]:
    """max over leaves of |got - want| / max(want, median(want)): the gap of
    two norms per leaf against the reference's norm of that leaf or of the
    median leaf, whichever is larger; ``keep`` masks the leaves counted.
    Returns the gap and the worst leaf's index."""
    keep = np.ones(len(want), bool) if keep is None else keep
    floor = float(np.median(want[keep]))
    gaps = np.where(keep, np.abs(got - want) / np.maximum(want, floor), 0.0)
    i = int(np.argmax(gaps))
    return float(gaps[i]), i


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise ||a - b|| / ||b|| over all but the first dimension."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)
