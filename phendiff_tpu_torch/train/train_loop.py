"""The diffusion training step: loss, global-norm clip, AdamW, EMA.

Counterpart of ``phendiff_tpu/train/train_loop.py``.  Per step:

    sample eps and uniform timesteps -> forward-noise (add_noise) ->
    CFG coin flip (probability ``proba_uncond``, zeros the class embedding
    for the whole batch) -> denoiser forward -> loss by prediction type
    (eps-MSE / SNR-weighted sample-MSE / v-MSE) -> backward ->
    global-norm clip at ``max_grad_norm`` -> AdamW with the lr schedule ->
    EMA update.

The optimizer reproduces ``optax.chain(clip_by_global_norm, adamw)``
(optionally under ``multi_transform`` with a trainable mask):

* the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
  and adds nothing to the norm; under a mask it sees only the trainable
  gradients, while the ``grad_norm`` metric covers all of them;
* Adam puts ``eps`` outside the square root, and weight decay adds
  ``wd * p`` to every trainable update;
* the lr is the schedule at the update count *before* the increment (the
  first warmup update uses lr 0), while the ``lr`` metric is the schedule
  at the new step.

State lives on the device and is updated in place: parameters are f32
leaf tensors held in a dict (the model runs them through
``torch.func.functional_call``), and the optimizer's moments and the EMA
are dicts of the same shapes.  The random draws of a step (noise,
timesteps, coin flip, and for the SD family the VAE posterior's noise) are
an explicit ``StepDraws`` argument, made by ``make_draws`` from a seed and
the step number, so a test can inject the draws another implementation
made.  Under data parallelism (``parallel/mesh.py``) each process runs the
step on its rows of the global batch with its rows of the global draws
(``StepDraws.rows``); the gradients and the loss are averaged over the
processes right after the backward, so the clip, the update and the
``grad_norm`` metric see the global gradient and every replica takes the
same update.  Under tensor parallelism (``parallel/tp.py``) ``params`` holds
this rank's shards of the leaves named in ``sharded``: the gradients are
averaged over the data group only, the global norm sums the sharded
leaves' squares over the model group and counts the replicated leaves
once, and AdamW and the EMA update the local tensors.  ``encode_fn`` maps pixel batches to the diffusion space (the SD
family's VAE encode), outside the gradient for a frozen VAE or inside it
when the VAE trains.  Adam's first moment is always f32 (the
JAX package's ``moment_dtype`` option measured slower and is not ported).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Collection, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.core.rng import derive_seed
from phendiff_tpu_torch.parallel import mesh
from phendiff_tpu_torch.parallel.mesh import all_reduce_mean_
from phendiff_tpu_torch.train.ema import EMAConfig, ema_update

Params = Dict[str, torch.Tensor]
TrainableMask = Optional[Callable[[Params], Mapping[str, bool]]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + lr-schedule settings (the reference's flag surface)."""

    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    lr_scheduler: str = "constant"  # constant|constant_with_warmup|linear|cosine|polynomial
    lr_warmup_steps: int = 500
    total_steps: int = 100_000  # horizon for decaying schedules
    lr_scale: float = 1.0  # sqrt(data-parallel size), set by the Trainer


def _ramp(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return lambda count: init

    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return f


def _join(first: Callable[[int], float], second: Callable[[int], float],
          boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """count -> lr, the five shapes of the JAX package with optax's
    boundaries."""
    peak = cfg.learning_rate * cfg.lr_scale
    warm = cfg.lr_warmup_steps
    total = max(cfg.total_steps, warm + 1)
    if cfg.lr_scheduler == "constant":
        return lambda count: peak
    warmup = _ramp(0.0, peak, warm)
    if cfg.lr_scheduler == "constant_with_warmup":
        return _join(warmup, lambda count: peak, warm)
    if cfg.lr_scheduler in ("linear", "polynomial"):  # polynomial of power 1
        return _join(warmup, _ramp(peak, 0.0, total - warm), warm)
    if cfg.lr_scheduler == "cosine":
        decay_steps = total - warm

        def cosine(count: int) -> float:
            count = min(count, decay_steps)
            return peak * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

        return _join(warmup, cosine, warm)
    raise ValueError(f"unknown lr_scheduler: {cfg.lr_scheduler}")


def global_norm(tensors: Sequence[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32 (optax.global_norm).

    ``sharded[i]`` marks ``tensors[i]`` as this rank's shard of a leaf split
    over the model group: those squares are summed over the group, the
    others (whole on every rank) are counted once."""
    if not sharded or not any(sharded):
        norms = torch._foreach_norm([t.float() for t in tensors])
        return torch.linalg.vector_norm(torch.stack(norms))

    def squares(ts):
        if not ts:
            return torch.zeros((), device=tensors[0].device)
        return torch.stack(torch._foreach_norm([t.float() for t in ts])).square().sum()

    part = squares([t for t, s in zip(tensors, sharded) if s])
    dist.all_reduce(part, group=mesh.model_group())
    return (squares([t for t, s in zip(tensors, sharded) if not s]) + part).sqrt()


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far
    mu: Params  # first moments of the trainable parameters
    nu: Params  # second moments


class Optimizer:
    """Global-norm clip then AdamW, over the trainable parameters only;
    frozen parameters get a zero update (optax's ``set_to_zero``).  The
    names in ``sharded`` are this rank's shards of leaves split over the
    model group (``global_norm``)."""

    def __init__(self, cfg: OptimizerConfig, trainable_mask: TrainableMask = None,
                 sharded: Collection[str] = ()):
        self.cfg = cfg
        self.lr = make_lr_schedule(cfg)
        self.trainable_mask = trainable_mask
        self.sharded = frozenset(sharded)

    def trainable_names(self, params: Params):
        if self.trainable_mask is None:
            return list(params)
        mask = self.trainable_mask(params)
        return [n for n in params if mask[n]]

    def init(self, params: Params) -> AdamWState:
        names = self.trainable_names(params)
        zeros = lambda: {n: torch.zeros_like(params[n], dtype=torch.float32) for n in names}
        return AdamWState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params) -> None:
        """Apply one update to ``params`` and ``state`` in place."""
        cfg = self.cfg
        names = list(state.mu)
        p = [params[n] for n in names]
        g = [grads[n].float() for n in names]
        norm = global_norm(g, [n in self.sharded for n in names])
        clip = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                           cfg.max_grad_norm / norm)
        g = torch._foreach_mul(g, clip)
        mu, nu = [state.mu[n] for n in names], [state.nu[n] for n in names]
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        count = state.count + 1
        denom = torch._foreach_div(nu, 1.0 - b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.adam_epsilon)
        upd = torch._foreach_div(mu, 1.0 - b1**count)
        torch._foreach_div_(upd, denom)
        if cfg.adam_weight_decay:
            torch._foreach_add_(upd, p, alpha=cfg.adam_weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr(state.count))
        state.count = count


def make_optimizer(cfg: OptimizerConfig, trainable_mask: TrainableMask = None,
                   sharded: Collection[str] = ()) -> Optimizer:
    """AdamW with global-norm clipping; ``trainable_mask`` (params -> name ->
    bool) freezes the parameters it maps to False; ``sharded`` names the
    tensor-parallel shards."""
    return Optimizer(cfg, trainable_mask, sharded)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    proba_uncond: float = 0.0  # CFG unconditional-pass probability
    ema: EMAConfig = EMAConfig()
    optimizer: OptimizerConfig = OptimizerConfig()


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # f32 master parameters, leaf tensors
    ema_params: Params
    opt_state: AdamWState

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "params": {n: p.detach() for n, p in self.params.items()},
            "ema_params": self.ema_params,
            "opt_state": {"count": self.opt_state.count, "mu": self.opt_state.mu,
                          "nu": self.opt_state.nu},
        }

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping) -> None:
        """Copy a ``state_dict`` into this state's tensors, in place."""
        self.step = int(sd["step"])
        for mine, theirs in ((self.params, sd["params"]), (self.ema_params, sd["ema_params"]),
                             (self.opt_state.mu, sd["opt_state"]["mu"]),
                             (self.opt_state.nu, sd["opt_state"]["nu"])):
            if mine.keys() != theirs.keys():
                raise ValueError("state dict does not match this state's tensors")
            for n, t in mine.items():
                t.copy_(theirs[n])
        self.opt_state.count = int(sd["opt_state"]["count"])


def init_train_state(params: Union[Params, torch.nn.Module], optimizer: Optimizer) -> TrainState:
    """A fresh state: step 0, a copy of the params (leaf tensors keeping
    their ``requires_grad``), an EMA copy and zero moments."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    params = {n: p.detach().clone().requires_grad_(p.requires_grad) for n, p in params.items()}
    return TrainState(
        step=0, params=params,
        ema_params={n: p.detach().clone() for n, p in params.items()},
        opt_state=optimizer.init(params),
    )


@dataclasses.dataclass
class StepDraws:
    """The random numbers one train step uses.  ``noise`` and ``enc_noise``
    have the shape of the diffusion space (the SD family's latents, not its
    pixels); the step casts them to the clean tensor's dtype."""

    noise: torch.Tensor  # [B, H, W, C] f32, N(0, 1)
    timesteps: torch.Tensor  # [B] int64, uniform in [0, num_train_timesteps)
    uncond: bool  # the batch-level CFG coin flip
    enc_noise: Optional[torch.Tensor] = None  # [B, H, W, C] f32: the VAE posterior's sample

    def rows(self, sl: slice) -> "StepDraws":
        """The draws of rows ``sl`` of the batch (a process's share of the
        global draws); the coin flip is the whole batch's."""
        return dataclasses.replace(
            self, noise=self.noise[sl], timesteps=self.timesteps[sl],
            enc_noise=None if self.enc_noise is None else self.enc_noise[sl])


def make_draws(seed: int, step: int, shape: Tuple[int, ...], num_train_timesteps: int,
               proba_uncond: float, device, posterior: bool = False) -> StepDraws:
    """The draws of step ``step``, determined by ``(seed, step)`` alone (so a
    resumed run draws what the uninterrupted one would have).  The coin flip
    and timesteps come from a CPU generator (no device sync for the flip),
    the noise from a generator on ``device``; with ``posterior`` the VAE
    posterior's noise comes from a third one."""
    host = torch.Generator().manual_seed(derive_seed(seed, step, 0))
    uncond = proba_uncond > 0.0 and float(torch.rand((), generator=host)) < proba_uncond
    t = torch.randint(0, num_train_timesteps, (shape[0],), generator=host)
    dev = torch.Generator(device=device).manual_seed(derive_seed(seed, step, 1))
    noise = torch.randn(shape, generator=dev, device=device)
    enc_noise = None
    if posterior:
        dev = torch.Generator(device=device).manual_seed(derive_seed(seed, step, 2))
        enc_noise = torch.randn(shape, generator=dev, device=device)
    return StepDraws(noise=noise, timesteps=t.to(device), uncond=uncond, enc_noise=enc_noise)


def diffusion_loss(
    model_apply: Callable,  # (params, x, t, class_emb) -> model_out
    params: Params,
    schedule: S.NoiseSchedule,
    clean: torch.Tensor,  # [B, H, W, C] in [-1, 1] (pixels, or VAE latents for SD)
    class_emb: torch.Tensor,  # [B, D], already masked for the uncond branch
    noise: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    b = clean.shape[0]
    noise = noise.to(clean.dtype)  # the JAX step draws it in clean's dtype
    noisy = S.add_noise(schedule, clean, noise, t)
    model_out = model_apply(params, noisy, t, class_emb)
    pt = schedule.config.prediction_type
    weight = None
    if pt == "epsilon":
        target = noise
    elif pt == "sample":
        target = clean
        weight = S.snr(schedule, t)  # the distillation paper's SNR weighting
    elif pt == "v_prediction":
        target = S.velocity(schedule, clean, noise, t)
    else:
        raise ValueError(pt)
    err = (model_out.float() - target.float()).square()
    per_sample = err.reshape(b, -1).mean(dim=1)
    if weight is not None:
        per_sample = per_sample * weight.float()
    return per_sample.mean()


def make_train_step(
    model_apply: Callable,  # (params, x, t, class_emb) -> model_out
    embed_fn: Callable,  # (params, labels) -> class_emb
    schedule: S.NoiseSchedule,
    config: TrainConfig,
    optimizer: Optional[Optimizer] = None,
    encode_fn: Optional[Callable] = None,
    encode_inside_grad: bool = False,
):
    """The train step: ``step(state, (images, labels), draws) -> (state,
    metrics)``.  ``state`` is updated in place and returned; the metrics
    ``loss``, ``grad_norm`` and ``nonfinite`` are device tensors (no sync),
    ``lr`` a float.

    ``encode_fn(images, draws)`` maps the pixel batch to the clean targets
    under ``no_grad`` (a frozen VAE's encode times its scaling factor);
    with ``encode_inside_grad`` it is ``encode_fn(params, images, draws)``
    and runs inside the gradient, so the loss reaches the VAE's encoder
    through the noisy latents (its decoder gets no gradient from it)."""
    opt = optimizer or make_optimizer(config.optimizer)
    lr_sched = make_lr_schedule(config.optimizer)

    def train_step(state: TrainState, batch, draws: StepDraws):
        images, labels = batch
        if images.dtype == torch.uint8:
            # uint8 transport: normalise to [-1, 1] on the device
            images = images.float() / 127.5 - 1.0
        params = state.params
        clean = images
        if encode_fn is not None and encode_inside_grad:
            clean = encode_fn(params, images, draws)
        elif encode_fn is not None:
            with torch.no_grad():
                clean = encode_fn(images, draws)
        class_emb = embed_fn(params, labels)
        if config.proba_uncond > 0.0:
            class_emb = class_emb * (1.0 - float(draws.uncond))
        loss = diffusion_loss(model_apply, params, schedule, clean, class_emb,
                              draws.noise, draws.timesteps)
        names = [n for n, p in params.items() if p.requires_grad]
        got = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        got = dict(zip(names, got))
        # a parameter outside the graph (or frozen by the model, as the
        # Fourier weight is) has a zero gradient, as under jax.grad
        grads = {n: got[n] if got.get(n) is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        # the mean over the data group (a no-op in one process): one flat
        # all-reduce of the computed gradients and the loss
        loss = loss.detach()
        all_reduce_mean_([grads[n] for n in names] + [loss])
        grad_norm = global_norm(list(grads.values()), [n in opt.sharded for n in grads])
        opt.update(grads, state.opt_state, params)
        state.step += 1
        ema_update(config.ema, state.ema_params, params, state.step)
        metrics = {
            "loss": loss,
            "grad_norm": grad_norm,
            "lr": lr_sched(state.step),
            "nonfinite": (~(torch.isfinite(loss) & torch.isfinite(grad_norm))).int(),
        }
        return state, metrics

    return train_step
