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
when the VAE trains.  Adam's first moment is f32, or bf16 with
``OptimizerConfig.moment_dtype="bfloat16"`` (optax's ``mu_dtype``, with its
roundings); the second moment and the master parameters stay f32.  The
update runs over chunks of the tensor list, so its f32 temporaries take
at most ``UPDATE_CHUNK`` elements each, not a copy of every moment.

A step is one ``train/step`` span (it records the step's latency) over
the spans of its phases (``obs/profiling.py``):
``train/encode``, ``train/forward`` (class embedding, CFG drop, loss),
``train/backward`` (``autograd.grad``, zero fill), ``train/allreduce`` (the
mean over the data group, a unit span that records its latency),
``train/optimizer`` (clip factor, AdamW) and ``train/ema``; the
``grad_norm`` metric is the step's own time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Collection, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.core.rng import derive_seed
from phendiff_tpu_torch.obs.profiling import annotate
from phendiff_tpu_torch.parallel import mesh
from phendiff_tpu_torch.parallel.mesh import all_reduce_mean_
from phendiff_tpu_torch.train.ema import EMAConfig, ema_update

Params = Dict[str, torch.Tensor]
TrainableMask = Optional[Callable[[Params], Mapping[str, bool]]]

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Elements a chunk of the update covers: its three f32 temporaries (the
# clipped gradient, the update and the denominator) take 768 MiB at most.
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + lr-schedule settings (the reference's flag surface)."""

    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    # None skips the clip: the segmented SD step (train/segmented_train.py)
    # applies the optimizer one stage at a time and clips by the global norm
    # itself, so its AdamW must be per-leaf
    max_grad_norm: Optional[float] = 1.0
    lr_scheduler: str = "constant"  # constant|constant_with_warmup|linear|cosine|polynomial
    lr_warmup_steps: int = 500
    total_steps: int = 100_000  # horizon for decaying schedules
    lr_scale: float = 1.0  # sqrt(data-parallel size), set by the Trainer
    # dtype of Adam's first moment (optax's mu_dtype): "float32" | "bfloat16"
    moment_dtype: str = "float32"

    def __post_init__(self):
        if self.moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be one of {sorted(MOMENT_DTYPES)}, "
                             f"not {self.moment_dtype!r}")


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
    model group (``global_norm``).  ``cfg.max_grad_norm=None`` drops the
    clip: plain per-leaf AdamW."""

    def __init__(self, cfg: OptimizerConfig, trainable_mask: TrainableMask = None,
                 sharded: Collection[str] = ()):
        self.cfg = cfg
        self.lr = make_lr_schedule(cfg)
        self.trainable_mask = trainable_mask
        self.sharded = frozenset(sharded)
        # the factor optax applies to a bf16 first moment
        self._b1_bf16 = float(torch.tensor(cfg.adam_beta1, dtype=torch.bfloat16))

    def trainable_names(self, params: Params):
        if self.trainable_mask is None:
            return list(params)
        mask = self.trainable_mask(params)
        return [n for n in params if mask[n]]

    def init(self, params: Params) -> AdamWState:
        names = self.trainable_names(params)
        mu_dtype = MOMENT_DTYPES[self.cfg.moment_dtype]
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(params[n], dtype=mu_dtype) for n in names},
            nu={n: torch.zeros_like(params[n], dtype=torch.float32) for n in names})

    def clip_factor(self, g: Sequence[torch.Tensor],
                    names: Sequence[str]) -> Optional[torch.Tensor]:
        """The global-norm clip's factor, min(1, max_grad_norm / norm), for
        the f32 gradients ``g`` of the trainable tensors ``names`` (None
        without a clip)."""
        max_norm = self.cfg.max_grad_norm
        if max_norm is None:
            return None
        norm = global_norm(g, [n in self.sharded for n in names])
        return torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params) -> None:
        """Apply one update to ``params`` and ``state`` in place."""
        cfg = self.cfg
        names = list(state.mu)
        if not names:  # every tensor frozen (a stage under a trainable mask)
            state.count += 1
            return
        g = [grads[n].float() for n in names]
        clip = self.clip_factor(g, names)
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        count = state.count + 1
        lr = self.lr(state.count)
        for lo, hi in _chunks(g, UPDATE_CHUNK):
            gc = g[lo:hi] if clip is None else torch._foreach_mul(g[lo:hi], clip)
            mu = [state.mu[n] for n in names[lo:hi]]
            nu = [state.nu[n] for n in names[lo:hi]]
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, gc, gc, value=1.0 - b2)
            if mu[0].dtype == torch.float32:
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, gc, alpha=1.0 - b1)
                upd = torch._foreach_div(mu, 1.0 - b1**count)
            else:
                # optax: mu <- (1 - b1) * g + b1 * mu in f32, with b1 * mu
                # rounded to bf16 first (JAX's weak typing keeps a Python
                # float times a bf16 array bf16, b1 itself rounded to bf16);
                # the update uses that f32 sum, the state its bf16 rounding
                torch._foreach_mul_(mu, self._b1_bf16)
                upd = torch._foreach_mul(gc, 1.0 - b1)
                torch._foreach_add_(upd, mu)
                torch._foreach_copy_(mu, upd)
                torch._foreach_div_(upd, 1.0 - b1**count)
            denom = torch._foreach_div(nu, 1.0 - b2**count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, cfg.adam_epsilon)
            torch._foreach_div_(upd, denom)
            p = [params[n] for n in names[lo:hi]]
            if cfg.adam_weight_decay:
                torch._foreach_add_(upd, p, alpha=cfg.adam_weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr)
        state.count = count


def _chunks(tensors: Sequence[torch.Tensor], limit: int):
    """Consecutive [lo, hi) runs of ``tensors`` of at most ``limit``
    elements each (a larger tensor alone)."""
    lo, n = 0, 0
    for i, t in enumerate(tensors):
        if n and n + t.numel() > limit:
            yield lo, i
            lo, n = i, 0
        n += t.numel()
    yield lo, len(tensors)


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
        """Copy a ``state_dict`` into this state's tensors, in place.  Raises
        if its names or dtypes differ from this state's (a checkpoint of
        bf16 first moments does not load into f32 ones, nor the reverse)."""
        pairs = ((self.params, sd["params"]), (self.ema_params, sd["ema_params"]),
                 (self.opt_state.mu, sd["opt_state"]["mu"]),
                 (self.opt_state.nu, sd["opt_state"]["nu"]))
        for mine, theirs in pairs:
            if mine.keys() != theirs.keys():
                raise ValueError("state dict does not match this state's tensors")
            for n, t in mine.items():
                if theirs[n].dtype != t.dtype:
                    raise ValueError(f"state dict holds {n} as {theirs[n].dtype}, this "
                                     f"state as {t.dtype}")
        self.step = int(sd["step"])
        for mine, theirs in pairs:
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
        with annotate("train/step", device=images.device):
            if images.dtype == torch.uint8:
                # uint8 transport: normalise to [-1, 1] on the device
                images = images.float() / 127.5 - 1.0
            params = state.params
            clean = images
            if encode_fn is not None:
                with annotate("train/encode"):
                    if encode_inside_grad:
                        clean = encode_fn(params, images, draws)
                    else:
                        with torch.no_grad():
                            clean = encode_fn(images, draws)
            with annotate("train/forward"):
                class_emb = embed_fn(params, labels)
                if config.proba_uncond > 0.0:
                    class_emb = class_emb * (1.0 - float(draws.uncond))
                loss = diffusion_loss(model_apply, params, schedule, clean, class_emb,
                                      draws.noise, draws.timesteps)
            with annotate("train/backward"):
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
            with annotate("train/allreduce", device=images.device):
                all_reduce_mean_([grads[n] for n in names] + [loss])
            grad_norm = global_norm(list(grads.values()), [n in opt.sharded for n in grads])
            with annotate("train/optimizer"):
                opt.update(grads, state.opt_state, params)
            state.step += 1
            with annotate("train/ema"):
                ema_update(config.ema, state.ema_params, params, state.step)
            metrics = {
                "loss": loss,
                "grad_norm": grad_norm,
                "lr": lr_sched(state.step),
                "nonfinite": (~(torch.isfinite(loss) & torch.isfinite(grad_norm))).int(),
            }
        return state, metrics

    return train_step
