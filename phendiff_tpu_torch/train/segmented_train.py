"""The SD fine-tune step as a chain of per-stage VJPs.

Counterpart of ``phendiff_tpu/train/segmented_train.py``.  The forward runs
the stages of ``models/sd_segmented.py`` under ``no_grad``, recording each
stage's inputs; the backward walks

    out <- up* <- mid <- down* <- stem

re-running one stage at a time with its inputs and its parameters
requiring grad and pulling the output cotangents back with one
``torch.autograd.grad``, so at most one stage's activations and autograd
graph are alive.  Cotangents follow the forward's skip plumbing: an up
stage's VJP gives the cotangents of the skips it consumed, delivered to
the down stage that pushed them (a down stage's output and its last skip
are one tensor; autograd sums their cotangents); the timestep- and
context-embedding cotangents accumulate over the stages into the stem and
into the ``ctx`` stage (or ``metrics["ctx_grad"]``).

The optimizer is applied one stage at a time, which is exact only for
per-leaf optimizers (``check_per_leaf_optimizer`` rejects the port's
clipping ``Optimizer``: build it with ``max_grad_norm=None``), and which
keeps one stage's gradients alive.  The global grad-norm clip is the
step's own (``max_grad_norm``), in two exact schemes:

* ``clip_mode="cache"``: one backward chain; each stage's gradients are
  kept (in ``cache_dtype`` if given; the norm is always taken on the f32
  gradients before the cast), then scaled by the global clip factor and
  applied;
* ``clip_mode="recompute"``: two backward chains; the first only sums the
  squared norms, the second runs with the loss cotangent pre-scaled by the
  clip factor (gradients are linear in it) and applies stage by stage.

The class-embedding table trains as a ``ctx`` stage (``ctx_module=
CtxEmbed(...)`` and integer labels for ``cond``), through the same
optimizer, EMA and clip; the CFG-dropout mask multiplies the sequence and
its cotangent, so a dropped batch sends zero gradient into the table.  The
three prediction types take ``train_loop.diffusion_loss``'s targets and
SNR weights.  The random numbers come in as ``train_loop.StepDraws``
(noise, timesteps, the coin flip), so a test can inject another
implementation's draws.  Parameters, optimizer states and the EMA are
flat dicts updated in place.  ``device_of`` (stage key -> device, from
``parallel/pp.py::stage_devices``) keeps each stage's parameters, moments
and EMA on its device; the ``ctx`` stage and the clip's scalars ride with
the stem.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.models.embeddings import ClassEmbedding, pad_to_clip_sequence
from phendiff_tpu_torch.models.sd_segmented import SegmentedSDUNet
from phendiff_tpu_torch.train.ema import EMAConfig, ema_update
from phendiff_tpu_torch.train.train_loop import StepDraws

Params = Dict[str, torch.Tensor]


class CtxEmbed(nn.Module):
    """The SD class conditioning as a trainable stage: the table lookup and
    ``pad_to_clip_sequence``.  Its parameter is
    ``class_embedding.embedding.weight``, the pipeline's ``class_embedding``
    component under that name."""

    def __init__(self, num_classes: int, embedding_dim: int = 1024, seq_len: int = 77,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.class_embedding = ClassEmbedding(num_classes, embedding_dim)
        self.seq_len, self.dtype = seq_len, dtype

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return pad_to_clip_sequence(self.class_embedding(labels).to(self.dtype), self.seq_len)


def check_per_leaf_optimizer(optimizer) -> None:
    """Reject an optimizer whose update of one tensor depends on another's
    gradient (a global-norm clip), which per-stage application would turn
    into a per-stage clip.  Probe: two updates of a two-tensor dict, twice,
    with only tensor ``b``'s first gradient changed; tensor ``a``'s updates
    must not move (two, because Adam's first update is scale-invariant).
    An optimizer that cannot run on the probe is not checked."""
    def two_steps(g_first):
        p = {"a": torch.ones(2), "b": torch.zeros(3)}
        state = optimizer.init(p)
        a0 = p["a"].clone()
        optimizer.update(g_first, state, p)
        a1 = p["a"].clone()
        optimizer.update({"a": torch.full((2,), 1.0), "b": torch.zeros(3)}, state, p)
        return a1 - a0, p["a"] - a1

    try:
        u1a, u2a = two_steps({"a": torch.full((2,), 100.0), "b": torch.zeros(3)})
        u1b, u2b = two_steps({"a": torch.full((2,), 100.0), "b": torch.full((3,), 1e4)})
    except Exception:
        return
    if not (torch.allclose(u1a, u1b) and torch.allclose(u2a, u2b)):
        raise ValueError(
            "SegmentedSDTrainStep requires a PER-LEAF optimizer (AdamW or SGD, with an lr "
            "schedule or a trainable mask). The one passed couples leaves globally -- e.g. "
            "train_loop.Optimizer with its global-norm clip -- which per-stage application "
            "would silently turn into per-STAGE clipping. Build it with max_grad_norm=None "
            "and pass the global grad clipping via max_grad_norm= instead.")


def _acc(a, b):
    return b if a is None else (a if b is None else a + b)


class SegmentedSDTrainStep:
    """``step(params, opt_state, latents, cond, draws, ema_params=None,
    step=0) -> (params, opt_state, ema_params, metrics)``, every dict updated
    in place.  ``cond`` is the [B, 77, D] conditioning sequence, or the
    integer labels when ``ctx_module`` is given (``params`` then holds its
    table).  ``optimizer`` has the port's interface: ``init(params)``, then
    ``update(grads, state, params)`` in place."""

    def __init__(self, seg: SegmentedSDUNet, schedule: S.NoiseSchedule, optimizer,
                 proba_uncond: float = 0.0, ema: Optional[EMAConfig] = None,
                 max_grad_norm: Optional[float] = None, clip_mode: str = "cache",
                 ctx_module: Optional[nn.Module] = None,
                 device_of: Optional[Dict[str, torch.device]] = None,
                 cache_dtype: Optional[torch.dtype] = None):
        check_per_leaf_optimizer(optimizer)
        if clip_mode not in ("cache", "recompute"):
            raise ValueError(f"unknown clip_mode: {clip_mode!r}")
        if cache_dtype is not None and clip_mode != "cache":
            raise ValueError("cache_dtype only applies to clip_mode='cache'")
        pt = schedule.config.prediction_type
        if pt not in ("epsilon", "sample", "v_prediction"):
            raise ValueError(f"unknown prediction_type: {pt}")
        self.seg, self.schedule, self.optimizer = seg, schedule, optimizer
        self.proba_uncond, self.ema_config = proba_uncond, ema
        self.max_grad_norm, self.clip_mode, self.cache_dtype = max_grad_norm, clip_mode, cache_dtype
        self.ctx_module = ctx_module
        self.device_of = {k: torch.device(d) for k, d in (device_of or {}).items()}
        self.keys: List[str] = list(seg.keys) + (["ctx"] if ctx_module is not None else [])
        self._ctx_names = ([n for n, _ in ctx_module.named_parameters()]
                           if ctx_module is not None else [])

    # -- placement ---------------------------------------------------------
    def _dev(self, key: str) -> Optional[torch.device]:
        if not self.device_of:
            return None
        if key == "ctx":
            return self.device_of.get("ctx", self.device_of.get("stem"))
        return self.device_of.get(key)

    def _move(self, key: str, *tensors):
        dev = self._dev(key)
        if dev is None:
            return tensors
        return tuple(t if t is None or t.device == dev else t.to(dev, non_blocking=True)
                     for t in tensors)

    def param_names(self, key: str) -> List[str]:
        return self._ctx_names if key == "ctx" else self.seg.param_names(key)

    def place_params(self, params: Params) -> Params:
        """Move each stage's tensors of ``params`` to its device, in place
        (a no-op unplaced)."""
        if self.device_of:
            for key in self.keys:
                for n in self.param_names(key):
                    if n in params:
                        (params[n],) = self._move(key, params[n])
        return params

    def init_opt_state(self, params: Params) -> Dict[str, object]:
        """One optimizer state a stage."""
        return {key: self.optimizer.init({n: params[n] for n in self.param_names(key)})
                for key in self.keys}

    # -- pieces --------------------------------------------------------------
    def _targets(self, latents, noise, t):
        b = latents.shape[0]
        pt = self.schedule.config.prediction_type
        noisy = S.add_noise(self.schedule, latents, noise, t)
        if pt == "epsilon":
            target, weight = noise, torch.ones(b, device=latents.device)
        elif pt == "sample":
            target, weight = latents, S.snr(self.schedule, t).float()
        else:
            target, weight = S.velocity(self.schedule, latents, noise, t), torch.ones(
                b, device=latents.device)
        return noisy, target, weight

    @staticmethod
    def _loss_head(pred, target, weight):
        """The mean (SNR-weighted) squared error and its cotangent on
        ``pred``, ``2 w diff / (B n)`` in ``pred``'s dtype."""
        b = pred.shape[0]
        diff = pred.float() - target.float()
        loss = (diff.square().reshape(b, -1).mean(dim=1) * weight).mean()
        n_inner = diff[0].numel()
        ct = diff * (2.0 * weight / (b * n_inner)).reshape((b,) + (1,) * (diff.ndim - 1))
        return loss, ct.to(pred.dtype)

    def _ctx_forward(self, params, labels):
        p = {n: params[n] for n in self._ctx_names}
        return functional_call(self.ctx_module, p, (labels,))

    def _ctx_vjp(self, params, labels, ct_raw) -> Params:
        with torch.enable_grad():
            p = {n: params[n].detach().requires_grad_() for n in self._ctx_names}
            out = functional_call(self.ctx_module, p, (labels,))
            got = torch.autograd.grad(out, list(p.values()), ct_raw)
        return dict(zip(p, got))

    def _run_backward(self, params, args_of, ct, down_out_count,
                      on_stage: Callable[[str, Params], None]):
        """The VJP chain; ``on_stage(key, grads)`` a stage; returns the
        cotangent of the masked conditioning sequence."""
        seg, mv = self.seg, self._move
        n = len(seg.cfg.block_out_channels)
        vjp = lambda key, cts, wrt: seg.vjp(key, args_of[key], cts, wrt=wrt, params=params,
                                            param_grads=True)
        gp, (ct_x,) = vjp("out", mv("out", ct)[0], (0,))
        on_stage("out", gp)
        ct_temb = ct_ctx = None
        skip_cts: List[torch.Tensor] = []
        for i in reversed(range(n)):
            key = f"up:{i}"
            gp, (ct_x, d_temb, d_ctx, d_skips) = vjp(key, mv(key, ct_x)[0], (0, 1, 2, 3))
            on_stage(key, gp)
            ct_temb = _acc(ct_temb, mv("stem", d_temb)[0])
            ct_ctx = _acc(ct_ctx, mv("ctx", d_ctx)[0])
            # the skips were popped off the stack top: reversed, they are in
            # stack order, and the up stages walked last to first rebuild it
            # bottom to top
            skip_cts = skip_cts + list(reversed(d_skips))
        gp, (ct_x, d_temb, d_ctx) = vjp("mid", mv("mid", ct_x)[0], (0, 1, 2))
        on_stage("mid", gp)
        ct_temb = _acc(ct_temb, mv("stem", d_temb)[0])
        ct_ctx = _acc(ct_ctx, mv("ctx", d_ctx)[0])
        for i in reversed(range(n)):
            key = f"down:{i}"
            cnt = down_out_count[key]
            ct_x, *outs_ct = mv(key, ct_x, *skip_cts[-cnt:])
            skip_cts = skip_cts[:-cnt]
            gp, (ct_x, d_temb, d_ctx) = vjp(key, (ct_x, outs_ct), (0, 1, 2))
            on_stage(key, gp)
            ct_temb = _acc(ct_temb, mv("stem", d_temb)[0])
            ct_ctx = _acc(ct_ctx, mv("ctx", d_ctx)[0])
        # the one slot left is conv_in's output, the deepest up stage's skip
        (stem_skip_ct,) = skip_cts
        ct_x, stem_skip_ct = mv("stem", ct_x, stem_skip_ct)
        gp, _ = vjp("stem", (ct_x + stem_skip_ct, ct_temb), ())
        on_stage("stem", gp)
        return ct_ctx

    # -- the step --------------------------------------------------------------
    def __call__(self, params: Params, opt_state: Dict[str, object], latents: torch.Tensor,
                 cond: torch.Tensor, draws: StepDraws, ema_params: Optional[Params] = None,
                 step: int = 0):
        seg, mv = self.seg, self._move
        noise = draws.noise.to(latents.device, latents.dtype)
        t = draws.timesteps.to(latents.device)
        keep = 1.0 - float(draws.uncond) if self.proba_uncond > 0.0 else 1.0
        with torch.no_grad():
            noisy, target, weight = self._targets(latents, noise, t)
            target, weight = mv("out", target, weight)
            if self.ctx_module is not None:
                (labels,) = mv("ctx", cond)
                ctx_raw = self._ctx_forward(params, labels)
            else:
                (ctx_raw,) = mv("ctx", cond)
            # the CFG-dropout mask; its chain rule masks the cotangent below
            ctx = ctx_raw.to(seg.dtype) * keep
            args_of: dict = {}
            pred = seg._forward(noisy, t, ctx, params, args_of, move=mv)
            down_out_count = args_of.pop("down_out_count")
            loss, ct = self._loss_head(pred, target, weight)

        common = self._dev("stem")
        sq_total = torch.zeros((), device=common or latents.device)

        def add_sq(grads: Params):
            nonlocal sq_total
            gs = [g.float() for g in grads.values()]
            sq = torch.stack(torch._foreach_norm(gs)).square().sum()
            sq_total = sq_total + (sq if common is None else sq.to(common))

        def apply_stage(key: str, grads: Params, scale: Optional[torch.Tensor]):
            names = self.param_names(key)
            pslice = {n: params[n] for n in names}
            if scale is not None:
                (s,) = mv(key, scale)
                grads = {n: g * s.to(g.dtype) for n, g in grads.items()}
            self.optimizer.update(grads, opt_state[key], pslice)
            if ema_params is not None:
                ema_update(self.ema_config, {n: ema_params[n] for n in names}, pslice, step + 1)

        ctx_grad_out = None
        ctx_vjp = lambda ct_ctx: self._ctx_vjp(params, labels, ct_ctx * keep)
        if self.max_grad_norm is None:
            def run(key, grads):
                add_sq(grads)
                apply_stage(key, grads, None)

            ct_ctx = self._run_backward(params, args_of, ct, down_out_count, run)
            if self.ctx_module is not None:
                run("ctx", ctx_vjp(ct_ctx))
            else:
                ctx_grad_out = ct_ctx * keep
            grad_norm = sq_total.sqrt()
        elif self.clip_mode == "cache":
            cache: Dict[str, Params] = {}
            cast = self.cache_dtype

            def collect(key, grads):
                add_sq(grads)  # the f32 norm, before any cast
                cache[key] = grads if cast is None else {n: g.to(cast) for n, g in
                                                         grads.items()}

            ct_ctx = self._run_backward(params, args_of, ct, down_out_count, collect)
            if self.ctx_module is not None:
                g_ctx = ctx_vjp(ct_ctx)
                add_sq(g_ctx)
                cache["ctx"] = g_ctx
            else:
                ctx_grad_out = ct_ctx * keep
            scale, grad_norm = self._clip_scale(sq_total)
            for key in list(cache):
                apply_stage(key, cache.pop(key), scale)
        else:  # recompute: chain 1 sums the squared norms, chain 2 applies
            ct_ctx = self._run_backward(params, args_of, ct, down_out_count,
                                        lambda key, grads: add_sq(grads))
            if self.ctx_module is not None:
                add_sq(ctx_vjp(ct_ctx))
            else:
                ctx_grad_out = ct_ctx * keep
            scale, grad_norm = self._clip_scale(sq_total)
            (s,) = mv("out", scale)
            ct_ctx = self._run_backward(params, args_of, ct * s.to(ct.dtype), down_out_count,
                                        lambda key, grads: apply_stage(key, grads, None))
            if self.ctx_module is not None:
                apply_stage("ctx", ctx_vjp(ct_ctx), None)

        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "nonfinite": (~torch.isfinite(loss)).float()}
        if ctx_grad_out is not None:
            # the unclipped gradient of the conditioning sequence, masked
            metrics["ctx_grad"] = ctx_grad_out
        return params, opt_state, ema_params, metrics

    def _clip_scale(self, sq: torch.Tensor):
        """optax's ``clip_by_global_norm``: 1 below the threshold, else
        ``max_norm / norm``; and the norm."""
        norm = sq.sqrt()
        return torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                           self.max_grad_norm / norm), norm
