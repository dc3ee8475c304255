"""The run loop around ``SegmentedSDTrainStep``: SD-2.1 fine-tuning one stage
at a time.

Counterpart of ``phendiff_tpu/train/segmented_trainer.py``, with the run
loop of ``train/trainer.py``: the epoch loop over ``trainer.build_data``,
the frozen VAE's encode of each batch (its posterior sampled from the
step's draws, as ``sd_trainer_kwargs``'s step does), UNet and
class-embedding training through the step's ``ctx`` stage with the global
clip at ``max_grad_norm`` and a per-stage EMA, checkpoints of the whole
per-stage state (step, params, EMA, one optimizer state a stage) with
rotation and an exact resume, EMA-weighted evaluation through the
segmented stages and the best-model save (gated on the mean main metric),
and metrics read back one step late (``perf/t_*`` phase times and
``perf/host_ms/<span>`` from the run's spans).

Components are frozen by the optimizer's trainable mask (the port's
counterpart of the JAX trainer's ``multi_transform``): frozen tensors get
no update, while the clip's global norm covers every gradient, as in the
JAX segmented step.  ``copy_params=False`` adopts the pipeline's f32 UNet
tensors (the pipeline's weights then train in place) instead of cloning
them.  One process: the step has no all-reduce.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from phendiff_tpu_torch.core.precision import Policy
from phendiff_tpu_torch.models.autoencoder_kl import decode_from_latents, encode_to_latents
from phendiff_tpu_torch.models.embeddings import ClassEmbedding
from phendiff_tpu_torch.models.sd_segmented import SegmentedSDUNet
from phendiff_tpu_torch.models.sd_unet import SDUNet
from phendiff_tpu_torch.obs.profiling import StepTimer, annotate, recording
from phendiff_tpu_torch.obs.trackers import make_tracker
from phendiff_tpu_torch.pipelines.conditional_ddim import GuidanceConfig, ddim_sample
from phendiff_tpu_torch.train.checkpoints import CheckpointManager
from phendiff_tpu_torch.train.eval_loop import Evaluator, get_initial_best_metric, is_it_best_model
from phendiff_tpu_torch.train.segmented_train import CtxEmbed, SegmentedSDTrainStep
from phendiff_tpu_torch.train.train_loop import AdamWState, Optimizer, Params, make_draws
from phendiff_tpu_torch.train.trainer import (
    RunPaths,
    TrainerConfig,
    attention_param_mask,
    batches,
    build_data,
    step_times,
)

TABLE = "class_embedding.embedding.weight"


@dataclasses.dataclass
class SegmentedState:
    """The per-stage training state; ``state_dict`` / ``load_state_dict`` as
    ``CheckpointManager`` takes them.  Loading into meta tensors (a resume's
    skeleton) puts the checkpoint's tensors on ``device`` instead of
    copying."""

    step: int
    params: Params
    ema_params: Params
    opt_state: Dict[str, AdamWState]
    device: torch.device

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.params, "ema_params": self.ema_params,
                "opt_state": {k: {"count": s.count, "mu": s.mu, "nu": s.nu}
                              for k, s in self.opt_state.items()}}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        def load(mine: Params, theirs: Params):
            if mine.keys() != theirs.keys():
                raise ValueError("checkpoint does not match this state's tensors")
            for n, t in mine.items():
                if t.shape != theirs[n].shape:
                    raise ValueError(f"{n}: checkpoint shape {tuple(theirs[n].shape)} "
                                     f"!= {tuple(t.shape)}")
                if t.is_meta:
                    mine[n] = theirs[n].to(self.device, t.dtype)
                else:
                    t.copy_(theirs[n])

        self.step = int(sd["step"])
        load(self.params, sd["params"])
        load(self.ema_params, sd["ema_params"])
        if self.opt_state.keys() != sd["opt_state"].keys():
            raise ValueError("checkpoint's optimizer stages differ from this state's")
        for key, st in self.opt_state.items():
            load(st.mu, sd["opt_state"][key]["mu"])
            load(st.nu, sd["opt_state"][key]["nu"])
            st.count = int(sd["opt_state"][key]["count"])


class SegmentedSDTrainer:
    """``run()`` fine-tunes ``pipe`` (an ``SDImg2ImgPipeline``) through
    ``SegmentedSDTrainStep``.  ``clip_mode`` "recompute" (two backward
    chains, one stage's gradients alive) or "cache" (one chain, every
    stage's gradients kept, in ``cache_dtype`` if given)."""

    def __init__(self, pipe, config: TrainerConfig, paths: RunPaths,
                 components_to_train: Tuple[str, ...] = ("denoiser", "class_embedding"),
                 clip_mode: str = "recompute", cache_dtype: Optional[torch.dtype] = None,
                 tracker=None, copy_params: bool = True, attention_fine_tuning: bool = False):
        for c in components_to_train:
            if c not in ("denoiser", "class_embedding"):
                raise ValueError(f"unsupported component for the SD family on the segmented "
                                 f"route: {c}")
        if attention_fine_tuning and "denoiser" not in components_to_train:
            raise ValueError("Attention fine tuning requires 'denoiser' to be trained")
        self.config, self.paths, self.pipe = config, paths, pipe
        self.device = pipe.device
        compute = Policy.from_mixed_precision(config.mixed_precision).compute_torch
        with torch.device("meta"):  # structure only: the step brings the weights
            self.seg = SegmentedSDUNet(SDUNet(pipe.unet_config, dtype=compute))
            self.ctx_module = CtxEmbed(pipe.num_classes, pipe.class_embedding_dim,
                                       dtype=compute)

        active = set(components_to_train)

        def trainable_mask(p: Params) -> Dict[str, bool]:
            attn = attention_param_mask(p) if attention_fine_tuning else {}
            return {n: ("class_embedding" in active) if n.startswith("class_embedding.")
                    else ("denoiser" in active and attn.get(n, True)) for n in p}

        opt_cfg = config.train.optimizer
        full = active == {"denoiser", "class_embedding"} and not attention_fine_tuning
        # per-leaf AdamW: the step clips by the global norm itself.  Its
        # first moment is f32 whatever ``moment_dtype`` says, as the JAX
        # route's per-stage optax.adamw is built without mu_dtype
        self.optimizer = Optimizer(
            dataclasses.replace(opt_cfg, max_grad_norm=None, moment_dtype="float32"),
            None if full else trainable_mask)
        self.lr = self.optimizer.lr
        max_norm = opt_cfg.max_grad_norm if opt_cfg.max_grad_norm else None
        self.step_fn = SegmentedSDTrainStep(
            self.seg, pipe.schedule, self.optimizer, proba_uncond=config.train.proba_uncond,
            ema=config.train.ema, max_grad_norm=max_norm, clip_mode=clip_mode,
            cache_dtype=cache_dtype, ctx_module=self.ctx_module)

        if config.resume_from_checkpoint is None:
            take = (lambda t: t.detach().float().clone()) if copy_params else (
                lambda t: t.detach().float())
            params = {n: take(p) for n, p in pipe.unet.named_parameters()}
            params.update({f"class_embedding.{n}": p.detach().float().clone()
                           for n, p in pipe.class_embedding.named_parameters()})
        else:  # a skeleton: maybe_resume puts the checkpoint's tensors in place
            params = {n: torch.empty(p.shape, device="meta")
                      for n, p in [*self.seg.unet.named_parameters(),
                                   *self.ctx_module.named_parameters()]}
        ema = {n: torch.empty_like(t) if t.is_meta else t.clone() for n, t in params.items()}
        self.state = SegmentedState(0, params, ema, self.step_fn.init_opt_state(params),
                                    self.device)

        self.ckpt = CheckpointManager(paths.checkpoints, config.checkpoints_total_limit)
        self.tracker = tracker or make_tracker(config.tracker, paths.run_dir)
        self.best_metric = get_initial_best_metric()
        self.index, self.loader, eval_index = build_data(config)
        self.evaluator = None
        if config.compute_metrics:
            self.evaluator = Evaluator(config.eval, eval_index, config.definition,
                                       cache_root=paths.fidelity_cache, device=self.device)
        vcfg = pipe.vae_config
        self._down = 2 ** (len(vcfg.block_out_channels) - 1)  # the VAE's downsampling

    # -- resume ----------------------------------------------------------------
    def maybe_resume(self) -> Tuple[int, int]:
        """(first_epoch, batches_to_skip_in_first_epoch): the consumed
        batches skipped exactly."""
        cfg = self.config
        if cfg.resume_from_checkpoint is None:
            return 0, 0
        step = None if cfg.resume_from_checkpoint == "latest" else int(cfg.resume_from_checkpoint)
        self.ckpt.restore(self.state, step)
        steps_per_epoch = len(self.loader)
        return self.state.step // steps_per_epoch, self.state.step % steps_per_epoch

    # -- eval / best model -----------------------------------------------------
    def _ema_parts(self):
        ema = self.state.ema_params
        unet = {n: t for n, t in ema.items() if not n.startswith("class_embedding.")}
        ce = {n: t for n, t in ema.items() if n.startswith("class_embedding.")}
        return unet, ce

    def make_generate_fn(self):
        """EMA-weighted ``(labels, generator, num_inference_steps) -> [-1, 1]
        images`` through the segmented stages."""
        unet_p, ce_p = self._ema_parts()
        ucfg, ev = self.pipe.unet_config, self.config.eval

        @torch.no_grad()
        def generate(labels, generator, num_inference_steps):
            seq = functional_call(self.ctx_module, ce_p, (labels,))
            lat = ddim_sample(
                lambda x, t, s: self.seg(x, t, s, params=unet_p), self.pipe.schedule, seq,
                shape=(len(labels), ucfg.sample_size, ucfg.sample_size, ucfg.in_channels),
                generator=generator, num_inference_steps=num_inference_steps,
                guidance=GuidanceConfig(ev.guidance_factor))
            return decode_from_latents(self.pipe.vae, lat).float()

        return generate

    def save_pipeline(self, dirpath: str) -> None:
        """The EMA weights as an ``SDImg2ImgPipeline`` folder."""
        unet_p, ce_p = self._ema_parts()
        pipe = self.pipe
        with torch.device("meta"):
            unet = SDUNet(pipe.unet_config, dtype=pipe.dtype)
            ce = ClassEmbedding(pipe.num_classes, pipe.class_embedding_dim)
        unet.load_state_dict({n: t.detach() for n, t in unet_p.items()}, assign=True)
        ce.load_state_dict({n[len("class_embedding."):]: t.detach() for n, t in ce_p.items()},
                           assign=True)
        dataclasses.replace(pipe, unet=unet, class_embedding=ce).save_pretrained(dirpath)

    def _run_eval(self) -> None:
        mean_main = None
        if self.evaluator is not None:
            metrics = self.evaluator.evaluate(self.make_generate_fn(), self.state.step,
                                              tracker=self.tracker)
            mean_main = metrics.get("main_metric_mean")
        save_dir = self.paths.full_pipeline_save
        if mean_main is None:
            if not (os.path.isdir(save_dir) and os.listdir(save_dir)):
                self.save_pipeline(save_dir)
        elif is_it_best_model(mean_main, self.best_metric):
            self.best_metric = mean_main
            self.save_pipeline(save_dir)

    # -- main loop -------------------------------------------------------------
    def _flush_metrics(self, pending, timer: StepTimer) -> None:
        """Log a previous step's metrics, one host fetch for its scalars;
        the fetch's wait is ``perf/t_await_s``.  Deferring it a step lets
        the next batch's VAE encode and stage launches queue while the card
        still runs this step."""
        if pending is None:
            return
        step_no, epoch, metrics, times = pending
        with recording(), annotate("train/metrics") as fetch:
            keys = sorted(k for k, v in metrics.items() if v.ndim == 0)
            packed = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
        host = dict(zip(keys, packed))
        times["perf/t_await_s"] = fetch.seconds
        host["epoch"] = epoch
        host["lr"] = float(self.lr(step_no))
        host.update(times)
        host.update(timer.stats(self.config.train_batch_size))
        self.tracker.log(host, step_no)
        if host.get("nonfinite"):
            self.tracker.alert("NaN", f"non-finite loss at step {step_no}")

    @torch.no_grad()
    def _latents(self, images: torch.Tensor, draws) -> torch.Tensor:
        if images.dtype == torch.uint8:
            images = images.float() / 127.5 - 1.0
        return encode_to_latents(self.pipe.vae, images, noise=draws.enc_noise)

    def run(self) -> SegmentedState:
        """Train to the configured end; spans record throughout (the
        log's ``perf/*`` phase figures are read from them)."""
        with recording() as rec:
            return self._run(rec)

    def _run(self, rec) -> SegmentedState:
        cfg, st = self.config, self.state
        first_epoch, skip = self.maybe_resume()
        timer = StepTimer()
        done = False
        pending = None  # the previous step's metrics
        t_count = self.pipe.schedule.num_train_timesteps
        latent_c = self.pipe.vae_config.latent_channels
        for epoch in range(first_epoch, cfg.num_epochs):
            skip_batches = skip if epoch == first_epoch else 0
            for _, (images, labels), data in batches(self.loader, epoch, skip_batches,
                                                     self.device):
                b, h, w, _ = images.shape
                draws = make_draws(cfg.seed, st.step, (b, h // self._down, w // self._down,
                                                       latent_c),
                                   t_count, cfg.train.proba_uncond, self.device, posterior=True)
                before = rec.totals()
                with annotate("train/step", device=images.device) as step:
                    with annotate("train/encode"):
                        latents = self._latents(images, draws)
                    _, _, _, metrics = self.step_fn(st.params, st.opt_state, latents, labels,
                                                    draws, ema_params=st.ema_params, step=st.step)
                st.step += 1
                timer.tick(step)
                times = step_times(data, step, rec.since(before))
                self._flush_metrics(pending, timer)
                pending = (st.step, epoch, metrics, times)
                if st.step % cfg.checkpointing_steps == 0:
                    self._flush_metrics(pending, timer)
                    pending = None
                    self.ckpt.save(st.step, st)
                if cfg.eval_every_opti_steps and st.step % cfg.eval_every_opti_steps == 0:
                    self._flush_metrics(pending, timer)
                    pending = None
                    self._run_eval()
                if cfg.max_train_steps and st.step >= cfg.max_train_steps:
                    done = True
                    break
            self._flush_metrics(pending, timer)
            pending = None
            precise = (cfg.precise_first_n_epochs is not None
                       and epoch < cfg.precise_first_n_epochs)
            if precise or (cfg.eval_every_epochs and (epoch + 1) % cfg.eval_every_epochs == 0):
                self._run_eval()
            if done:
                break
        if cfg.save_final_checkpoint:
            self.ckpt.save(st.step, st)
        return st
