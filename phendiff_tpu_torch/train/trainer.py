"""Training orchestrator: run-dir layout, epoch loop, checkpoint cadence,
resume, pipeline save.

Counterpart of ``phendiff_tpu/train/trainer.py`` for one device and the
image-folder route:

* run dir ``exp_parent/experiment/run/{checkpoints, full_pipeline_save}``
  with a shared ``.fidelity_cache`` at the parent;
* epoch loop with per-epoch or per-optimisation-step eval cadence;
* a checkpoint every ``checkpointing_steps`` with rotation, and resume from
  "latest" (or a step) with an exact skip of the batches already consumed;
* metrics read back in one host fetch every ``metrics_flush_every`` steps,
  with a NaN alert on non-finite loss or gradient norm;
* lr x sqrt(data-parallel size), which is 1 on one device;
* with ``compute_metrics=True`` an eval pass runs the ``Evaluator``
  (per-class FID/ISC/KID of EMA samples) and saves the EMA pipeline when
  its ``main_metric_mean`` is the best so far; without it, an eval pass
  saves the pipeline only while the save folder is still empty.

The eval-cadence options the port does not run yet (``eval_every_opti_steps``,
``precise_first_n_epochs``) come with the CLI route.
``for_ddim_pipeline`` builds a ``Trainer`` for a ``ConditionalDDIMPipeline``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from phendiff_tpu_torch.core.device import DeviceLike, resolve_device
from phendiff_tpu_torch.core.precision import Policy
from phendiff_tpu_torch.data.imagefolder import (
    ImageFolderLoader,
    LoaderConfig,
    balanced_subsample,
    scan_imagefolder,
)
from phendiff_tpu_torch.models.unet2d import CondUNet2D
from phendiff_tpu_torch.obs.profiling import StepTimer
from phendiff_tpu_torch.obs.trackers import make_tracker
from phendiff_tpu_torch.pipelines.conditional_ddim import GuidanceConfig, ddim_sample
from phendiff_tpu_torch.train.checkpoints import CheckpointManager
from phendiff_tpu_torch.train.eval_loop import (
    EvalConfig,
    Evaluator,
    get_initial_best_metric,
    is_it_best_model,
)
from phendiff_tpu_torch.train.train_loop import (
    Params,
    TrainConfig,
    TrainState,
    init_train_state,
    make_draws,
    make_optimizer,
    make_train_step,
)


@dataclasses.dataclass
class RunPaths:
    """Run directory layout."""

    run_dir: str
    checkpoints: str
    full_pipeline_save: str
    fidelity_cache: str

    @classmethod
    def create(cls, exp_parent: str, experiment: str, run_name: str) -> "RunPaths":
        run_dir = os.path.join(exp_parent, experiment, run_name)
        paths = cls(
            run_dir=run_dir,
            checkpoints=os.path.join(run_dir, "checkpoints"),
            full_pipeline_save=os.path.join(run_dir, "full_pipeline_save"),
            fidelity_cache=os.path.join(exp_parent, ".fidelity_cache"),
        )
        for p in (paths.run_dir, paths.checkpoints, paths.fidelity_cache):
            os.makedirs(p, exist_ok=True)
        return paths


@dataclasses.dataclass
class TrainerConfig:
    # data
    train_data_dir: str = ""
    definition: Tuple[int, int] = (128, 128)
    perc_samples: float = 100.0
    seed: int = 0
    data_aug_on_the_fly: bool = True
    train_batch_size: int = 16
    # run control
    num_epochs: int = 10
    max_train_steps: Optional[int] = None
    eval_every_epochs: Optional[int] = 1
    checkpointing_steps: int = 1000
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None  # "latest" or a step number
    mixed_precision: str = "bf16"
    compute_metrics: bool = False  # run the Evaluator at each eval pass
    save_final_checkpoint: bool = True
    metrics_flush_every: int = 1  # read metrics back every N steps, one fetch
    upload_uint8: bool = False  # ship uint8 batches, normalise on the device
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    tracker: str = "jsonl"


def build_data(config: TrainerConfig):
    """``(index, loader, eval_index)`` for the image-folder route;
    ``eval_index`` is the full dataset, the metrics' reference set."""
    loader_cfg = LoaderConfig(
        batch_size=config.train_batch_size,
        definition=config.definition,
        transport="uint8" if config.upload_uint8 else "f32",
        random_flip=config.data_aug_on_the_fly,
        seed=config.seed,
    )
    full_index = scan_imagefolder(config.train_data_dir)
    index = full_index
    if config.perc_samples < 100:
        index = balanced_subsample(full_index, config.perc_samples, config.seed)
    return index, ImageFolderLoader(index, loader_cfg), full_index


class Trainer:
    def __init__(
        self,
        config: TrainerConfig,
        paths: RunPaths,
        *,
        model_apply: Callable,  # (params, x, t, class_emb) -> model_out
        embed_fn: Callable,  # (params, labels) -> class_emb
        trainable_params: Params,
        schedule,
        save_pipeline_fn: Callable,  # (state, dirpath) -> None
        make_generate_fn: Optional[Callable] = None,  # (state) -> Evaluator's generate_fn
        trainable_mask=None,
        device: DeviceLike = None,
    ):
        if config.compute_metrics and make_generate_fn is None:
            raise ValueError("compute_metrics=True needs a make_generate_fn")
        self.config = config
        self.paths = paths
        self.device = resolve_device(device)
        # lr x sqrt(data-parallel size), as the reference scales across ranks
        opt_cfg = dataclasses.replace(config.train.optimizer, lr_scale=math.sqrt(1))
        self.train_cfg = dataclasses.replace(config.train, optimizer=opt_cfg)
        self.optimizer = make_optimizer(opt_cfg, trainable_mask)
        self.schedule = schedule
        self._step_fn = make_train_step(model_apply, embed_fn, schedule, self.train_cfg,
                                        self.optimizer)
        self.state = init_train_state(trainable_params, self.optimizer)
        self.ckpt = CheckpointManager(paths.checkpoints, config.checkpoints_total_limit)
        self.tracker = make_tracker(config.tracker, paths.run_dir)
        self.save_pipeline_fn = save_pipeline_fn
        self.make_generate_fn = make_generate_fn
        self.best_metric = get_initial_best_metric()
        self.index, self.loader, eval_index = build_data(config)
        self.evaluator = None
        if config.compute_metrics:
            self.evaluator = Evaluator(config.eval, eval_index, config.definition,
                                       cache_root=paths.fidelity_cache, device=self.device)

    # -- resume ------------------------------------------------------------
    def maybe_resume(self) -> Tuple[int, int]:
        """Returns (first_epoch, batches_to_skip_in_first_epoch)."""
        cfg = self.config
        if cfg.resume_from_checkpoint is None:
            return 0, 0
        step = None if cfg.resume_from_checkpoint == "latest" else int(cfg.resume_from_checkpoint)
        self.ckpt.restore(self.state, step)
        steps_per_epoch = len(self.loader)
        return self.state.step // steps_per_epoch, self.state.step % steps_per_epoch

    # -- eval + best model --------------------------------------------------
    def _run_eval(self, global_step: int) -> None:
        """Evaluate and save the EMA pipeline when it is the best so far;
        without a main metric, save it while the folder is still empty."""
        mean_main = None
        if self.evaluator is not None:
            metrics = self.evaluator.evaluate(self.make_generate_fn(self.state), global_step,
                                              tracker=self.tracker)
            mean_main = metrics.get("main_metric_mean")
        save_dir = self.paths.full_pipeline_save
        if mean_main is None:
            if not (os.path.isdir(save_dir) and os.listdir(save_dir)):
                self.save_pipeline_fn(self.state, save_dir)
        elif is_it_best_model(mean_main, self.best_metric):
            self.best_metric = mean_main
            self.save_pipeline_fn(self.state, save_dir)

    # -- main loop -----------------------------------------------------------
    def _flush_metrics(self, pending, timer: StepTimer) -> None:
        """Log the deferred records; their device scalars come back in one
        host fetch, whose duration is ``perf/t_await_s`` on the newest."""
        if not pending:
            return
        t0 = time.perf_counter()
        keys = sorted(k for k, v in pending[0][2].items() if isinstance(v, torch.Tensor))
        packed = torch.stack([
            torch.stack([m[k].float() for k in keys]) for _, _, m, _ in pending
        ]).cpu().numpy()
        t_await = time.perf_counter() - t0
        for (step_no, epoch, metrics, times), row in zip(pending, packed):
            host = {k: v for k, v in metrics.items() if not isinstance(v, torch.Tensor)}
            host.update(zip(keys, map(float, row)))
            times["perf/t_await_s"] = t_await if step_no == pending[-1][0] else 0.0
            host["epoch"] = epoch
            host.update(times)
            host.update(timer.stats(self.config.train_batch_size))
            self.tracker.log(host, step_no)
            if host.get("nonfinite"):
                self.tracker.alert("NaN", f"non-finite loss/grad at step {step_no}")
        pending.clear()

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        return (torch.from_numpy(images).to(self.device, non_blocking=True),
                torch.from_numpy(labels).long().to(self.device, non_blocking=True))

    def run(self) -> TrainState:
        cfg = self.config
        first_epoch, skip = self.maybe_resume()
        global_step = self.state.step
        done = False
        timer = StepTimer()
        flush_every = max(1, cfg.metrics_flush_every)
        pending = []  # deferred metrics records
        t_count = self.schedule.num_train_timesteps
        p_uncond = self.train_cfg.proba_uncond

        for epoch in range(first_epoch, cfg.num_epochs):
            skip_batches = skip if epoch == first_epoch else 0
            t_iter = time.perf_counter()
            for images, labels in self.loader.epoch(epoch, skip_batches):
                t_data_end = time.perf_counter()
                batch = self._to_device(images, labels)
                draws = make_draws(cfg.seed, self.state.step, tuple(images.shape), t_count,
                                   p_uncond, self.device)
                self.state, metrics = self._step_fn(self.state, batch, draws)
                global_step += 1
                timer.tick()
                times = {
                    "perf/t_data_s": t_data_end - t_iter,
                    "perf/t_dispatch_s": time.perf_counter() - t_data_end,
                }
                if len(pending) >= flush_every:
                    self._flush_metrics(pending, timer)
                pending.append((global_step, epoch, metrics, times))

                if global_step % cfg.checkpointing_steps == 0:
                    self._flush_metrics(pending, timer)
                    self.ckpt.save(global_step, self.state)
                if cfg.max_train_steps and global_step >= cfg.max_train_steps:
                    done = True
                    break
                t_iter = time.perf_counter()
            self._flush_metrics(pending, timer)
            if cfg.eval_every_epochs and (epoch + 1) % cfg.eval_every_epochs == 0:
                self._run_eval(global_step)
            if done:
                break
        if cfg.save_final_checkpoint:
            self.ckpt.save(global_step, self.state)
        return self.state


# ---------------------------------------------------------------------------
# Model-family adapter
# ---------------------------------------------------------------------------

# The attention blocks' module names; --attention_fine_tuning trains exactly
# the parameters under them.
_ATTENTION_MODULE_RE = re.compile(r"^(down_\d+_attn_\d+|mid_attn|up_\d+_attn_\d+)$")


def attention_param_mask(params: Params):
    """name -> True exactly for parameters under an attention block module
    (a whole dotted component must match: no substring matching)."""
    return {n: any(_ATTENTION_MODULE_RE.match(part) for part in n.split(".")[:-1])
            for n in params}


def for_ddim_pipeline(pipe, config: TrainerConfig, paths: RunPaths,
                      attention_fine_tuning: bool = False, **kw) -> Trainer:
    """A Trainer for a ``ConditionalDDIMPipeline``: f32 master copies of its
    weights, the forward in ``config.mixed_precision``'s compute dtype, and
    an EMA pipeline save through ``save_pretrained``."""
    policy = Policy.from_mixed_precision(config.mixed_precision)
    with torch.device("meta"):  # structure only: functional_call brings the weights
        model = CondUNet2D(pipe.unet_config, dtype=policy.compute_torch)
    params = {n: p.detach().float() for n, p in pipe.model.named_parameters()}
    for n, p in pipe.model.named_parameters():
        params[n].requires_grad_(p.requires_grad)

    def model_apply(p, x, t, class_emb):
        return functional_call(model, p, (x, t), {"class_emb": class_emb})

    def embed_fn(p, labels):
        return p["class_embedding.weight"][labels]

    def save_pipeline_fn(state: TrainState, dirpath: str):
        m = CondUNet2D(pipe.unet_config, dtype=pipe.dtype)
        m.load_state_dict({n: t.detach().cpu() for n, t in state.ema_params.items()})
        dataclasses.replace(pipe, model=m.to(pipe.device)).save_pretrained(dirpath)

    ev = config.eval
    cfg = pipe.unet_config

    def make_generate_fn(state: TrainState):
        """EMA-weight sampling in the compute dtype, as ``pipe.generate``."""
        ema = state.ema_params

        def generate(labels, generator, num_inference_steps):
            if ev.unconditional:
                class_emb = torch.zeros((len(labels), cfg.time_embed_dim), device=labels.device)
            else:
                class_emb = embed_fn(ema, labels)
            return ddim_sample(
                lambda x, t, emb: model_apply(ema, x, t, emb), pipe.schedule, class_emb,
                shape=(len(labels), cfg.sample_size, cfg.sample_size, cfg.in_channels),
                generator=generator, num_inference_steps=num_inference_steps,
                guidance=GuidanceConfig(ev.guidance_factor),
            )

        return generate

    return Trainer(
        config, paths,
        model_apply=model_apply,
        embed_fn=embed_fn,
        trainable_params=params,
        schedule=pipe.schedule,
        save_pipeline_fn=save_pipeline_fn,
        make_generate_fn=make_generate_fn,
        trainable_mask=attention_param_mask if attention_fine_tuning else None,
        device=pipe.device,
        **kw,
    )
