"""Training orchestrator: run-dir layout, epoch loop, checkpoint cadence,
resume, pipeline save.

Counterpart of ``phendiff_tpu/train/trainer.py``, in one process or one
process a card (``parallel/mesh.py``):

* run dir ``exp_parent/experiment/run/{checkpoints, full_pipeline_save}``
  with a shared ``.fidelity_cache`` at the parent;
* epoch loop with per-epoch or per-optimisation-step eval cadence;
* a checkpoint every ``checkpointing_steps`` with rotation, and resume from
  "latest" (or a step) with an exact skip of the batches already consumed;
* metrics read back in one host fetch every ``metrics_flush_every`` steps,
  with a NaN alert on non-finite loss or gradient norm;
* data parallelism as the JAX Trainer's data axis: lr x sqrt(data size),
  each process loading its shard of every global batch
  (``train_batch_size // data size`` rows, ``num_shards``/``shard_index``
  from its data rank) and taking its rows of the global step draws; only
  rank 0 writes checkpoints, pipeline folders, tracker records and panels
  (the others wait at a barrier), and every rank restores a checkpoint;
* tensor parallelism as the JAX Trainer's model axis (``model_parallel``,
  ``parallel/tp.py``): the model ranks of a replica load the same rows and
  hold their shards of the params, the EMA and Adam's moments (``tp_plan``,
  from the family adapter, which lays out ``make_mesh`` and calls
  ``shard_module``); checkpoints and the saved
  pipeline are the gathered full tree, so they load at any layout, and a
  resume cuts them again;
* with ``compute_metrics=True`` (the default, as in the JAX package) an
  eval pass runs the ``Evaluator``
  (per-class FID/ISC/KID of EMA samples) and saves the EMA pipeline when
  its ``main_metric_mean`` is the best so far; without it, an eval pass
  saves the pipeline only while the save folder is still empty.

Both model families plug in through callables (``model_apply``,
``embed_fn``, ``encode_fn``) over one flat dict of f32 parameters:
``for_ddim_pipeline`` builds a ``Trainer`` for a ``ConditionalDDIMPipeline``,
``for_sd_pipeline`` one for an ``SDImg2ImgPipeline`` (the UNet and class
embedding fine-tuned over a frozen VAE, or the VAE's encoder trained too).
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
from torch import nn
from torch.func import functional_call

from phendiff_tpu_torch.core.device import DeviceLike, resolve_device
from phendiff_tpu_torch.core.precision import Policy
from phendiff_tpu_torch.data.hf_datasets import load_hf_dataset
from phendiff_tpu_torch.data.imagefolder import (
    ImageFolderLoader,
    LoaderConfig,
    balanced_subsample,
    scan_imagefolder,
)
from phendiff_tpu_torch.models.autoencoder_kl import (
    AutoencoderKL,
    decode_from_latents,
    encode_to_latents,
)
from phendiff_tpu_torch.models.embeddings import ClassEmbedding, pad_to_clip_sequence
from phendiff_tpu_torch.models.sd_unet import SDUNet
from phendiff_tpu_torch.models.unet2d import CondUNet2D
from phendiff_tpu_torch.obs.profiling import StepTimer
from phendiff_tpu_torch.obs.trackers import make_tracker
from phendiff_tpu_torch.parallel import tp
from phendiff_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_object,
    data_rank,
    data_size,
    is_main,
    local_rows,
    make_mesh,
    replicate,
)
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
    # data: an image folder, or an HF dataset (the reference's
    # --dataset_name / --dataset_config_name / --split / --cache_dir)
    train_data_dir: str = ""
    dataset_name: Optional[str] = None
    dataset_config_name: Optional[str] = None
    split: str = "train"
    cache_dir: Optional[str] = None
    definition: Tuple[int, int] = (128, 128)
    perc_samples: float = 100.0
    # the metrics' reference set: the full dataset (the reference's default)
    # or the perc_samples subsample the model trains on
    compute_metrics_full_dataset: bool = True
    seed: int = 0
    data_aug_on_the_fly: bool = True
    loader_prefetch: int = 2  # batches the loader's thread decodes ahead
    train_batch_size: int = 16
    # run control
    num_epochs: int = 10
    max_train_steps: Optional[int] = None
    eval_every_epochs: Optional[int] = 1
    eval_every_opti_steps: Optional[int] = None
    # additionally evaluate at the end of each of the first n epochs
    precise_first_n_epochs: Optional[int] = None
    checkpointing_steps: int = 1000
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None  # "latest" or a step number
    mixed_precision: str = "bf16"
    # Run the Evaluator at each eval pass and keep the best pipeline by its
    # FID, as the JAX package does by default.  Until FID-Inception weights
    # are supplied (PHENDIFF_INCEPTION_WEIGHTS) the Inception is a seeded
    # random init, and its FID ranks nothing.
    compute_metrics: bool = True
    # Recompute the UNet's resnet and attention blocks in the backward
    # (torch.utils.checkpoint): less activation memory, one more forward of
    # each block per step.
    remat: bool = False
    save_final_checkpoint: bool = True
    metrics_flush_every: int = 1  # read metrics back every N steps, one fetch
    upload_uint8: bool = False  # ship uint8 batches, normalise on the device
    # processes holding shards of one replica (tensor parallelism); the
    # data axis is the world divided by it
    model_parallel: int = 1
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    tracker: str = "jsonl"


def build_data(config: TrainerConfig):
    """``(index, loader, eval_index)``; ``eval_index`` is the metrics'
    reference set.  The loader yields this process's shard of every global
    batch.  With ``dataset_name`` all three are one
    ``HFDatasetAdapter``."""
    loader_cfg = LoaderConfig(
        batch_size=config.train_batch_size // data_size(),
        definition=config.definition,
        transport="uint8" if config.upload_uint8 else "f32",
        random_flip=config.data_aug_on_the_fly,
        seed=config.seed,
        prefetch=config.loader_prefetch,
        num_shards=data_size(),
        shard_index=data_rank(),
    )
    if config.dataset_name is not None:
        if config.perc_samples < 100:
            raise NotImplementedError(
                "perc_samples subsampling is not supported on the HF-datasets route; "
                "use an image folder")
        adapter = load_hf_dataset(config.dataset_name, loader_cfg, split=config.split,
                                  config_name=config.dataset_config_name,
                                  cache_dir=config.cache_dir)
        return adapter, adapter, adapter
    full_index = scan_imagefolder(config.train_data_dir)
    index = full_index
    if config.perc_samples < 100:
        index = balanced_subsample(full_index, config.perc_samples, config.seed)
    eval_index = full_index if config.compute_metrics_full_dataset else index
    return index, ImageFolderLoader(index, loader_cfg), eval_index


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
        encode_fn: Optional[Callable] = None,  # pixels -> diffusion space (make_train_step)
        encode_inside_grad: bool = False,
        # the diffusion space's shape from the pixel batch's (the SD
        # family's latents); the pixel batch's own when None
        diffusion_shape: Optional[Callable[[Tuple[int, ...]], Tuple[int, ...]]] = None,
        device: DeviceLike = None,
        # the tensor-parallel layout of ``trainable_params`` (tp.shard_module)
        tp_plan: Optional[tp.Plan] = None,
    ):
        if config.compute_metrics and make_generate_fn is None:
            raise ValueError("compute_metrics=True needs a make_generate_fn")
        self.config = config
        self.paths = paths
        self.device = resolve_device(device)
        self.tp_plan = tp_plan or {}
        # lr x sqrt(data-parallel size), as the reference scales across ranks:
        # model ranks hold shards of one replica
        opt_cfg = dataclasses.replace(config.train.optimizer,
                                      lr_scale=math.sqrt(data_size()))
        self.train_cfg = dataclasses.replace(config.train, optimizer=opt_cfg)
        self.optimizer = make_optimizer(opt_cfg, trainable_mask, sharded=self.tp_plan)
        self.schedule = schedule
        self._step_fn = make_train_step(model_apply, embed_fn, schedule, self.train_cfg,
                                        self.optimizer, encode_fn, encode_inside_grad)
        self.posterior = encode_fn is not None  # the step samples the VAE posterior
        self.diffusion_shape = diffusion_shape or (lambda shape: shape)
        self.state = init_train_state(trainable_params, self.optimizer)
        # every replica starts from rank 0's weights, as DDP's constructor makes it
        replicate((self.state.params, self.state.ema_params))
        if self.tp_plan:
            self.state = self._local_state(self.state)
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

    # -- tensor-parallel state ------------------------------------------------
    def _local_state(self, full: TrainState) -> TrainState:
        """This model rank's shards of a full state."""
        plan, opt = self.tp_plan, full.opt_state
        return TrainState(
            step=full.step, params=tp.shard_params(full.params, plan),
            ema_params=tp.shard_params(full.ema_params, plan),
            opt_state=dataclasses.replace(opt, mu=tp.shard_params(opt.mu, plan),
                                          nu=tp.shard_params(opt.nu, plan)))

    def full_state(self) -> TrainState:
        """The state with every leaf whole (the state itself without a model
        axis).  A collective under tensor parallelism: every rank calls it."""
        if not self.tp_plan:
            return self.state
        plan, s = self.tp_plan, self.state
        return TrainState(
            step=s.step, params=tp.gather_params(s.params, plan),
            ema_params=tp.gather_params(s.ema_params, plan),
            opt_state=dataclasses.replace(s.opt_state,
                                          mu=tp.gather_params(s.opt_state.mu, plan),
                                          nu=tp.gather_params(s.opt_state.nu, plan)))

    def save_checkpoint(self, step: int) -> None:
        self.ckpt.save(step, self.full_state())

    # -- resume ------------------------------------------------------------
    def maybe_resume(self) -> Tuple[int, int]:
        """Returns (first_epoch, batches_to_skip_in_first_epoch)."""
        cfg = self.config
        if cfg.resume_from_checkpoint is None:
            return 0, 0
        step = None if cfg.resume_from_checkpoint == "latest" else int(cfg.resume_from_checkpoint)
        if self.tp_plan:  # the checkpoint holds the full tree: cut it again
            full = self.ckpt.restore(self.full_state(), step)
            self.state.load_state_dict(self._local_state(full).state_dict())
        else:
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
        save = False
        if mean_main is None:  # rank 0's view: another rank may look while it writes
            save = broadcast_object(not (os.path.isdir(save_dir) and os.listdir(save_dir)))
        elif is_it_best_model(mean_main, self.best_metric):
            self.best_metric, save = mean_main, True
        if save:
            full = self.full_state()
            if is_main():
                self.save_pipeline_fn(full, save_dir)
            barrier()

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
                # the global batch's draws, of which this process keeps its rows
                b, *rest = self.diffusion_shape(tuple(images.shape))
                world_shape = (b * data_size(), *rest)
                draws = make_draws(cfg.seed, self.state.step, world_shape, t_count, p_uncond,
                                   self.device, posterior=self.posterior
                                   ).rows(local_rows(world_shape[0]))
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
                    self.save_checkpoint(global_step)
                if cfg.eval_every_opti_steps and global_step % cfg.eval_every_opti_steps == 0:
                    self._flush_metrics(pending, timer)
                    self._run_eval(global_step)
                if cfg.max_train_steps and global_step >= cfg.max_train_steps:
                    done = True
                    break
                t_iter = time.perf_counter()
            self._flush_metrics(pending, timer)
            precise = (cfg.precise_first_n_epochs is not None
                       and epoch < cfg.precise_first_n_epochs)
            if precise or (cfg.eval_every_epochs and (epoch + 1) % cfg.eval_every_epochs == 0):
                self._run_eval(global_step)
            if done:
                break
        if cfg.save_final_checkpoint:
            self.save_checkpoint(global_step)
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
    make_mesh(config.model_parallel)
    with torch.device("meta"):  # structure only: functional_call brings the weights
        model = CondUNet2D(pipe.unet_config, dtype=policy.compute_torch, remat=config.remat)
    plan = tp.shard_module(model)
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
        tp_plan=plan,
        **kw,
    )


# components_to_train -> the trainable dict's prefix (the reference's naming:
# "denoiser" is the UNet, "autoencoder" the VAE)
_SD_COMPONENTS = {"denoiser": "unet", "class_embedding": "class_embedding",
                  "autoencoder": "vae"}


class _VAEPart(nn.Module):
    """The VAE under the name ``vae``, as the trainable dict prefixes it, its
    forward one of the latent helpers (``encode_to_latents``,
    ``decode_from_latents``), so ``functional_call`` runs it on given
    weights."""

    def __init__(self, vae: AutoencoderKL, fn: Callable):
        super().__init__()
        self.vae = vae
        self.fn = fn

    def forward(self, *args, **kw):
        return self.fn(self.vae, *args, **kw)


def for_sd_pipeline(pipe, config: TrainerConfig, paths: RunPaths,
                    components_to_train=("denoiser", "class_embedding"),
                    attention_fine_tuning: bool = False, **kw) -> Trainer:
    """A Trainer fine-tuning an ``SDImg2ImgPipeline`` (``sd_trainer_kwargs``)."""
    return Trainer(config, paths, **sd_trainer_kwargs(
        pipe, config, components_to_train, attention_fine_tuning), **kw)


def sd_trainer_kwargs(pipe, config: TrainerConfig,
                      components_to_train=("denoiser", "class_embedding"),
                      attention_fine_tuning: bool = False) -> dict:
    """The ``Trainer`` keyword arguments that fine-tune an
    ``SDImg2ImgPipeline`` on the latent diffusion loss: f32 master copies of
    the UNet (``unet.*``) and class embedding (``class_embedding.*``), the
    UNet in ``config.mixed_precision``'s compute dtype, the class row padded
    to the 77-token sequence.

    The batch is VAE-encoded in the step (the posterior sampled, times the
    scaling factor), in the VAE's own dtype.  Without ``"autoencoder"`` in
    ``components_to_train`` the VAE is frozen and encodes outside the
    gradient; with it its weights join the trainable dict (``vae.*``), the
    encode runs inside the gradient, and only ``encoder`` and
    ``quant_conv`` train: the decoder gets no gradient from this loss.
    ``attention_fine_tuning`` narrows the UNet's trainable parameters to its
    Transformer2D blocks and needs ``"denoiser"``.  Evaluation samples with
    the EMA weights (no copy of the pipeline) and decodes to [-1, 1]
    images; the pipeline save writes the EMA weights as an
    ``SDImg2ImgPipeline`` folder."""
    unknown = [c for c in components_to_train if c not in _SD_COMPONENTS]
    if unknown:
        raise ValueError(f"unknown components_to_train for the SD family: {unknown}; "
                         f"choose from {sorted(_SD_COMPONENTS)}")
    if attention_fine_tuning and "denoiser" not in components_to_train:
        raise ValueError("Attention fine tuning requires 'denoiser' to be trained")
    train_vae = "autoencoder" in components_to_train
    active = {_SD_COMPONENTS[c] for c in components_to_train}
    policy = Policy.from_mixed_precision(config.mixed_precision)
    ucfg, vcfg = pipe.unet_config, pipe.vae_config
    make_mesh(config.model_parallel)
    with torch.device("meta"):  # structure only: functional_call brings the weights
        unet = SDUNet(ucfg, dtype=policy.compute_torch, remat=config.remat)
        vae = AutoencoderKL(vcfg, dtype=pipe.vae.dtype)
    plan = tp.shard_module(unet, prefix="unet.")
    vae_encode, vae_decode = _VAEPart(vae, encode_to_latents), _VAEPart(vae, decode_from_latents)
    parts = {"unet": pipe.unet, "class_embedding": pipe.class_embedding}
    if train_vae:
        parts["vae"] = pipe.vae
    params = {f"{prefix}.{n}": p.detach().float().requires_grad_(p.requires_grad)
              for prefix, module in parts.items() for n, p in module.named_parameters()}
    unet_names = [n for n, _ in unet.named_parameters()]
    vae_names = [f"vae.{n}" for n, _ in pipe.vae.named_parameters()]
    table = "class_embedding.embedding.weight"

    def model_apply(p, x, t, class_seq):
        return functional_call(unet, {n: p[f"unet.{n}"] for n in unet_names}, (x, t, class_seq))

    def embed_fn(p, labels):
        return pad_to_clip_sequence(p[table][labels])

    if train_vae:
        def encode_fn(p, images, draws):
            return functional_call(vae_encode, {n: p[n] for n in vae_names}, (images,),
                                   {"noise": draws.enc_noise})
    else:
        def encode_fn(images, draws):
            return encode_to_latents(pipe.vae, images, noise=draws.enc_noise)

    def trainable_mask(p):
        mask = {}
        for n in p:
            prefix, _, rest = n.partition(".")
            on = prefix in active
            if prefix == "vae":  # the decoder gets no gradient from the loss
                on = rest.split(".")[0] in ("encoder", "quant_conv")
            mask[n] = on
        if attention_fine_tuning:
            attn = attention_param_mask(p)
            mask.update({n: attn[n] for n in p if n.startswith("unet.")})
        return mask

    down = 2 ** (len(vcfg.block_out_channels) - 1)  # the VAE's downsampling

    def diffusion_shape(shape):
        b, h, w, _ = shape
        return (b, h // down, w // down, vcfg.latent_channels)

    ev = config.eval

    def make_generate_fn(state: TrainState):
        """EMA-weight sampling from noise, decoded to [-1, 1] images."""
        ema = state.ema_params
        ema_unet = {n: ema[f"unet.{n}"] for n in unet_names}
        ema_vae = {n: ema[n] for n in vae_names} if train_vae else None

        def generate(labels, generator, num_inference_steps):
            seq = pad_to_clip_sequence(ema[table][labels])
            shape = (len(labels), ucfg.sample_size, ucfg.sample_size, ucfg.in_channels)
            with torch.no_grad():
                lat = ddim_sample(
                    lambda x, t, s: functional_call(unet, ema_unet, (x, t, s)), pipe.schedule,
                    seq, shape=shape, generator=generator,
                    num_inference_steps=num_inference_steps,
                    guidance=GuidanceConfig(ev.guidance_factor))
                if train_vae:
                    return functional_call(vae_decode, ema_vae, (lat,)).float()
                return decode_from_latents(pipe.vae, lat).float()

        return generate

    def save_pipeline_fn(state: TrainState, dirpath: str):
        def ema_module(module_fn, prefix):
            with torch.device("meta"):
                module = module_fn()
            # assign: the module takes the EMA tensors themselves, no copy
            module.load_state_dict({n[len(prefix) + 1:]: t.detach()
                                    for n, t in state.ema_params.items()
                                    if n.startswith(prefix + ".")}, assign=True)
            return module

        ce = pipe.class_embedding.embedding
        dataclasses.replace(
            pipe, unet=ema_module(lambda: SDUNet(ucfg, dtype=pipe.dtype), "unet"),
            class_embedding=ema_module(
                lambda: ClassEmbedding(ce.num_embeddings, ce.embedding_dim), "class_embedding"),
            vae=ema_module(lambda: AutoencoderKL(vcfg, dtype=pipe.vae.dtype), "vae")
            if train_vae else pipe.vae,
        ).save_pretrained(dirpath)

    return dict(
        model_apply=model_apply,
        embed_fn=embed_fn,
        trainable_params=params,
        schedule=pipe.schedule,
        save_pipeline_fn=save_pipeline_fn,
        make_generate_fn=make_generate_fn,
        trainable_mask=trainable_mask,
        encode_fn=encode_fn,
        encode_inside_grad=train_vae,
        diffusion_shape=diffusion_shape,
        device=pipe.device,
        tp_plan=plan,
    )
