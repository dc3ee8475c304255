"""``python -m phendiff_tpu_torch.cli.train_cli`` -- the training entry point.

Counterpart of ``phendiff_tpu/cli/train_cli.py``: parse args -> debug
downscaling -> validate -> run-dir structure -> pipeline factory -> trainer
-> epoch loop with eval and checkpoints, on the card unless ``--device``
names another.  Under ``torchrun`` (``WORLD_SIZE > 1``) each process joins
the process group and trains on ``cuda:{LOCAL_RANK}`` (``parallel/mesh.py``),
data-parallel, or with ``--model_parallel N`` tensor-parallel over groups
of N consecutive ranks (``parallel/tp.py``); ``--train_batch_size`` is the
global batch.  Both
families: DDIM from JSON configs or a pretrained folder
(``for_ddim_pipeline``), StableDiffusion fine-tuned from a pretrained
folder (``for_sd_pipeline``).

What the JAX package runs and the port does not yet: ``--segmented_sd on``
(its per-stage route, a later slice; ``auto`` and ``off`` take the
one-program step, which eager PyTorch always can) raises
``NotImplementedError`` naming its slice, as ``--adam_moment_dtype
bfloat16`` does.  ``--model_parallel > 1`` with ``--segmented_sd on`` is
refused as the JAX CLI refuses it.
``--dataset_name`` trains from an HF dataset (``data/hf_datasets.py``);
``--tracker wandb`` logs to wandb, or to JSONL where ``wandb`` is not
installed.
"""

from __future__ import annotations

import sys

import torch

from phendiff_tpu_torch.cli.args import (
    MAIN_METRIC_NAMES,
    build_parser,
    check_args,
    modify_args_for_debug,
    process_device,
)
from phendiff_tpu_torch.cli.factory import load_initial_pipeline
from phendiff_tpu_torch.core.precision import Policy
from phendiff_tpu_torch.metrics.fidelity import MetricsConfig
from phendiff_tpu_torch.obs.logging_utils import setup_logger
from phendiff_tpu_torch.parallel.mesh import data_size, is_main
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.train.ema import EMAConfig
from phendiff_tpu_torch.train.eval_loop import EvalConfig
from phendiff_tpu_torch.train.train_loop import OptimizerConfig, TrainConfig
from phendiff_tpu_torch.train.trainer import (
    RunPaths,
    TrainerConfig,
    for_ddim_pipeline,
    for_sd_pipeline,
)


def not_ported(flag: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{flag} is not ported to phendiff_tpu_torch yet "
                               f"(ROADMAP.md Queue 1: {item})")


def banner(args, warnings, device: torch.device):
    """Run-start summary."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    print("=" * 70)
    print(f" phendiff-tpu-torch train :: {args.run_name}")
    print(f"   model_type={args.model_type} components={args.components_to_train}")
    print(f"   data={args.dataset_name or args.train_data_dir} definition={args.definition} "
          f"perc={args.perc_samples}%")
    print(f"   batch={args.train_batch_size} epochs={args.num_epochs} "
          f"lr={args.learning_rate} precision={args.mixed_precision} remat={args.remat}")
    tp = f", model_parallel={args.model_parallel}" if args.model_parallel > 1 else ""
    print(f"   devices={data_size()} ({name}){tp}")  # one process a card, before make_mesh
    for w in warnings:
        print(f"   WARNING: {w}")
    print("=" * 70)


def trainer_config_from_args(args) -> TrainerConfig:
    if (args.model_parallel > 1 and args.model_type == "StableDiffusion"
            and args.segmented_sd == "on"):
        raise NotImplementedError(
            "tensor parallelism (--model_parallel > 1) is not supported on the segmented "
            "route (per-stage single-card programs); use --segmented_sd off")
    if args.adam_moment_dtype != "float32":
        raise NotImplementedError("--adam_moment_dtype bfloat16: the port keeps Adam's "
                                  "moments in float32")
    return TrainerConfig(
        train_data_dir=args.train_data_dir,
        dataset_name=args.dataset_name,
        dataset_config_name=args.dataset_config_name,
        split=args.split,
        cache_dir=args.cache_dir,
        definition=tuple(args.definition),
        perc_samples=args.perc_samples,
        compute_metrics_full_dataset=args.compute_metrics_full_dataset,
        seed=args.seed,
        data_aug_on_the_fly=args.data_aug_on_the_fly,
        loader_prefetch=args.dataloader_prefetch_factor or 2,
        train_batch_size=args.train_batch_size,
        num_epochs=args.num_epochs,
        max_train_steps=args.max_num_steps,
        eval_every_epochs=args.eval_save_model_every_epochs,
        eval_every_opti_steps=args.eval_save_model_every_opti_steps,
        precise_first_n_epochs=args.precise_first_n_epochs,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        resume_from_checkpoint=args.resume_from_checkpoint,
        mixed_precision=args.mixed_precision,
        remat=args.remat,
        metrics_flush_every=args.metrics_flush_every,
        upload_uint8=args.upload_uint8,
        model_parallel=args.model_parallel,
        compute_metrics=args.compute_fid or args.compute_isc or args.compute_kid,
        train=TrainConfig(
            proba_uncond=args.proba_uncond,
            ema=EMAConfig(
                inv_gamma=args.ema_inv_gamma,
                power=args.ema_power,
                max_decay=args.ema_max_decay,
            ),
            optimizer=OptimizerConfig(
                learning_rate=args.learning_rate,
                adam_beta1=args.adam_beta1,
                adam_beta2=args.adam_beta2,
                adam_weight_decay=args.adam_weight_decay,
                adam_epsilon=args.adam_epsilon,
                max_grad_norm=args.max_grad_norm,
                lr_scheduler=args.lr_scheduler,
                lr_warmup_steps=args.lr_warmup_steps,
                total_steps=args.max_num_steps or 100_000,
            ),
        ),
        eval=EvalConfig(
            nb_generated_images=args.nb_generated_images,
            eval_batch_size=args.eval_batch_size,
            num_inference_steps=args.num_inference_steps,
            guidance_factor=args.guidance_factor,
            main_metric=MAIN_METRIC_NAMES[args.main_metric],
            metrics=MetricsConfig(
                fid=args.compute_fid,
                isc=args.compute_isc,
                kid=args.compute_kid,
                kid_subset_size=args.kid_subset_size,
            ),
            unconditional=args.proba_uncond >= 1.0,
        ),
        tracker=args.tracker,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # debug downscaling first: it sets an eval cadence and shrinks
    # nb_generated_images, both of which check_args validates
    if args.debug:
        modify_args_for_debug(args)
    warnings = check_args(args)
    config = trainer_config_from_args(args)
    if args.model_type == "StableDiffusion" and args.segmented_sd == "on":
        raise not_ported("--segmented_sd on", "item 6, slice 2: the stage-per-device SD route")
    device = process_device(args.device)
    setup_logger("phendiff_tpu_torch", main_process_only=True)
    if is_main():
        banner(args, warnings, device)

    policy = Policy.from_mixed_precision(args.mixed_precision)
    pipeline = load_initial_pipeline(args, dtype=policy.compute_torch, device=device)
    paths = RunPaths.create(args.exp_output_dirs_parent_folder, args.experiment_name,
                            args.run_name)
    if isinstance(pipeline, ConditionalDDIMPipeline):
        trainer = for_ddim_pipeline(pipeline, config, paths,
                                    attention_fine_tuning=args.attention_fine_tuning)
    else:
        trainer = for_sd_pipeline(pipeline, config, paths,
                                  components_to_train=tuple(args.components_to_train),
                                  attention_fine_tuning=args.attention_fine_tuning)
    state = trainer.run()
    trainer.tracker.finish()
    if is_main():
        print(f"done: {state.step} steps; best {config.eval.main_metric} = "
              f"{trainer.best_metric}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
