"""Training CLI flag surface.

Counterpart of ``phendiff_tpu/cli/args.py``, flag for flag, so a command
line parses on both packages: the reference's argparse interface, the
cross-flag invariants of its ``args_checker`` and the debug-mode
downscaling of ``modify_args_for_debug``.

Flags that exist for the TPU's compile transport or for the JAX package's
parallelism keep their names and choices; ``cli/train_cli.py`` maps them:
``--segmented_sd auto|off`` take the one-program step (eager PyTorch has no
transport limit), ``--segmented_sd on`` the per-stage route
(``train/segmented_trainer.py``, with ``--segmented_clip_mode``), and
``--adam_moment_dtype`` is ``OptimizerConfig.moment_dtype`` (f32 moments
on the segmented route whatever it says, as in the JAX package);
``--model_parallel`` is the tensor-parallel model axis (``parallel/tp.py``).
``--device`` is the port's own: the torch device to train on (the card
unless it names another); under ``torchrun`` (``WORLD_SIZE > 1``)
``process_device`` joins the process group and ``cuda`` means
``cuda:{LOCAL_RANK}``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from phendiff_tpu_torch.core.device import resolve_device
from phendiff_tpu_torch.parallel.mesh import init_distributed

# DiT (models/dit.py) has no JAX counterpart: its pipelines run the
# comparison, and training refuses it (check_args)
MODEL_TYPES = ("DDIM", "StableDiffusion", "DiT")
COMPONENTS = ("denoiser", "autoencoder", "class_embedding")
PREDICTION_TYPES = ("epsilon", "sample", "v_prediction")


def process_device(device: Optional[str]) -> torch.device:
    """The device of this process: under ``torchrun`` (``WORLD_SIZE > 1``)
    it joins the data-parallel group (``parallel.mesh.init_distributed``:
    ``cuda`` is ``cuda:{LOCAL_RANK}``), else ``device`` as given."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return init_distributed(device)
    return resolve_device(device)


def parse_definition(value: str):
    """int or 'h,w' tuple (reference definition flag semantics)."""
    if "," in value:
        h, w = value.split(",")
        return (int(h), int(w))
    v = int(value)
    return (v, v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "phendiff-train", description="Train class-conditional diffusion models on the GPU"
    )
    # experiment naming / dirs
    p.add_argument("--exp_output_dirs_parent_folder", type=str, default="experiments")
    p.add_argument("--experiment_name", "--project", dest="experiment_name",
                   type=str, default="phendiff-tpu",
                   help="experiment-specific folder (and tracker project) name")
    p.add_argument("--run_name", type=str, required=True)
    # model selection
    p.add_argument("--model_type", type=str, choices=MODEL_TYPES, required=True)
    p.add_argument(
        "--components_to_train", nargs="+", choices=COMPONENTS,
        default=["denoiser"],
    )
    p.add_argument("--attention_fine_tuning", action="store_true",
                   help="fine-tune attention layers only")
    p.add_argument("--segmented_sd", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="the per-stage route for the SD family (one stage's "
                        "gradients alive at a time): 'on' takes it; 'auto' and "
                        "'off' take the one-program step")
    p.add_argument("--segmented_clip_mode", type=str, default="recompute",
                   choices=("recompute", "cache", "cache_bf16"),
                   help="global-grad-clip scheme of the segmented route: two "
                        "backward chains, or one with the gradients cached (in "
                        "f32, or bf16)")
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None)
    p.add_argument("--learn_denoiser_from_scratch", action="store_true",
                   help="keep the pretrained pipeline's config/VAE but "
                        "re-initialize the denoiser weights")
    p.add_argument("--revision", type=str, default=None,
                   help="accepted for interface parity; pretrained loads are "
                        "local directories here (zero-egress)")
    p.add_argument("--denoiser_config_path", type=str, default=None)
    p.add_argument("--noise_scheduler_config_path", type=str, default=None)
    # data — local imagefolder OR a HuggingFace dataset
    p.add_argument("--train_data_dir", type=str, default=None)
    p.add_argument("--dataset_name", type=str, default=None,
                   help="HF dataset (local arrow/imagefolder path or hub id)")
    p.add_argument("--dataset_config_name", type=str, default=None)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--perc_samples", type=float, default=100.0)
    p.add_argument("--definition", type=parse_definition, default=(128, 128))
    p.add_argument("--data_aug_on_the_fly", action="store_true", default=True)
    p.add_argument("--no_data_aug_on_the_fly", dest="data_aug_on_the_fly",
                   action="store_false")
    # batch / schedule
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--eval_batch_size", type=int, default=16)
    p.add_argument("--max_num_epochs", "--num_epochs", dest="num_epochs",
                   type=int, default=100)
    p.add_argument("--max_num_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    # eval cadence
    p.add_argument("--eval_save_model_every_epochs", type=int, default=None)
    p.add_argument("--eval_save_model_every_opti_steps", type=int, default=None)
    p.add_argument("--precise_first_n_epochs", type=int, default=None,
                   help="additionally evaluate every epoch during the first "
                        "n epochs")
    p.add_argument("--compute_metrics_full_dataset", action="store_true",
                   default=True,
                   help="metrics vs the full (non-subsampled) dataset")
    p.add_argument("--no_compute_metrics_full_dataset",
                   dest="compute_metrics_full_dataset", action="store_false")
    p.add_argument("--nb_generated_images", type=int, default=1000)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--compute_fid", action="store_true", default=True)
    p.add_argument("--no_compute_fid", dest="compute_fid", action="store_false")
    p.add_argument("--compute_isc", action="store_true")
    p.add_argument("--compute_kid", action="store_true")
    p.add_argument("--kid_subset_size", type=int, default=1000)
    p.add_argument("--main_metric", type=str, default="fid",
                   choices=("fid", "isc", "kid"))
    # CFG
    p.add_argument("--guidance_factor", type=float, default=0.0)
    p.add_argument("--proba_uncond", type=float, default=0.0)
    p.add_argument("--class_embedding_dim", type=int, default=1024)
    # optimizer
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--lr_scheduler", type=str, default="constant",
                   choices=("constant", "constant_with_warmup", "linear",
                            "cosine", "polynomial"))
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    # Adam's first-moment dtype (OptimizerConfig.moment_dtype); the second
    # moment and the master parameters stay f32.
    p.add_argument("--adam_moment_dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"))
    # EMA
    p.add_argument("--use_ema", action="store_true", default=True)
    p.add_argument("--no_use_ema", dest="use_ema", action="store_false")
    p.add_argument("--ema_inv_gamma", type=float, default=1.0)
    p.add_argument("--ema_power", type=float, default=0.75)
    p.add_argument("--ema_max_decay", type=float, default=0.9999)
    # precision / memory
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=("no", "fp16", "bf16"))
    p.add_argument("--remat", action="store_true",
                   help="rematerialize UNet blocks in backward (memory vs speed)")
    p.add_argument("--metrics_flush_every", type=int, default=1,
                   help="read train metrics back every N steps in one host "
                        "fetch (every step is still logged, NaN alerts lag "
                        "<N)")
    p.add_argument("--upload_uint8", action="store_true",
                   help="ship training batches as uint8 and normalize on "
                        "device (4x fewer host-to-device bytes; same "
                        "post-resize uint8 quantization as torchvision's "
                        "Resize+ToTensor in the reference)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallelism of the JAX package; only 1 is "
                        "ported")
    # diffusion
    p.add_argument("--prediction_type", type=str, default=None,
                   choices=PREDICTION_TYPES)
    p.add_argument("--num_train_timesteps", type=int, default=None)
    p.add_argument("--beta_start", type=float, default=None)
    p.add_argument("--beta_end", type=float, default=None)
    p.add_argument("--beta_schedule", type=str, default=None)
    # checkpointing
    p.add_argument("--checkpointing_steps", type=int, default=1000)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    # misc
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tracker", type=str, default="jsonl",
                   choices=("jsonl", "wandb", "none"))
    p.add_argument("--logger", type=str, default=None,
                   help="reference alias: 'wandb' selects the wandb tracker")
    p.add_argument("--wandb_entity", type=str, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to train on (default: the card)")
    # -- torch/accelerate-mechanics flags: accepted so reference launch
    # scripts keep working; mapped or warned as no-ops by check_args.
    p.add_argument("--dataloader_num_workers", type=int, default=None)
    p.add_argument("--dataloader_prefetch_factor", type=int, default=None)
    p.add_argument("--persistent_workers", action="store_true", default=None)
    p.add_argument("--pin_memory", action="store_true", default=None)
    p.add_argument("--use_pytorch_loader", action="store_true", default=True)
    p.add_argument("--local_rank", type=int, default=None)
    # -- hub publishing: no-ops in a zero-egress deployment
    p.add_argument("--push_to_hub", action="store_true")
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--hub_private_repo", action="store_true")
    p.add_argument("--hub_token", type=str, default=None)
    return p


MAIN_METRIC_NAMES = {
    "fid": "frechet_inception_distance",
    "isc": "inception_score_mean",
    "kid": "kernel_inception_distance_mean",
}


def check_args(args) -> List[str]:
    """Cross-flag invariants (the reference's ``args_checker``, minus
    torch-only ones); returns a list of warnings, raises ValueError on hard
    errors."""
    warnings: List[str] = []

    if args.model_type == "DiT":
        raise ValueError(
            "training a DiT is not supported: its learned-sigma loss (the variational "
            "bound term) and the D = 72 attention backward are not ported; a DiT "
            "pipeline folder runs the class-transfer comparison (cli/img2img_cli.py)")

    # data source (args_checker :80-84)
    if args.dataset_name is None and args.train_data_dir is None:
        raise ValueError(
            "You must specify either a dataset name (--dataset_name) or a "
            "train data directory (--train_data_dir)."
        )

    # CFG activation conditions (:86-96)
    if args.guidance_factor is not None and args.guidance_factor <= 1:
        warnings.append(
            "guidance_factor <= 1: CFG will not be performed under the "
            "Imagen guidance equation"
            + ("" if args.guidance_factor > 0
               else " (nor under the CFG-paper equation)")
        )

    # fully-unconditional training (:97-109)
    if not 0 <= args.proba_uncond <= 1:
        raise ValueError("proba_uncond must be in [0,1]")
    if args.proba_uncond == 1:
        warnings.append(
            "proba_uncond == 1: the model will be trained unconditionally"
        )
        if args.model_type == "DDIM" and args.guidance_factor:
            raise ValueError(
                "guidance must be disabled (0) for unconditional training"
            )
        if args.model_type == "StableDiffusion":
            raise NotImplementedError(
                "unconditional StableDiffusion training is not supported "
                "(reference parity: utils_misc.py:106-108)"
            )
    if args.proba_uncond > 0 and not args.guidance_factor:
        warnings.append(
            "training with CFG dropout but guidance_factor=0 at eval"
        )

    # KID needs enough generated samples (:115-123); debug shrinks both
    if (
        args.compute_kid
        and args.nb_generated_images < args.kid_subset_size
        and not args.debug
    ):
        raise ValueError(
            f"nb_generated_images (={args.nb_generated_images}) must be >= "
            f"kid_subset_size (={args.kid_subset_size})"
        )

    if args.gradient_accumulation_steps != 1:
        # hard error in the reference too (:123-124)
        raise ValueError("gradient accumulation is not supported")

    # component/model compatibility (:131-144)
    if args.model_type == "DDIM":
        if "autoencoder" in args.components_to_train:
            raise ValueError("DDIM has no autoencoder component")
        if "class_embedding" in args.components_to_train:
            raise ValueError(
                "DDIM's class embedding lives inside the denoiser; train 'denoiser'"
            )

    # attention fine-tuning can only apply on top of a trained denoiser
    # (reference train.py:202-220 raises the same two errors)
    if args.attention_fine_tuning and "denoiser" not in args.components_to_train:
        raise ValueError(
            "Attention fine tuning requires 'denoiser' to be trained "
            "(set --components_to_train)"
        )

    # pretrained vs config exclusivity (:146-168)
    if (
        args.pretrained_model_name_or_path is not None
        and args.denoiser_config_path is not None
        and not args.learn_denoiser_from_scratch
    ):
        raise ValueError(
            "cannot set both pretrained_model_name_or_path and "
            "denoiser_config_path (unless --learn_denoiser_from_scratch)"
        )
    if args.model_type == "StableDiffusion":
        if args.pretrained_model_name_or_path is None:
            raise ValueError("StableDiffusion requires --pretrained_model_name_or_path")
    if args.model_type == "DDIM" and args.pretrained_model_name_or_path is None:
        if args.denoiser_config_path is None:
            raise ValueError(
                "if not using a pretrained model, a denoiser config must be "
                "provided (--denoiser_config_path)"
            )
        if args.noise_scheduler_config_path is None:
            warnings.append(
                "no --noise_scheduler_config_path: using the default DDIM "
                "schedule (the reference requires an explicit config here)"
            )

    # subsampling (:170-178)
    if args.perc_samples is not None and not 0 < args.perc_samples <= 100:
        raise ValueError("perc_samples must be in ]0; 100]")

    # run-length and eval cadence must be bounded (:180-188)
    if args.num_epochs is None and args.max_num_steps is None:
        raise ValueError("either max_num_epochs or max_num_steps must be set")
    if (
        args.eval_save_model_every_epochs is None
        and args.eval_save_model_every_opti_steps is None
    ):
        raise ValueError(
            "either --eval_save_model_every_epochs or "
            "--eval_save_model_every_opti_steps must be set (the reference "
            "asserts the same; --debug sets a cadence automatically)"
        )

    # tensor parallelism (make_mesh raises where it does not divide the world)
    if args.model_parallel < 1:
        raise ValueError("--model_parallel must be >= 1")

    # metric selection consistency
    if args.main_metric == "isc" and not args.compute_isc:
        raise ValueError("main_metric isc requires --compute_isc")
    if args.main_metric == "kid" and not args.compute_kid:
        raise ValueError("main_metric kid requires --compute_kid")

    # torch/accelerate-mechanics flags: map or warn (docstring contract)
    if args.mixed_precision == "fp16":
        warnings.append("fp16 mapped to bf16 (no loss scaling needed)")
    if args.logger == "wandb" and args.tracker != "wandb":
        args.tracker = "wandb"
        warnings.append("--logger wandb mapped to --tracker wandb")
    if args.dataloader_num_workers is not None:
        warnings.append(
            "--dataloader_num_workers ignored (loader uses a prefetch "
            "thread + native batch kernels)"
        )
    for flag in ("persistent_workers", "pin_memory", "local_rank"):
        if getattr(args, flag) is not None:
            warnings.append(f"--{flag} ignored (torch/accelerate mechanics)")
    if args.push_to_hub or args.hub_model_id or args.hub_token:
        warnings.append(
            "hub publishing flags are no-ops in this zero-egress deployment"
        )
    if args.revision is not None:
        warnings.append(
            "--revision ignored: pretrained paths are local directories"
        )
    return warnings


def modify_args_for_debug(args) -> None:
    """Debug downscaling (the reference's): a minutes-scale smoke run."""
    args.num_train_timesteps = 10
    args.num_inference_steps = 5
    args.eval_save_model_every_epochs = 1
    args.eval_save_model_every_opti_steps = 10
    args.num_epochs = 3
    args.max_num_steps = 30
    args.checkpointing_steps = 10
    args.nb_generated_images = min(args.nb_generated_images, 16)
    args.kid_subset_size = min(1000, args.nb_generated_images)
