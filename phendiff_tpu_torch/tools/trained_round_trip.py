"""The trained-model round trip: train ``super_small`` on the toy set, then
run ``reco_err`` and ``ddib_batch_gap`` on the weights it learned.

    python -m phendiff_tpu_torch.tools.trained_round_trip OUT
    python -m phendiff_tpu_torch.tools.trained_round_trip OUT --quick 100

The full run, on the card:

1. ``OUT/toy``: the 2-class toy set (``make_toy_dataset``, ``FULL_N`` images
   a class at ``FULL_RES`` px).
2. ``OUT/ddim_1k_invertible.json``: ``configs/noise_scheduler/ddim_1k_epsilon.json``
   with ``rescale_betas_zero_snr`` and ``clip_sample`` off, the invertible
   schedule of ``docs/SCHEDULER_PARITY.md``.
3. ``python -m phendiff_tpu_torch.cli.train_cli`` with
   ``examples/launch_train_ddim.sh``'s model, schedule, optimizer, guidance
   and precision flags, at ``FULL_BATCH`` for ``FULL_STEPS`` steps (the cosine
   decays over them), no metrics; the EMA pipeline is saved at the end.
4. ``reco_err --steps 50 --batch 16`` on the saved pipeline, then on a copy
   whose scheduler is the zero-terminal-SNR ``ddim_1k_epsilon.json`` (which
   fails by construction).
5. ``ddib_batch_gap --pipeline`` on the saved pipeline.

Writes ``OUT/summary.json`` (the final loss, seconds a phase, both
``reco_err`` lines and exit codes, the batch-gap record) and prints it.

``--quick STEPS`` is ``chip_smoke.py``'s reco phase (``quick_round_trip``)
at ``STEPS`` training steps: a short in-process ``Trainer`` run at 64 px,
then one 50-step round trip at batch 16 through the kernels.  It writes
``OUT/summary.json`` likewise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.models.config import super_small
from phendiff_tpu_torch.models.unet2d import CondUNet2D
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.tools import make_toy_dataset, reco_err
from phendiff_tpu_torch.tools.ddib_batch_gap import nvidia_smi

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ZERO_SNR = os.path.join(ROOT, "configs", "noise_scheduler", "ddim_1k_epsilon.json")
DENOISER = os.path.join(ROOT, "configs", "denoiser", "super_small.json")
# the round trip of the JAX record (docs/BENCHMARKS.md, "Trained-model
# inversion round trip"): 50 steps each way at batch 16
RT_STEPS, RT_BATCH = 50, 16
# the full run: the JAX record's 1920 steps on 256 toy images a class at
# 128 px, at a batch the card trains in minutes
FULL_STEPS, FULL_BATCH, FULL_RES, FULL_N = 1920, 64, 128, 256
# --quick: reco_err's default resolution (attention at S = 256), the train
# batch, toy images a class, and the peak lr of a run of a few hundred steps
QUICK_RES, QUICK_BATCH, QUICK_N, QUICK_LR = 64, 32, 64, 1e-3


def invertible_schedule() -> dict:
    """``ddim_1k_epsilon.json`` without zero-terminal-SNR rescaling and clipping."""
    with open(ZERO_SNR) as f:
        raw = json.load(f)
    raw.update(rescale_betas_zero_snr=False, clip_sample=False)
    return raw


def _run(cmd, log: str) -> int:
    with open(log, "w") as f:
        return subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT).returncode


def _last_json(log: str) -> dict:
    with open(log) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def _losses(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]


def full_run(out: str) -> dict:
    """The full run: the module's steps 1-5."""
    steps, batch, res, n = FULL_STEPS, FULL_BATCH, FULL_RES, FULL_N
    out = os.path.abspath(out)  # the subprocesses run from the repo's root
    os.makedirs(out, exist_ok=True)
    py = sys.executable
    rec = {"nvidia_smi": nvidia_smi(), "steps": steps, "batch": batch, "res": res,
           "images": 2 * n}
    t0 = time.perf_counter()
    make_toy_dataset.write(os.path.join(out, "toy"), n, res)
    sched = os.path.join(out, "ddim_1k_invertible.json")
    with open(sched, "w") as f:
        json.dump(invertible_schedule(), f, indent=2)
    epochs = -(-steps // (2 * n // batch))
    rec["toy_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rec["train_rc"] = _run([
        py, "-m", "phendiff_tpu_torch.cli.train_cli", "--run_name", "toy",
        "--model_type", "DDIM", "--train_data_dir", os.path.join(out, "toy"),
        "--exp_output_dirs_parent_folder", os.path.join(out, "exp"), "--experiment_name", "rt",
        "--denoiser_config_path", DENOISER, "--noise_scheduler_config_path", sched,
        "--definition", str(res), "--train_batch_size", str(batch),
        "--num_epochs", str(epochs), "--max_num_steps", str(steps),
        "--learning_rate", "1e-4", "--lr_scheduler", "cosine", "--lr_warmup_steps", "500",
        "--proba_uncond", "0.1", "--guidance_factor", "2.5",
        "--eval_save_model_every_epochs", str(epochs), "--no_compute_fid",
        "--checkpointing_steps", str(steps), "--checkpoints_total_limit", "1",
        "--mixed_precision", "bf16", "--metrics_flush_every", "50",
    ], os.path.join(out, "train.log"))
    rec["train_s"] = time.perf_counter() - t0
    run_dir = os.path.join(out, "exp", "rt", "toy")
    losses = _losses(run_dir)
    rec["final_loss"] = losses[-1] if losses else None
    rec["mean_loss_last_100"] = sum(losses[-100:]) / max(len(losses[-100:]), 1)
    pipe_dir = os.path.join(run_dir, "full_pipeline_save")

    zero_snr_dir = os.path.join(out, "pipeline_zero_snr")
    shutil.rmtree(zero_snr_dir, ignore_errors=True)
    shutil.copytree(pipe_dir, zero_snr_dir)
    shutil.copy(ZERO_SNR, os.path.join(zero_snr_dir, "scheduler", "config.json"))
    for tag, path in (("invertible", pipe_dir), ("zero_snr", zero_snr_dir)):
        t0 = time.perf_counter()
        log = os.path.join(out, f"reco_{tag}.log")
        rc = _run([py, "-m", "phendiff_tpu_torch.tools.reco_err", "--pipeline", path,
                   "--steps", str(RT_STEPS), "--batch", str(RT_BATCH), "--res", str(res)], log)
        rec[f"reco_{tag}"] = {"rc": rc, "result": _last_json(log),
                              "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    gap = os.path.join(out, "batch_gap.json")
    rc = _run([py, "-m", "phendiff_tpu_torch.tools.ddib_batch_gap", "--pipeline", pipe_dir,
               "--out", gap], os.path.join(out, "batch_gap.log"))
    rec["batch_gap"] = {"rc": rc, "seconds": time.perf_counter() - t0}
    if rc == 0:
        with open(gap) as f:
            rec["batch_gap"].update(json.load(f))
    return rec


def quick_round_trip(workdir: str, steps: int, device="cuda") -> dict:
    """Train ``super_small`` at ``QUICK_RES`` px for ``steps`` steps at batch
    ``QUICK_BATCH`` on a toy set of ``QUICK_N`` images a class (bf16, the
    invertible schedule, cosine lr from ``QUICK_LR`` after 10% warmup), then
    run one round trip of ``RT_STEPS`` steps at batch ``RT_BATCH`` on its EMA
    weights in float32.  Returns the round trip's summary
    (``reco_err.summarize`` at its threshold), the mean of the last 20
    losses and the seconds of each part."""
    from phendiff_tpu_torch.train.train_loop import OptimizerConfig, TrainConfig
    from phendiff_tpu_torch.train.trainer import RunPaths, TrainerConfig, for_ddim_pipeline

    res, lr = QUICK_RES, QUICK_LR
    t0 = time.perf_counter()
    data = os.path.join(workdir, f"toy{res}")
    if not os.path.isdir(data):
        make_toy_dataset.write(data, QUICK_N, res)
    sched = SchedulerConfig.from_json(invertible_schedule())
    pipe = ConditionalDDIMPipeline.init_random(super_small().replace(sample_size=res), sched,
                                               seed=0, dtype=torch.bfloat16, device=device)
    cfg = TrainerConfig(
        train_data_dir=data, definition=(res, res), train_batch_size=QUICK_BATCH,
        num_epochs=10**6, max_train_steps=steps, eval_every_epochs=None,
        checkpointing_steps=10**9, save_final_checkpoint=False, compute_metrics=False,
        mixed_precision="bf16", metrics_flush_every=10**6, tracker="none",
        train=TrainConfig(proba_uncond=0.1, optimizer=OptimizerConfig(
            learning_rate=lr, lr_scheduler="cosine", lr_warmup_steps=max(steps // 10, 1),
            total_steps=steps)))
    trainer = for_ddim_pipeline(pipe, cfg, RunPaths.create(workdir, "quick", f"steps{steps}"))
    losses = []
    step = trainer._step_fn

    def recording(*a):
        state, metrics = step(*a)
        losses.append(metrics["loss"])
        return state, metrics

    trainer._step_fn = recording
    t1 = time.perf_counter()
    state = trainer.run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    dev = torch.device(device)
    model = CondUNet2D(pipe.unet_config)
    model.load_state_dict({k: v.detach() for k, v in state.ema_params.items()})
    ema = ConditionalDDIMPipeline(pipe.unet_config, sched, model.to(dev))
    labels = torch.arange(RT_BATCH, device=dev) % 2
    noise = torch.randn((RT_BATCH, res, res, 3), generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    x, z, recon = reco_err.round_trip(ema, labels, noise, RT_STEPS)
    summary = reco_err.summarize(x, z, recon, 0.05)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    tail = torch.stack(losses[-20:]).float().mean() if losses else torch.tensor(float("nan"))
    return {"steps": steps, "train_batch": QUICK_BATCH, "res": res, "lr": lr,
            "loss_last_20": float(tail), "summary": summary,
            "finite": bool(torch.isfinite(x).all() and torch.isfinite(z).all()
                           and torch.isfinite(recon).all()),
            "setup_s": t1 - t0, "train_s": t2 - t1, "round_trip_s": t3 - t2}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--quick", type=int, default=None, metavar="STEPS",
                    help="chip_smoke.py's reco phase at STEPS training steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trained_round_trip needs a CUDA card")
    if args.quick:
        os.makedirs(args.out, exist_ok=True)
        rec = {"nvidia_smi": nvidia_smi(), **quick_round_trip(args.out, args.quick)}
    else:
        rec = full_run(args.out)
    line = json.dumps(rec)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return rec


if __name__ == "__main__":
    main()
