"""Reconstruction-error check of a DDIM pipeline: the north-star numerics
check.

Counterpart of ``tools/reco_err.py``, flag for flag: sample images from a
pipeline, DDIM-invert them, check that the latents are ~N(0, 1),
regenerate from the latents with the same classes, and report each image's
relative reconstruction error ``mean((recon - x)^2) / max(mean(x^2), 1e-8)``.

    python -m phendiff_tpu_torch.tools.reco_err [--pipeline DIR] [--steps 50] [--batch 8]
        [--res 64] [--threshold 0.05] [--cpu]

Without ``--pipeline`` the pipeline is a seed-0 random ``super_small`` at
``--res`` with a trailing, unclipped 1000-step schedule.  Runs on the card
(and raises without one) unless ``--cpu`` is given.  On the card it prints
the card's name and power limit on a line of its own, then one JSON line
(``metric``, ``mean``, ``max``, ``latent_stats``, ``steps``, ``batch``,
``pass``); the exit code is 0 when the mean error is under the threshold,
else 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from phendiff_tpu_torch.core.device import resolve_device
from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.models.config import super_small
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.pipelines.transfer import check_gaussianity
from phendiff_tpu_torch.tools.ddib_batch_gap import nvidia_smi

METRIC = "inversion_reco_rel_err"


@torch.no_grad()
def round_trip(pipe: ConditionalDDIMPipeline, labels: torch.Tensor,
               start_noise: torch.Tensor, steps: int):
    """``(x, z, recon)``: images sampled from ``start_noise``, their DDIM
    inversion under ``labels``, and the images regenerated from it."""
    x = pipe.generate(labels, None, start_image=start_noise, num_inference_steps=steps)
    z = pipe.invert(x, labels, num_inference_steps=steps)
    recon = pipe.generate(labels, None, start_image=z, num_inference_steps=steps)
    return x, z, recon


def rel_errors(x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """Each image's ``mean((recon - x)^2) / max(mean(x^2), 1e-8)``, on the CPU."""
    dims = tuple(range(1, x.ndim))
    return (((recon - x) ** 2).mean(dim=dims)
            / torch.clamp((x ** 2).mean(dim=dims), min=1e-8)).cpu()


def summarize(x: torch.Tensor, z: torch.Tensor, recon: torch.Tensor,
              threshold: float) -> dict:
    """The tool's statistics of one round trip (without ``steps``)."""
    err = rel_errors(x, recon)
    return {
        "metric": METRIC,
        "mean": float(err.mean()),
        "max": float(err.max()),
        "latent_stats": {k: float(v) for k, v in check_gaussianity(z).items()},
        "batch": int(x.shape[0]),
        "pass": bool(err.mean() < threshold),
    }


def load_pipeline(path: Optional[str], res: int, device) -> ConditionalDDIMPipeline:
    if path:
        return ConditionalDDIMPipeline.from_pretrained(path, device=device)
    return ConditionalDDIMPipeline.init_random(
        super_small().replace(sample_size=res),
        SchedulerConfig(clip_sample=False, timestep_spacing="trailing"), seed=0, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pipeline", default=None, help="pretrained pipeline dir")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--threshold", type=float, default=0.05,
                   help="max allowed mean relative reconstruction error")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    pipe = load_pipeline(args.pipeline, args.res, device)
    n_cls = pipe.num_classes or 2
    labels = torch.arange(args.batch, device=device) % n_cls
    res, ch = pipe.unet_config.sample_size, pipe.unet_config.in_channels
    noise = torch.randn((args.batch, res, res, ch),
                        generator=torch.Generator(device).manual_seed(0), device=device)
    s = summarize(*round_trip(pipe, labels, noise, args.steps), args.threshold)
    result = {k: s[k] for k in ("metric", "mean", "max", "latent_stats")}
    result.update(steps=args.steps, batch=s["batch"], **{"pass": s["pass"]})
    if device.type == "cuda":
        print(nvidia_smi())
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
