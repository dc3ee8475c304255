"""Why an f32 DDIB transfer of some rows changes with the batch they run in.

``chip_smoke.py``'s dp phase holds the world-2 comparison against world 1 at
the ranks' batch of 16, not at the global batch of 32, because the same rows
transferred at batch 16 and at batch 32 differ visibly in f32 on the card.
This tool measures where that gap comes from, on the DDIM ``super_small``
pipeline from seed 0 (f32, TF32 off) and the comparison's first batch: 32
random 128 px images drawn as ``chip_smoke.py``'s image folder draws them,
class 0 to class 1, 10 steps (10 inversion and 10 generation calls).

* ``call``: one denoiser call at batch 32 against its first 16 rows at batch
  16 (max abs and relative L2 of the model output): the only place where
  the batch enters the arithmetic.
* ``batch``: the state before each of DDIB's 20 denoiser calls and the
  output, batch 16 against the first 16 rows of batch 32 (max abs of each).
* ``ulp``: the same trajectory at batch 16, between the images and the
  images moved one ulp up (``torch.nextafter``): no batch change, a
  difference of rounding size at the input only.
* ``deterministic``: ``batch`` again under cuDNN's deterministic algorithms.
* ``cpu`` (``--cpu-rows N``): ``batch`` and ``ulp`` on the CPU at N rows
  against 2N, no cuDNN.

Where ``ulp`` grows to the size of ``batch``, the transfer amplifies
rounding-size differences, and the batch gap is rounding; a batch gap
already large at one call would be a fault instead.  ``--pipeline DIR``
measures a saved pipeline (trained weights, its own schedule) in place of
the random one; its images are drawn at its own resolution.  Prints one
JSON line with the card's name and power limit; ``--out`` also writes it
to a file.

    python -m phendiff_tpu_torch.tools.ddib_batch_gap [--pipeline DIR] [--out FILE] [--cpu-rows 2]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.models.config import super_small
from phendiff_tpu_torch.pipelines import transfer as T
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline

SEED, RES, BATCH, STEPS = 0, 128, 32, 10


def first_batch(res: Optional[int] = None) -> np.ndarray:
    """The first ``BATCH`` images of ``chip_smoke.py``'s folder (class 0) at
    ``res`` px, in [-1, 1]: uint8 pixels from ``default_rng(SEED)``, lossless
    as PNGs."""
    res = res or RES
    rng = np.random.default_rng(SEED)
    pixels = np.stack([rng.integers(0, 255, (res, res, 3), dtype=np.uint8)
                       for _ in range(BATCH)])
    return pixels.astype(np.float32) / 127.5 - 1.0


@torch.no_grad()
def trajectory(pipe, images: torch.Tensor) -> list:
    """The state before each denoiser call of a DDIB class 0 -> 1, then the
    output."""
    denoiser, states = pipe.denoiser_fn(), []

    def recording(x, t, emb):
        states.append(x.clone())
        return denoiser(x, t, emb)

    labels = torch.zeros(len(images), dtype=torch.int64, device=images.device)
    out = T.ddib(recording, pipe.schedule, images, pipe.class_embeddings(labels),
                 pipe.class_embeddings(labels + 1), num_inference_steps=STEPS)
    return states + [out]


def gaps(a: list, b: list) -> list:
    """Max abs difference of each state, ``a``'s rows against ``b``'s first."""
    return [float((x - y[:len(x)]).abs().max()) for x, y in zip(a, b)]


def report(g: list) -> dict:
    """A trajectory of gaps: each call's, and the output's on [0, 1]."""
    return {"per_call_max_abs": g[:-1], "output_max_abs_01": g[-1] / 2.0}


@torch.no_grad()
def one_call(pipe, images: torch.Tensor, half: int) -> dict:
    denoiser = pipe.denoiser_fn()
    t0 = int(T.ddib_rows(pipe.schedule.config, STEPS)[0, 0])
    labels = torch.zeros(len(images), dtype=torch.int64, device=images.device)
    emb = pipe.class_embeddings(labels)
    t = torch.full((len(images),), t0, dtype=torch.int64, device=images.device)
    full = denoiser(images, t, emb)[:half]
    part = denoiser(images[:half], t[:half], emb[:half])
    return {"t": t0, "max_abs": float((full - part).abs().max()),
            "rel_l2": float((full - part).norm() / full.norm())}


def load(device: torch.device, pipeline: Optional[str] = None) -> ConditionalDDIMPipeline:
    """The saved pipeline at ``pipeline``, else the seed-``SEED`` random one."""
    if pipeline:
        return ConditionalDDIMPipeline.from_pretrained(pipeline, device=device)
    return ConditionalDDIMPipeline.init_random(super_small(), SchedulerConfig(), seed=SEED,
                                               device=device)


def witness(device: torch.device, images: Optional[np.ndarray], half: int,
            pipeline: Optional[str] = None) -> dict:
    pipe = load(device, pipeline)
    if images is None:
        images = first_batch(pipe.unet_config.sample_size)
    x = torch.from_numpy(images[:2 * half]).to(device)
    full, part = trajectory(pipe, x), trajectory(pipe, x[:half])
    nudged = trajectory(pipe, torch.nextafter(x[:half], torch.tensor(np.inf, device=device)))
    return {"rows": [half, 2 * half], "call": one_call(pipe, x, half),
            "batch": report(gaps(part, full)), "ulp": report(gaps(nudged, part)),
            "_pipe": pipe, "_x": x}


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", default=None, help="a saved ConditionalDDIMPipeline folder")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu-rows", type=int, default=2,
                    help="rows of the CPU witness (0: none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ddib_batch_gap needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = witness(torch.device("cuda"), None, BATCH // 2, args.pipeline)
    pipe, x = card.pop("_pipe"), card.pop("_x")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    card["deterministic"] = report(gaps(trajectory(pipe, x[:BATCH // 2]), trajectory(pipe, x)))
    torch.backends.cudnn.deterministic = False
    rec = {"tool": "ddib_batch_gap", "device": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi(), "pipeline": args.pipeline, "steps": STEPS,
           "card": card}
    if args.cpu_rows:
        cpu = witness(torch.device("cpu"), None, args.cpu_rows, args.pipeline)
        cpu.pop("_pipe"), cpu.pop("_x")
        rec["cpu"] = cpu
    rec["seconds"] = time.perf_counter() - t0
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
