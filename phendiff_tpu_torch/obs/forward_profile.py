"""Device-time breakdown of the main path's UNet forward.

    python -m phendiff_tpu_torch.obs.forward_profile [--batch 32] [--forwards 5]

Builds the ``super_small`` 128 px pipeline (random weights, seed 0, bf16
compute), warms up, then traces ``--forwards`` denoiser calls with
``torch.profiler`` and prints one JSON object: the device time per forward
of each kernel category (the two hand-written kernels, convolutions,
matrix products, elementwise and copy kernels), the top kernels by device
time, the wall time per forward and the device's idle share of it.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# Kernel-name fragments -> category, first match wins.
_CATEGORIES = (
    ("flash_attn_fwd", ("flash_fwd_kernel",)),
    ("group_norm_silu", ("gn_stats", "gn_finalize", "gn_apply")),
    ("conv", ("conv", "xmma", "implicit", "cudnn", "nhwc", "fprop", "winograd")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "cat", "copy", "fill",
                     "reduce", "index")),
)


def categorize(name: str) -> str:
    low = name.lower()
    for cat, frags in _CATEGORIES:
        if any(f in low for f in frags):
            return cat
    return "other"


def profile(batch: int = 32, forwards: int = 5, res: int = 128) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline

    if not torch.cuda.is_available():
        raise RuntimeError("forward_profile measures the device: CUDA is not available")
    pipe = ConditionalDDIMPipeline.init_random(
        super_small(), SchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                                       clip_sample=False),
        seed=0, dtype=torch.bfloat16, device="cuda",
    ).cast_params(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(batch, res, res, 3, generator=gen, device="cuda") * 0.5
    t = torch.full((batch,), 500, device="cuda")
    emb = pipe.class_embeddings(torch.zeros(batch, dtype=torch.long))
    denoise = pipe.denoiser_fn()
    for _ in range(3):
        denoise(x, t, emb)
    torch.cuda.synchronize()

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(forwards):
            denoise(x, t, emb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(evt.name, [0.0, 0])
            kernels[evt.name][0] += evt.time_range.elapsed_us() / 1e3
            kernels[evt.name][1] += 1
    by_cat = {}
    for name, (ms, _) in kernels.items():
        by_cat[categorize(name)] = by_cat.get(categorize(name), 0.0) + ms
    device_ms = sum(ms for ms, _ in kernels.values())
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    wall_ms = 1e3 * wall
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "device": torch.cuda.get_device_name(0), "batch": batch, "res": res,
        "forwards": forwards,
        "wall_ms_per_forward": wall_ms / forwards,
        "device_ms_per_forward": device_ms / forwards,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "launches_per_forward": sum(n for _, n in kernels.values()) / forwards,
        "ms_per_forward_by_category": {k: v / forwards for k, v in sorted(by_cat.items())},
        "top_kernels": [{"name": n[:120], "ms_per_forward": ms / forwards,
                         "calls_per_forward": c / forwards, "category": categorize(n)}
                        for n, (ms, c) in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--forwards", type=int, default=5)
    args = ap.parse_args()
    print(json.dumps(profile(args.batch, args.forwards)))


if __name__ == "__main__":
    main()
