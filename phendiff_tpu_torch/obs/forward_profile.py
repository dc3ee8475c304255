"""Device-time breakdown of the main paths: the UNet forward, or a train step.

    python -m phendiff_tpu_torch.obs.forward_profile [--batch 32] [--forwards 5]
    python -m phendiff_tpu_torch.obs.forward_profile --train [--batch 32] [--steps 3]

Builds the ``super_small`` 128 px pipeline (random weights, seed 0, bf16
compute), warms up, then traces ``--forwards`` denoiser calls (or, with
``--train``, ``--steps`` train steps of ``bench.py``'s ``bench_train``
configuration: f32 master params, ``proba_uncond=0.1``, default optimizer
and scheduler) with ``torch.profiler`` and prints one JSON object: the
device time per call of each kernel category (the hand-written kernels,
convolutions, matrix products, the optimizer's multi-tensor kernels,
elementwise and copy kernels), the top kernels by device time, the wall
time per call and the device's idle share of it.  A train step also gets
its backward's device time by autograd node (convolution, GroupNorm,
attention, ...).  Needs a CUDA device.

``group_norm_calls`` lists the GroupNorm calls of one forward by shape,
from the model run on the meta device (no card needed), and
``plain_kernels`` routes the UNet through its plain versions.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import time

import torch

# Kernel-name fragments -> category, first match wins.  The attention
# kernels are the tensor-core ones (bf16, *_mma_kernel) and the CUDA-core
# ones (f32); the GroupNorm kernels are the cluster forward and backward;
# the moments tool's are the split statistics pass and its combine.
_CATEGORIES = (
    ("flash_attn_fwd", ("flash_fwd_mma_kernel", "flash_fwd_kernel")),
    ("flash_attn_bwd", ("flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel",
                        "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")),
    ("group_norm_silu", ("gn_fwd_cluster",)),
    ("group_norm_silu_bwd", ("gn_bwd_cluster",)),
    ("channel_moments", ("gn_stats", "moments_combine")),
    ("conv", ("conv", "xmma", "implicit", "cudnn", "nhwc", "fprop", "dgrad", "wgrad",
              "winograd")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_")),
    ("optimizer", ("multi_tensor_apply", "foreach")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "cat", "copy", "fill",
                     "reduce", "index")),
)


def categorize(name: str) -> str:
    low = name.lower()
    for cat, frags in _CATEGORIES:
        if any(f in low for f in frags):
            return cat
    return "other"


@contextlib.contextmanager
def plain_kernels():
    """Route the UNet's GroupNorm and attention through their plain
    versions; restores the kernels on exit."""
    from phendiff_tpu_torch.ops import attention, gn_kernels, group_norm

    saved = group_norm.fused_group_norm, attention.flash_attention
    group_norm.fused_group_norm = lambda x, s, b, **kw: gn_kernels.group_norm_plain(x, s, b, **kw)
    attention.flash_attention = lambda q, k, v, scale=None: attention.attention_plain(
        q, k, v, scale=scale)
    try:
        yield
    finally:
        group_norm.fused_group_norm, attention.flash_attention = saved


def group_norm_calls(res: int = 128) -> dict:
    """{(S, C, G, act): calls} of one ``super_small`` forward at ``res`` px,
    recorded from the model run on the meta device (no data, no kernels)."""
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.models.unet2d import CondUNet2D
    from phendiff_tpu_torch.ops import group_norm

    calls = collections.Counter()
    with plain_kernels():
        plain = group_norm.fused_group_norm

        def record(x, scale, bias, **kw):
            calls[(x.shape[1], x.shape[2], kw["num_groups"], kw["act"])] += 1
            return plain(x, scale, bias, **kw)

        group_norm.fused_group_norm = record
        with torch.device("meta"):
            model = CondUNet2D(super_small(), dtype=torch.bfloat16)
            model(torch.zeros(1, res, res, 3), torch.zeros(1, dtype=torch.long),
                  class_labels=torch.zeros(1, dtype=torch.long))
    return dict(calls)


def _pipeline(scheduler_config):
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline

    if not torch.cuda.is_available():
        raise RuntimeError("forward_profile measures the device: CUDA is not available")
    return ConditionalDDIMPipeline.init_random(super_small(), scheduler_config, seed=0,
                                               dtype=torch.bfloat16, device="cuda")


def _trace(fn, calls: int) -> dict:
    """Trace ``calls`` calls of ``fn``; the per-call breakdown."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels, backward = {}, {}
    prefix = "autograd::engine::evaluate_function: "
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(evt.name, [0.0, 0])
            kernels[evt.name][0] += evt.time_range.elapsed_us() / 1e3
            kernels[evt.name][1] += 1
        elif evt.name.startswith(prefix):
            node = evt.name[len(prefix):]
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = evt.cuda_time_total
            backward[node] = backward.get(node, 0.0) + total / 1e3
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_cat = {}
    for name, (ms, _) in kernels.items():
        by_cat[categorize(name)] = by_cat.get(categorize(name), 0.0) + ms
    device_ms = sum(ms for ms, _ in kernels.values())
    wall_ms = 1e3 * wall
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    out = {
        "device": torch.cuda.get_device_name(0), "calls": calls,
        "wall_ms_per_call": wall_ms / calls,
        "device_ms_per_call": device_ms / calls,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "launches_per_call": sum(n for _, n in kernels.values()) / calls,
        "ms_per_call_by_category": {k: v / calls for k, v in sorted(by_cat.items())},
        "top_kernels": [{"name": n[:120], "ms_per_call": ms / calls,
                         "launches_per_call": c / calls, "category": categorize(n)}
                        for n, (ms, c) in top],
    }
    if backward:
        out["backward_ms_per_call_by_node"] = {
            k: v / calls for k, v in sorted(backward.items(), key=lambda kv: -kv[1])}
    return out


def profile(batch: int = 32, forwards: int = 5, res: int = 128) -> dict:
    """The transfer path's denoiser call: bf16 weights, no gradient."""
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig

    pipe = _pipeline(SchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                                      clip_sample=False)).cast_params(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(batch, res, res, 3, generator=gen, device="cuda") * 0.5
    t = torch.full((batch,), 500, device="cuda")
    emb = pipe.class_embeddings(torch.zeros(batch, dtype=torch.long))
    denoise = pipe.denoiser_fn()
    for _ in range(3):
        denoise(x, t, emb)
    torch.cuda.synchronize()
    return {"path": "forward", "batch": batch, "res": res,
            **_trace(lambda: denoise(x, t, emb), forwards)}


def profile_train(batch: int = 32, steps: int = 3, res: int = 128) -> dict:
    """The training path's step, as ``chip_smoke.py`` drives it."""
    from torch.func import functional_call

    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.unet2d import CondUNet2D
    from phendiff_tpu_torch.train.train_loop import (
        OptimizerConfig, TrainConfig, init_train_state, make_draws, make_optimizer,
        make_train_step)

    pipe = _pipeline(SchedulerConfig())
    with torch.device("meta"):
        model = CondUNet2D(pipe.unet_config, dtype=torch.bfloat16)
    cfg = TrainConfig(proba_uncond=0.1, optimizer=OptimizerConfig())
    opt = make_optimizer(cfg.optimizer)
    state = init_train_state(pipe.model, opt)
    step = make_train_step(
        lambda p, x, t, ce: functional_call(model, p, (x, t), {"class_emb": ce}),
        lambda p, labels: p["class_embedding.weight"][labels], pipe.schedule, cfg, opt)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(batch, res, res, 3, generator=gen, device="cuda") * 0.5
    labels = torch.tensor([0, 1], device="cuda").repeat(batch // 2)

    def one():
        nonlocal state
        draws = make_draws(0, state.step, tuple(images.shape), pipe.schedule.num_train_timesteps,
                           cfg.proba_uncond, "cuda")
        state, _ = step(state, (images, labels), draws)

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    return {"path": "train_step", "batch": batch, "res": res, **_trace(one, steps)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--train", action="store_true", help="profile train steps instead")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if args.train:
        print(json.dumps(profile_train(args.batch, args.steps)))
    else:
        print(json.dumps(profile(args.batch, args.forwards)))


if __name__ == "__main__":
    main()
