"""Device-time breakdown of the main paths: the UNet forward, a train step,
or a guided-transfer step.

    python -m phendiff_tpu_torch.obs.forward_profile [--batch 32] [--forwards 5]
    python -m phendiff_tpu_torch.obs.forward_profile --train [--batch 32] [--steps 3]
    python -m phendiff_tpu_torch.obs.forward_profile --guided [--batch 32] [--steps 3]
    python -m phendiff_tpu_torch.obs.forward_profile --sd [--batch 64] [--res 128] [--forwards 3]
    python -m phendiff_tpu_torch.obs.forward_profile --sd --train [--batch 32] [--res 128] [--remat]

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
attention, ...).  A guided step (``--guided``: the reconstruction-guided
transfer's forward with an input gradient and its backward, bf16 weights
frozen) is traced whole and as its forward alone, which splits its device
time into forward and backward.  ``--sd`` traces full-width SD-2.1 UNet
forwards on the latents of ``--res`` px images and one VAE encode + decode
of them (random weights, seed 0, bf16); ``--sd --train`` traces full-width
SD-2.1 fine-tune steps (``for_sd_pipeline``'s step: frozen bf16 VAE encode,
f32 master weights, bf16 compute, ``proba_uncond=0.1``, lr 1e-5, as
``bench.py``'s ``bench_sd_train``), with ``--remat`` the blocks recomputed
in the backward.  Needs a CUDA device.

``record_calls`` (with ``unet_calls``, ``sd_unet_calls``, ``vae_calls``,
``sd_train_calls``) lists the GroupNorm and attention calls of a forward
(or a train step) by shape, from the model run on the meta device (no card
needed): the one recorder of those calls, which ``chip_smoke.py`` and the
CPU tests share.  ``plain_kernels``
routes the models through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import time
from typing import Callable

import torch

# Kernel-name fragments -> category, first match wins.  The attention
# kernels are the tensor-core ones (bf16, *_mma_kernel) and the CUDA-core
# ones (f32); the GroupNorm kernels are the cluster forward and backward
# and the streaming variant's passes; the moments tool's are the split
# statistics pass and its combine (gn_stats, which the streaming forward
# also runs as its first pass, counts there).
_CATEGORIES = (
    ("flash_attn_fwd", ("flash_fwd_mma_kernel", "flash_fwd_wgmma_kernel", "flash_fwd_kernel")),
    ("flash_attn_bwd", ("flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel",
                        "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
                        "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")),
    ("group_norm_silu", ("gn_fwd_cluster",)),
    ("group_norm_silu_bwd", ("gn_bwd_cluster",)),
    ("group_norm_silu_stream", ("stream_apply", "stream_stats_combine")),
    ("group_norm_silu_stream_bwd", ("stream_bwd_",)),
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


def record_calls(run: Callable[[], object]) -> dict:
    """Run ``run()`` with GroupNorm and attention routed through their plain
    versions (so on the meta device: no data, no kernels) and record every
    call by shape: ``{"group_norm": {(S, C, G, act, itemsize): calls},
    "group_norm_addend": {(S, C, G, act, itemsize): calls}`` (those of the
    GroupNorm calls that take an addend), ``"attention": {(S_q, S_kv, H, D,
    itemsize): calls}, "single_head_attention": calls}``.
    ``gn_kernels.gn_route`` and ``attention.takes_kernel`` say which kernel
    (or route) each call takes on the card."""
    from phendiff_tpu_torch.ops import attention, group_norm

    gn, addend, attn = collections.Counter(), collections.Counter(), collections.Counter()
    single = attention.single_head_attention.calls
    with plain_kernels():
        plain_gn, plain_attn = group_norm.fused_group_norm, attention.attention_plain

        def record_gn(x, scale, bias, **kw):
            key = (x.shape[1], x.shape[2], kw["num_groups"], kw["act"], x.element_size())
            gn[key] += 1
            addend[key] += kw.get("addend") is not None
            return plain_gn(x, scale, bias, **kw)

        def record_attn(q, k, v, scale=None):
            attn[(q.shape[1], k.shape[1], q.shape[2], q.shape[3], q.element_size())] += 1
            return plain_attn(q, k, v, scale=scale)

        group_norm.fused_group_norm = record_gn
        attention.attention_plain = attention.flash_attention = record_attn
        try:
            run()
        finally:
            attention.attention_plain = plain_attn
    return {"group_norm": dict(gn), "group_norm_addend": {k: n for k, n in addend.items() if n},
            "attention": dict(attn),
            "single_head_attention": attention.single_head_attention.calls - single}


def unet_calls(cfg, res: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``record_calls`` of one ``CondUNet2D(cfg)`` forward at ``res`` px."""
    from phendiff_tpu_torch.models.unet2d import CondUNet2D

    def run():
        with torch.device("meta"):
            model = CondUNet2D(cfg, dtype=dtype)
            labels = torch.zeros(1, dtype=torch.long) if cfg.num_class_embeds else None
            model(torch.zeros(1, res, res, cfg.in_channels), torch.zeros(1, dtype=torch.long),
                  class_labels=labels)

    return record_calls(run)


def sd_unet_calls(cfg, latent: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``record_calls`` of one ``SDUNet(cfg)`` forward on ``latent`` x
    ``latent`` latents with a 77-token class sequence."""
    from phendiff_tpu_torch.models.sd_unet import SDUNet

    def run():
        with torch.device("meta"):
            SDUNet(cfg, dtype=dtype)(torch.zeros(1, latent, latent, cfg.in_channels),
                                     torch.zeros(1, dtype=torch.long),
                                     torch.zeros(1, 77, cfg.cross_attention_dim))

    return record_calls(run)


def vae_calls(cfg, res: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``record_calls`` of one ``AutoencoderKL(cfg)`` encode and decode of a
    ``res`` px image."""
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL

    def run():
        with torch.device("meta"):
            vae = AutoencoderKL(cfg, dtype=dtype)
            mean, _ = vae.encode(torch.zeros(1, res, res, cfg.in_channels))
            vae.decode(mean)

    return record_calls(run)


def sd_train_calls(ucfg, vcfg, res: int, remat: bool = False,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The calls of one SD train step on ``res`` px images over a frozen VAE:
    ``{"forward": record_calls`` of the VAE encode and the UNet's forward
    and backward (under ``remat`` the blocks' recomputed forwards too),
    ``"backward": record_calls`` of the UNet forward whose calls each run
    one backward``}``."""
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from phendiff_tpu_torch.models.sd_unet import SDUNet

    def run():
        with torch.device("meta"):
            vae = AutoencoderKL(vcfg, dtype=dtype)
            unet = SDUNet(ucfg, dtype=dtype, remat=remat)
            with torch.no_grad():
                lat, _ = vae.encode(torch.zeros(1, res, res, vcfg.in_channels))
            out = unet(lat, torch.zeros(1, dtype=torch.long),
                       torch.zeros(1, 77, ucfg.cross_attention_dim))
            torch.autograd.grad(out.float().sum(), list(unet.parameters()))

    return {"forward": record_calls(run), "backward": sd_unet_calls(ucfg, res // 8, dtype)}


def group_norm_calls(res: int = 128) -> dict:
    """{(S, C, G, act): calls} of one ``super_small`` forward at ``res`` px,
    in bf16 (``unet_calls``)."""
    from phendiff_tpu_torch.models.config import super_small

    calls = collections.Counter()
    for (s, c, g, act, _), n in unet_calls(super_small(), res)["group_norm"].items():
        calls[(s, c, g, act)] += n
    return dict(calls)


def _pipeline(scheduler_config):
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline

    if not torch.cuda.is_available():
        raise RuntimeError("forward_profile measures the device: CUDA is not available")
    return ConditionalDDIMPipeline.init_random(super_small(), scheduler_config, seed=0,
                                               dtype=torch.bfloat16, device="cuda")


def trace(fn, calls: int) -> dict:
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
            **trace(lambda: denoise(x, t, emb), forwards)}


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
    return {"path": "train_step", "batch": batch, "res": res, **trace(one, steps)}


def profile_guided(batch: int = 32, steps: int = 3, res: int = 128) -> dict:
    """The guided transfer's step (``transfer.guided_gradient``), as
    ``chip_smoke.py`` drives it: the whole step, then its forward alone."""
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.pipelines.transfer import guided_gradient

    pipe = _pipeline(SchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                                      clip_sample=False)).cast_params(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(batch, res, res, 3, generator=gen, device="cuda")
    target = torch.randn(batch, res, res, 3, generator=gen, device="cuda")
    emb = pipe.class_embeddings(torch.ones(batch, dtype=torch.long))
    t = torch.full((batch,), 500, device="cuda")
    denoise = pipe.denoiser_fn()

    def step():
        guided_gradient(denoise, pipe.schedule, x, 500, target, emb)

    def forward():
        with torch.enable_grad():
            denoise(x.detach().requires_grad_(), t, emb)

    with pipe.frozen():
        for _ in range(3):
            step()
            forward()
        torch.cuda.synchronize()
        whole, fwd = trace(step, steps), trace(forward, steps)
    return {"path": "guided_step", "batch": batch, "res": res, **whole,
            "forward_device_ms_per_call": fwd["device_ms_per_call"],
            "backward_device_ms_per_call": whole["device_ms_per_call"]
            - fwd["device_ms_per_call"],
            "forward_ms_per_call_by_category": fwd["ms_per_call_by_category"]}


def sd_pipeline(dtype: torch.dtype = torch.bfloat16, seed: int = 0, cast: bool = True):
    """Full-width SD-2.1 (``SDUNetConfig()``, ``AutoencoderKLConfig()``) with
    random weights from ``seed`` on the card, the transfer scheduler of
    ``bench.py``; compute in ``dtype``, and conv and linear weights too
    unless ``cast`` is False (f32 weights, as a trainer takes them)."""
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline

    if not torch.cuda.is_available():
        raise RuntimeError("forward_profile measures the device: CUDA is not available")
    pipe = SDImg2ImgPipeline.init_random(
        SDUNetConfig(), AutoencoderKLConfig(),
        SchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                        clip_sample=False), seed=seed, dtype=dtype, device="cuda")
    return pipe.cast_params(dtype) if cast and dtype != torch.float32 else pipe


def profile_sd(batch: int = 64, res: int = 128, forwards: int = 3) -> dict:
    """One full-width SD UNet forward on ``res`` px images' latents and one
    VAE encode + decode of ``res`` px images, bf16."""
    pipe = sd_pipeline()
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.rand(batch, res, res, 3, generator=gen, device="cuda") * 2 - 1
    lat = pipe.encode_images(images)
    t = torch.full((batch,), 500, device="cuda")
    seq = pipe.encode_class(torch.zeros(batch, dtype=torch.long))
    denoise = pipe.denoiser_fn()

    def vae():
        pipe.decode_latents(pipe.encode_images(images))

    for _ in range(2):
        denoise(lat, t, seq)
        vae()
    torch.cuda.synchronize()
    return {"path": "sd_forward", "batch": batch, "res": res, "latent": lat.shape[1],
            **trace(lambda: denoise(lat, t, seq), forwards),
            "vae_encode_decode": trace(vae, 1)}


def sd_train_step(pipe, remat: bool = False, components_to_train=("denoiser", "class_embedding"),
                  proba_uncond: float = 0.1, mixed_precision: str = "bf16",
                  moment_dtype: str = "float32"):
    """``for_sd_pipeline``'s step on ``pipe`` (the optimizer of ``bench.py``'s
    ``bench_sd_train``, Adam's first moment in ``moment_dtype``):
    ``(step, state, kwargs, optimizer)``, where ``kwargs`` are the Trainer's
    (``sd_trainer_kwargs``)."""
    from phendiff_tpu_torch.train.train_loop import (
        OptimizerConfig, TrainConfig, init_train_state, make_optimizer, make_train_step)
    from phendiff_tpu_torch.train.trainer import TrainerConfig, sd_trainer_kwargs

    cfg = TrainConfig(proba_uncond=proba_uncond, optimizer=OptimizerConfig(
        learning_rate=1e-5, moment_dtype=moment_dtype))
    kw = sd_trainer_kwargs(
        pipe, TrainerConfig(mixed_precision=mixed_precision, remat=remat, train=cfg),
        components_to_train)
    opt = make_optimizer(cfg.optimizer, kw["trainable_mask"])
    step = make_train_step(kw["model_apply"], kw["embed_fn"], kw["schedule"], cfg, opt,
                           kw["encode_fn"], kw["encode_inside_grad"])
    return step, init_train_state(kw["trainable_params"], opt), kw, opt


def profile_sd_train(batch: int = 32, res: int = 128, steps: int = 3,
                     remat: bool = False) -> dict:
    """Full-width SD-2.1 fine-tune steps (``sd_train_step``) on ``res`` px
    images."""
    from phendiff_tpu_torch.train.train_loop import make_draws

    pipe = sd_pipeline(torch.bfloat16, cast=False)
    step, state, kw, _ = sd_train_step(pipe, remat)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.rand(batch, res, res, 3, generator=gen, device="cuda") * 2 - 1
    labels = torch.tensor([0, 1], device="cuda").repeat(batch // 2)
    shape = kw["diffusion_shape"](tuple(images.shape))

    def one():
        nonlocal state
        draws = make_draws(0, state.step, shape, pipe.schedule.num_train_timesteps, 0.1,
                           "cuda", posterior=True)
        state, _ = step(state, (images, labels), draws)

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"path": "sd_train_step", "batch": batch, "res": res, "remat": remat,
           **trace(one, steps)}
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--train", action="store_true", help="profile train steps instead")
    ap.add_argument("--guided", action="store_true", help="profile guided-transfer steps")
    ap.add_argument("--sd", action="store_true",
                    help="profile a full-width SD-2.1 UNet forward and a VAE encode + decode")
    ap.add_argument("--res", type=int, default=128, help="image size of --sd")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--remat", action="store_true",
                    help="with --sd --train: recompute the UNet's blocks in the backward")
    args = ap.parse_args()
    if args.sd and args.train:
        print(json.dumps(profile_sd_train(args.batch, args.res, args.steps, args.remat)))
    elif args.sd:
        print(json.dumps(profile_sd(args.batch, args.res, args.forwards)))
    elif args.train:
        print(json.dumps(profile_train(args.batch, args.steps)))
    elif args.guided:
        print(json.dumps(profile_guided(args.batch, args.steps)))
    else:
        print(json.dumps(profile(args.batch, args.forwards)))


if __name__ == "__main__":
    main()
