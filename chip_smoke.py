#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``phendiff_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one JSON line; any
failure exits non-zero before the final line:

1. environment: the card (``nvidia-smi``), torch, CUDA and nvcc versions;
2. build: every CUDA kernel of the main path, from ``phendiff_tpu_torch/csrc``,
   one ``nvcc`` per source, all in parallel;
3. kernel checks at the main path's shapes: each kernel against its plain
   PyTorch version on the same inputs, with its time, the plain version's,
   one library call's (a yardstick the port never calls) and the bound;
4. one full-width ``super_small`` 128 px forward at batch 4 in bf16,
   kernels against plain versions, and the same for every denoiser call
   of a 5-step DDIB at batch 2;
5. the main path: ``ConditionalDDIMPipeline.init_random`` (``super_small``,
   seed 0) and a 50-step DDIB class transfer at batch 32, 128 px, with the
   scheduler of ``bench.py``; the launch counts prove both kernels ran.

Then a JSON line of all kernels, the ``nvidia-smi`` name/power-limit line,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

BATCH, RES, STEPS = 32, 128, 50
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# Special-function unit: 16 exp2 results per clock per SM (CUDA C
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0), times the SM count and the card's maximum SM clock.
SFU_PER_CLOCK_PER_SM = 16

# Attention: in bf16 the kernel keeps p f32 where the plain version rounds
# it to bf16 (about one bf16 ulp of the output); in f32, f32 rounding.
ATTN_TOL = {"bfloat16": dict(rtol=2.0**-6, atol=2e-3), "float32": dict(rtol=1e-4, atol=1e-5)}
GN_TOL = dict(rtol=2.0**-7, atol=1e-3)  # one bf16 ulp of the output
FORWARD_REL_L2_TOL = 2e-2  # 41 GroupNorms + 6 attentions, bf16 throughout


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@contextlib.contextmanager
def plain_kernels():
    """Route the UNet's GroupNorm and attention through their plain versions
    (the reference runs of phase 4); restores the kernels on exit."""
    from phendiff_tpu_torch.ops import attention, gn_kernels, group_norm

    saved = (group_norm.fused_group_norm, attention.flash_attention)
    group_norm.fused_group_norm = lambda x, s, b, **kw: gn_kernels.group_norm_plain(x, s, b, **kw)
    attention.flash_attention = lambda q, k, v, scale=None: attention.attention_plain(q, k, v, scale=scale)
    try:
        yield
    finally:
        group_norm.fused_group_norm, attention.flash_attention = saved


@contextlib.contextmanager
def record_gn_calls(calls: list):
    """Record (S, C, G, act) of each GroupNorm call of the UNet."""
    from phendiff_tpu_torch.ops import group_norm

    inner = group_norm.fused_group_norm

    def rec(x, s, b, **kw):
        calls.append((x.shape[1], x.shape[2], kw["num_groups"], kw["act"]))
        return inner(x, s, b, **kw)

    group_norm.fused_group_norm = rec
    try:
        yield
    finally:
        group_norm.fused_group_norm = inner


def phase_env(torch):
    name_power = smi("name,power.limit")
    try:
        max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    except (ValueError, IndexError):
        max_sm_mhz = float("nan")
    from phendiff_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    props = torch.cuda.get_device_properties(0)
    env = {
        "phase": "env", "nvidia_smi": name_power, "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(), "sm_count": props.multi_processor_count,
        "max_sm_clock_mhz": max_sm_mhz, "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": nvcc, "python": sys.version.split()[0],
    }
    emit(env)
    return env


def phase_build():
    from phendiff_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": seconds, "kernels": list(_build.KERNELS),
          "built": sorted(logs), "ptxas": ptxas})


def attention_check(torch, b, s, h, d, sfu_rate, dtype_name="bfloat16"):
    import torch.nn.functional as F

    from phendiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    dtype = getattr(torch, dtype_name)
    tol = ATTN_TOL[dtype_name]
    g = torch.Generator(device="cuda").manual_seed(1234 + d)
    # q, k, v as the UNet hands them over: column slices of one fused qkv
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v)
    torch.cuda.synchronize()
    ok = out.dtype == dtype and torch.allclose(out.float(), ref.float(), **tol)
    err = max_abs(out, ref)
    ms = cuda_ms(lambda: flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v), iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    n_bytes = 4 * b * s * h * d * q.element_size()
    flops = 4 * b * h * s * s * d
    exps = b * h * s * s
    flop_rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, max(flops / flop_rate, exps / sfu_rate)
    rec = {
        "phase": "kernel_check", "kernel": "flash_attn_fwd", "dtype": dtype_name,
        "shape": {"B": b, "S": s, "H": h, "D": d}, "max_abs_err": err, "ok": bool(ok),
        "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bytes": n_bytes, "flops": flops, "exps": exps,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
    }
    emit(rec)
    return rec


def gn_check(torch, b, s, c, groups, act, iters=20):
    import torch.nn.functional as F

    from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm, group_norm_plain

    g = torch.Generator(device="cuda").manual_seed(s + c)
    x = (torch.randn(b, s, c, generator=g, device="cuda") * 2 + 0.5).to(torch.bfloat16)
    scale = torch.randn(c, generator=g, device="cuda")
    bias = torch.randn(c, generator=g, device="cuda")
    kw = dict(num_groups=groups, eps=1e-5, act=act, out_dtype=torch.bfloat16)
    out = fused_group_norm(x, scale, bias, **kw)
    torch.cuda.synchronize()
    again = fused_group_norm(x, scale, bias, **kw)
    torch.cuda.synchronize()
    ref = group_norm_plain(x, scale, bias, **kw)
    torch.cuda.synchronize()
    ok = torch.allclose(out.float(), ref.float(), **GN_TOL) and torch.equal(out, again)
    err = max_abs(out, ref)
    ms = cuda_ms(lambda: fused_group_norm(x, scale, bias, **kw), iters=iters)
    plain_ms = cuda_ms(lambda: group_norm_plain(x, scale, bias, **kw), iters=max(iters // 2, 3))
    sb, bb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)

    def library(xin):
        y = F.group_norm(xin, groups, sb, bb, 1e-5)
        return F.silu(y) if act == "silu" else y

    # The yardstick is F.group_norm's own work: x copied to a contiguous
    # [B, C, S] tensor before timing.  On the UNet's layout (a channels_last
    # NCHW view of the NHWC map) ATen's CUDA GroupNorm first makes that
    # copy itself, inside the call; that time is reported beside it.
    hw = math.isqrt(s)
    xc = x.transpose(1, 2).contiguous()
    x_cl = x.view(b, hw, s // hw, c).permute(0, 3, 1, 2)
    library_ms = cuda_ms(lambda: library(xc), iters=iters)
    library_channels_last_ms = cuda_ms(lambda: library(x_cl), iters=iters)
    n_bytes = b * s * c * (2 + 2) + 2 * c * 4
    flops = 10 * b * s * c
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    rec = {
        "phase": "kernel_check", "kernel": "group_norm_silu",
        "shape": {"B": b, "S": s, "C": c, "G": groups, "act": act}, "max_abs_err": err,
        "ok": bool(ok), "deterministic": bool(torch.equal(out, again)), "tol": GN_TOL,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_channels_last_ms": library_channels_last_ms, "bytes": n_bytes,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    emit(rec)
    return rec


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script measures the port on an NVIDIA GPU")
    try:
        import phendiff_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"phendiff_tpu_torch not importable ({e}): run from the root of a checkout")

    from phendiff_tpu_torch.core.scheduler import SchedulerConfig, make_schedule
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.ops.flash_attention import flash_attention
    from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.pipelines.transfer import ddib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. environment ----------------------------------------------------
    env = phase_env(torch)
    sfu_rate = (SFU_PER_CLOCK_PER_SM * env["sm_count"] * env["max_sm_clock_mhz"] * 1e6
                if math.isfinite(env["max_sm_clock_mhz"]) else
                SFU_PER_CLOCK_PER_SM * env["sm_count"] * 1.98e9)

    # -- 2. build ----------------------------------------------------------
    phase_build()

    # -- 3. kernel checks at the main path's shapes ------------------------
    ucfg = super_small()
    sched_cfg = SchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                                clip_sample=False)
    pipe = ConditionalDDIMPipeline.init_random(
        ucfg, sched_cfg, seed=SEED, dtype=torch.bfloat16, device="cuda"
    ).cast_params(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    images = torch.randn(BATCH, RES, RES, 3, generator=gen, device="cuda") * 0.5
    src = pipe.class_embeddings(torch.zeros(BATCH, dtype=torch.long))
    tgt = pipe.class_embeddings(torch.ones(BATCH, dtype=torch.long))
    denoise = pipe.denoiser_fn()

    gn_calls: list = []
    flash_attention.launches = 0
    with record_gn_calls(gn_calls):
        denoise(images, torch.full((BATCH,), 500, device="cuda"), src)
    torch.cuda.synchronize()
    attn_per_forward = flash_attention.launches
    per_forward = {}
    for call in gn_calls:
        per_forward[call] = per_forward.get(call, 0) + 1
    if len(gn_calls) != 41 or attn_per_forward != 6:
        fail(f"expected 41 GroupNorm and 6 attention calls per forward, "
             f"got {len(gn_calls)} and {attn_per_forward}")

    checks_ok = True
    attn = attention_check(torch, BATCH, 1024, 32, 8, sfu_rate)
    checks_ok &= attn["ok"]
    checks_ok &= attention_check(torch, 2, 4096, 10, 64, sfu_rate)["ok"]
    # float32 compute (a pipeline loaded without cast_params) runs the same kernel
    checks_ok &= attention_check(torch, BATCH, 1024, 32, 8, sfu_rate, "float32")["ok"]
    gn_recs = {}
    for s, c, groups in sorted({(s, c, g) for s, c, g, _ in per_forward}):
        for act in (None, "silu"):
            rec = gn_check(torch, BATCH, s, c, groups, act)
            gn_recs[(s, c, groups, act)] = rec
            checks_ok &= rec["ok"]
    if not checks_ok:
        fail("a kernel disagrees with its plain version (see kernel_check lines)")

    def per_forward_sum(key):
        return sum(n * gn_recs[call][key] for call, n in per_forward.items())

    # -- 4. full-width forward and a short DDIB, kernels vs plain ----------
    xb = images[:4]
    tb = torch.full((4,), 500, device="cuda")
    out_k = denoise(xb, tb, src[:4])
    torch.cuda.synchronize()
    with plain_kernels():
        out_p = denoise(xb, tb, src[:4])
    torch.cuda.synchronize()
    fwd = {"phase": "forward_check", "batch": 4, "max_abs_err": max_abs(out_k, out_p),
           "rel_l2": rel_l2(out_k, out_p), "tol_rel_l2": FORWARD_REL_L2_TOL,
           "finite": bool(torch.isfinite(out_k).all())}
    # Along a short DDIB trajectory, every denoiser call is held against the
    # plain path on the same input.  Whole trajectories are not compared: the
    # first generation row divides by sqrt(alpha_999) ~ 0.006, so a random-
    # init model in bf16 amplifies rounding differences chaotically.
    row_errs = []

    def checked(x, t, emb):
        out = denoise(x, t, emb)
        with plain_kernels():
            row_errs.append(rel_l2(out, denoise(x, t, emb)))
        return out

    d_k = ddib(checked, pipe.schedule, images[:2], src[:2], tgt[:2], num_inference_steps=5)
    torch.cuda.synchronize()
    fwd.update({"ddib_5step_rows_rel_l2": row_errs, "ddib_finite": bool(torch.isfinite(d_k).all())})
    emit(fwd)
    if not (fwd["finite"] and fwd["ddib_finite"]
            and max([fwd["rel_l2"], *row_errs]) <= FORWARD_REL_L2_TOL):
        fail("the full-width forward disagrees with the plain path")

    # -- 5. main path: 50-step DDIB at batch 32 ----------------------------
    ddib(denoise, pipe.schedule, images, src, tgt, num_inference_steps=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    fused_group_norm.launches = 0
    t0 = time.perf_counter()
    out = ddib(denoise, pipe.schedule, images, src, tgt, num_inference_steps=STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_attn_fwd": flash_attention.launches,
                "group_norm_silu": fused_group_norm.launches}
    forwards = 2 * STEPS
    want = {"flash_attn_fwd": 6 * forwards, "group_norm_silu": 41 * forwards}
    main = {
        "phase": "main_path", "batch": BATCH, "res": RES, "steps": STEPS,
        "seconds": dt, "transfers_per_s": BATCH / dt,
        "denoise_steps_per_s": BATCH * forwards / dt, "ms_per_forward": 1e3 * dt / forwards,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "launches_expected": want,
        "finite": bool(torch.isfinite(out).all()), "shape": list(out.shape),
        "out_mean": float(out.mean()), "out_std": float(out.std()),
        "device": env["device"], "nvidia_smi": env["nvidia_smi"],
    }
    emit(main)
    if not main["finite"] or tuple(out.shape) != (BATCH, RES, RES, 3):
        fail("main-path output is not finite or has the wrong shape")
    if launches != want:
        fail(f"launch counts {launches} != expected {want}")

    # Times are per batch-32 UNet forward: summed over the kernel's calls in it.
    kernels = [
        {
            "name": "flash_attn_fwd", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "phendiff_tpu/ops/flash_attention.py:77",
            "launches": launches["flash_attn_fwd"], "max_abs_err": attn["max_abs_err"],
            **{k: attn_per_forward * attn[k]
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": attn["bound_by"],
        },
        {
            "name": "group_norm_silu", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/group_norm_silu.cu",
            "replaces": "phendiff_tpu/ops/gn_kernels.py:129",
            "launches": launches["group_norm_silu"],
            "max_abs_err": max(r["max_abs_err"] for r in gn_recs.values()),
            "ms": per_forward_sum("ms"), "plain_ms": per_forward_sum("plain_ms"),
            "bound_ms": per_forward_sum("bound_ms"), "bound_by": "bytes",
            "library_ms": per_forward_sum("library_ms"),
            "library_channels_last_ms": per_forward_sum("library_channels_last_ms"),
        },
    ]
    emit({"kernels": kernels, "seconds_total": time.perf_counter() - t_start})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
