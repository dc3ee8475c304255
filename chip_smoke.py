#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``phendiff_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one JSON line; any
failure exits non-zero before the final line:

1. environment: the card (``nvidia-smi``), torch, CUDA and nvcc versions;
2. build: every CUDA kernel library, from ``phendiff_tpu_torch/csrc``, one
   ``nvcc`` per source, all in parallel, with registers and spills per
   compiled function (``ptxas -v``; the GroupNorm kernels' also on their
   own); a spill in any tensor-core (bf16) attention kernel fails the run;
3. kernel checks at the main paths' shapes: each kernel against its plain
   PyTorch version on the same inputs, two calls bit-equal, with its time,
   the plain version's, one library call's (a yardstick the port never
   calls) and the bound; the GroupNorm forward and backward at each of the
   main path's 12 (S, C) with and without SiLU, with their launch plans and
   the clusters the card holds at once (their ``ms`` is device time, the
   calls captured in a CUDA graph, since a call from Python takes longer
   than the kernel at most of these shapes; ``call_ms`` is the call's),
   the forward's [B, G] mean and rstd against the plain statistics, which
   the backward's check also takes; a plain device copy of the largest
   GroupNorm map, the rate the card reaches on those bytes;
4. one full-width ``super_small`` 128 px forward at batch 4 in bf16,
   kernels against plain versions, and the same for every denoiser call
   of a 5-step DDIB at batch 2;
5. the transfer path: ``ConditionalDDIMPipeline.init_random``
   (``super_small``, seed 0) and a 50-step DDIB class transfer at batch 32,
   128 px, with the scheduler of ``bench.py``; the launch counts prove both
   forward kernels ran;
6. grad_check: one full-width train step at batch 4 with injected draws,
   kernel path against plain path: loss, every parameter's gradient
   (finite, non-zero, close) and the parameters after the step;
7. the training path: ``make_train_step`` on ``super_small`` at 128 px,
   batch 32, bf16 compute with f32 master params, ``proba_uncond=0.1``, the
   default optimizer and scheduler (``bench.py``'s ``bench_train``): 10 timed
   steps after warm-up, with launch counts of the attention and GroupNorm
   forward and backward kernels, a count of output gradients the
   GroupNorm backward had to copy (0), and a bit-equal checkpoint round
   trip;
8. the trainer: ``Trainer.run`` for 3 steps over a small image folder this
   script writes, and the EMA pipeline it saves loaded back;
9. the moments tool (``phendiff_tpu_torch.tools.bench_gn_moments``): its
   kernel against its plain version at [32, 8192, 128] bf16.

Then a JSON line of all kernels, the ``nvidia-smi`` name/power-limit line,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
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

# Attention: in bf16 the kernel rounds the unnormalised p to bf16 where the
# plain version rounds the normalised p (about one bf16 ulp of the output);
# in f32, f32 rounding.
ATTN_TOL = {"bfloat16": dict(rtol=2.0**-6, atol=2e-3), "float32": dict(rtol=1e-4, atol=1e-5)}
GN_TOL = dict(rtol=2.0**-7, atol=1e-3)  # one bf16 ulp of the output
# The forward's f32 mean and rstd against the plain version's: f32 sums of
# up to 0.5 M terms in another order.
GN_STATS_TOL = dict(rtol=1e-5, atol=1e-5)
# GroupNorm backward kernel against the same closed form in plain f32,
# relative L2: dx one bf16 rounding of each element; dscale and dbias f32
# sums of up to 16 M terms in another order.
GN_BWD_DX_REL_L2 = 5e-3
GN_BWD_PARAM_REL_L2 = 1e-4
FORWARD_REL_L2_TOL = 2e-2  # 41 GroupNorms + 6 attentions, bf16 throughout
# Attention backward, relative L2 per gradient: in bf16 the kernel takes the
# row term from the bf16 forward output and rounds ds and p at slightly
# different values than the plain version, so single bf16 roundings of ds
# flip (measured 1.9e-3 at the main shape); in f32, f32 rounding and the
# exp2 approximation (measured 7e-7).
BWD_REL_L2_TOL = {"bfloat16": 5e-3, "float32": 1e-5}
# Train-step gradients of the full-width model in bf16, kernels against
# plain versions, relative L2 per parameter tensor: bf16 rounding through
# 41 GroupNorms and 6 attentions, forward and backward (measured 6.6e-3).
GRAD_REL_L2_TOL = 2e-2
DESIGN = {
    "flash_attn_fwd": "bf16: mma.sync m16n8k8 QK^T / m16n8k16 PV, one warp per 16 q rows, "
                      "online softmax on the accumulator fragments, k/v by cp.async double "
                      "buffer + ldmatrix; f32: CUDA-core FMA",
    "flash_attn_bwd": "bf16: two mma.sync kernels (dq per q tile; dk/dv per key tile from "
                      "S^T = K Q^T), p recomputed from the saved lse, no atomics; f32: "
                      "CUDA-core FMA",
    "group_norm_silu": "one launch: a (sample, channel slice of whole groups) tile split over "
                       "a thread-block cluster, each block's rows in shared memory by TMA "
                       "boxes, f32 sums as the boxes land, combined in rank order through "
                       "distributed shared memory, normalised from shared memory: one HBM "
                       "read of x",
    "group_norm_silu_bwd": "one launch, the forward's cluster tiling holding x and g: per-"
                           "channel sums of dz and dz*x^ over the cluster, dx from shared "
                           "memory; dscale/dbias summed over the batch in sample order by "
                           "the last cluster of each channel slice (atomic ticket)",
}
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP = 32, 10, 2


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


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn`` with no host time: ``iters`` calls
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


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
    ptxas = {name: _build.ptxas_functions(log) for name, log in logs.items()}
    # the bf16 attention instantiations are the tensor-core kernels (*_mma_kernel<D>)
    mma = {fn: props for name in ("flash_attn_fwd", "flash_attn_bwd")
           for fn, props in ptxas[name].items() if "_mma_kernel" in fn}
    spills = sorted(fn for fn, props in mma.items() if props.get("spill_bytes", 1) != 0)
    gn = {fn: props for fn, props in ptxas["group_norm_silu"].items() if "cluster" in fn}
    emit({"phase": "build", "seconds": seconds, "kernels": list(_build.KERNELS),
          "ptxas": ptxas, "mma_kernels_spilling": spills, "group_norm_kernels": gn,
          "group_norm_kernels_spilling": sorted(fn for fn, p in gn.items()
                                                if p.get("spill_bytes", 0))})
    if len(mma) != 6 or spills:
        fail(f"tensor-core attention kernels: expected 6 without spills, got {mma}")


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
    again = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v)
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(out, again))
    ok = (out.dtype == dtype and torch.allclose(out.float(), ref.float(), **tol)
          and deterministic)
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
        "deterministic": deterministic, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bytes": n_bytes, "flops": flops, "exps": exps,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
    }
    emit(rec)
    return rec


def gn_plan_record(torch, b, s, c, groups, act, backward=False):
    from phendiff_tpu_torch.ops import gn_kernels

    plan = gn_kernels.gn_plan(s, c, groups, 2, backward)
    return {"plan": plan._asdict(), "max_active_clusters": gn_kernels.max_active_clusters(
        b, s, c, groups, torch.bfloat16, act, backward)}


def gn_check(torch, b, s, c, groups, act, iters=20):
    import torch.nn.functional as F

    from phendiff_tpu_torch.ops.gn_kernels import (
        _launch, fused_group_norm, group_norm_plain, group_stats_plain)

    g = torch.Generator(device="cuda").manual_seed(s + c)
    x = (torch.randn(b, s, c, generator=g, device="cuda") * 2 + 0.5).to(torch.bfloat16)
    scale = torch.randn(c, generator=g, device="cuda")
    bias = torch.randn(c, generator=g, device="cuda")
    kw = dict(num_groups=groups, eps=1e-5, act=act, out_dtype=torch.bfloat16)
    before = fused_group_norm.launches
    out = fused_group_norm(x, scale, bias, **kw)
    torch.cuda.synchronize()
    again = fused_group_norm(x, scale, bias, **kw)
    torch.cuda.synchronize()
    one_launch = fused_group_norm.launches - before == 2
    ref = group_norm_plain(x, scale, bias, **kw)
    # the [B, G] mean and rstd the forward writes for the backward
    stats = _launch(x, scale, bias, groups, 1e-5, act, torch.bfloat16)[1:]
    stats_ref = group_stats_plain(x, groups, 1e-5)
    torch.cuda.synchronize()
    stats_ok = all(torch.allclose(a, r, **GN_STATS_TOL) for a, r in zip(stats, stats_ref))
    ok = (torch.allclose(out.float(), ref.float(), **GN_TOL) and torch.equal(out, again)
          and one_launch and stats_ok)
    err = max_abs(out, ref)
    # device time (a CUDA graph of the calls) and the time of a call from
    # Python, host included
    ms = graph_ms(lambda: fused_group_norm(x, scale, bias, **kw), iters)
    call_ms = cuda_ms(lambda: fused_group_norm(x, scale, bias, **kw), iters=iters)
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
        "one_launch_per_call": one_launch, "stats_ok": stats_ok,
        "stats_max_rel_err": max(float(((a - r).abs() / r.abs()).max())
                                 for a, r in zip(stats, stats_ref)),
        "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_channels_last_ms": library_channels_last_ms, "bytes": n_bytes,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        **gn_plan_record(torch, b, s, c, groups, act),
    }
    emit(rec)
    return rec


def gn_bwd_check(torch, b, s, c, groups, act, sfu_rate, iters=20):
    import torch.nn.functional as F

    from phendiff_tpu_torch.ops import gn_kernels

    gen = torch.Generator(device="cuda").manual_seed(s + c + 1)
    x = (torch.randn(b, s, c, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
    gout = torch.randn(b, s, c, generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.randn(c, generator=gen, device="cuda")
    bias = torch.randn(c, generator=gen, device="cuda")
    # mean and rstd from the plain version, so the reference depends on
    # nothing a kernel computed
    mean, rstd = gn_kernels.group_stats_plain(x, groups, 1e-5)
    kw = dict(num_groups=groups, act=act)

    def kernel():
        return gn_kernels.fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **kw)

    before = gn_kernels.fused_group_norm_bwd.launches
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    one_launch = gn_kernels.fused_group_norm_bwd.launches - before == 2
    ref = gn_kernels.group_norm_bwd_plain(x, gout, scale, bias, mean, rstd, **kw)
    torch.cuda.synchronize()
    errs = {n: rel_l2(a, r) for n, a, r in zip(("dx", "dscale", "dbias"), got, ref)}
    deterministic = all(torch.equal(a, b2) for a, b2 in zip(got, again))
    ok = (got[0].dtype == torch.bfloat16 and all(bool(torch.isfinite(a).all()) for a in got)
          and errs["dx"] <= GN_BWD_DX_REL_L2 and errs["dscale"] <= GN_BWD_PARAM_REL_L2
          and errs["dbias"] <= GN_BWD_PARAM_REL_L2 and deterministic and one_launch)
    max_err = max_abs(got[0], ref[0])
    del again, ref
    ms, call_ms = graph_ms(kernel, iters), cuda_ms(kernel, iters=iters)
    plain_ms = cuda_ms(lambda: gn_kernels.group_norm_bwd_plain(
        x, gout, scale, bias, mean, rstd, **kw), iters=max(iters // 2, 3))
    # The yardstick: autograd of F.group_norm (+ F.silu) on a contiguous
    # [B, C, S] copy of x, bf16 weights, as the forward's yardstick.
    xc = x.transpose(1, 2).contiguous().requires_grad_()
    sb, bb = (t.to(torch.bfloat16).requires_grad_() for t in (scale, bias))
    y = F.group_norm(xc, groups, sb, bb, 1e-5)
    y = F.silu(y) if act == "silu" else y
    gc = gout.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(y, (xc, sb, bb), gc, retain_graph=True),
                         iters=iters)
    el = b * s * c
    n_bytes = el * (2 + 2 + 2) + 2 * c * 4 + 2 * c * 4 + 2 * b * groups * 4
    flops = 20 * el  # x^, z, sigma, dz, the two sums, dx
    exps = el if act == "silu" else 0
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, max(flops / F32_FLOPS, exps / sfu_rate)
    rec = {
        "phase": "kernel_check", "kernel": "group_norm_silu_bwd",
        "shape": {"B": b, "S": s, "C": c, "G": groups, "act": act}, "max_abs_err": max_err,
        "rel_l2": errs, "tol_rel_l2": {"dx": GN_BWD_DX_REL_L2, "dscale": GN_BWD_PARAM_REL_L2,
                                       "dbias": GN_BWD_PARAM_REL_L2},
        "ok": bool(ok), "deterministic": deterministic, "one_launch_per_call": one_launch,
        "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bytes": n_bytes,
        "flops": flops, "exps": exps, "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        **gn_plan_record(torch, b, s, c, groups, act, backward=True),
    }
    emit(rec)
    return rec


def copy_check(torch, b, s, c, iters=20):
    """The rate this card reaches on the largest GroupNorm map's bytes: a
    plain device copy (``Tensor.copy_``, one read and one write) of it, in
    device time."""
    x = torch.empty(b, s, c, dtype=torch.bfloat16, device="cuda")
    y = torch.empty_like(x)
    ms = graph_ms(lambda: y.copy_(x), iters)
    rec = {"phase": "copy_baseline", "shape": [b, s, c], "ms": ms, "bytes": 2 * x.nbytes,
           "tb_per_s": 2 * x.nbytes / ms / 1e9,
           "bound_ms": 1e3 * 2 * x.nbytes / HBM_BYTES_PER_S}
    emit(rec)
    return rec


def attention_bwd_check(torch, b, s, h, d, sfu_rate, dtype_name="bfloat16"):
    import torch.nn.functional as F

    from phendiff_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(4321 + d)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    scale = d**-0.5
    o, lse = fa._launch(q, k, v, scale, with_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, g, scale)
    again = fa.flash_attention_bwd(q, k, v, o, lse, g, scale)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q, k, v, g, scale)
    torch.cuda.synchronize()
    errs = {n: rel_l2(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
    max_err = max(max_abs(a, r) for a, r in zip(got, ref))
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (all(a.dtype == dtype and bool(torch.isfinite(a).all()) for a in got)
          and max(errs.values()) <= BWD_REL_L2_TOL[dtype_name] and deterministic)
    del again, ref
    ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, scale))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, g, scale),
                       iters=3, warmup=1)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    el = q.element_size()
    n_bytes = 8 * b * s * h * d * el + b * h * s * 4  # q k v o g in, dq dk dv out, lse in
    flops = 10 * b * h * s * s * d  # five products of 2*S*S*D per head
    exps = b * h * s * s  # one recompute of p
    flop_rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, max(flops / flop_rate, exps / sfu_rate)
    rec = {
        "phase": "kernel_check", "kernel": "flash_attn_bwd", "dtype": dtype_name,
        "shape": {"B": b, "S": s, "H": h, "D": d}, "max_abs_err": max_err, "rel_l2": errs,
        "tol_rel_l2": BWD_REL_L2_TOL[dtype_name], "ok": bool(ok),
        "deterministic": deterministic, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bytes": n_bytes, "flops": flops,
        "exps": exps, "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
    }
    emit(rec)
    return rec


def train_parts(torch, pipe, proba_uncond=0.1):
    """What ``bench.py``'s ``bench_train`` builds, in the port: the model
    apply (bf16 compute) and embedding functions over an f32 copy of the
    pipeline's parameters, its schedule, and the train config."""
    from torch.func import functional_call

    from phendiff_tpu_torch.models.unet2d import CondUNet2D
    from phendiff_tpu_torch.train.train_loop import OptimizerConfig, TrainConfig

    with torch.device("meta"):
        model = CondUNet2D(pipe.unet_config, dtype=torch.bfloat16)

    def model_apply(p, x, t, class_emb):
        return functional_call(model, p, (x, t), {"class_emb": class_emb})

    def embed_fn(p, labels):
        return p["class_embedding.weight"][labels]

    params = {n: p.detach().float().requires_grad_(p.requires_grad)
              for n, p in pipe.model.named_parameters()}
    cfg = TrainConfig(proba_uncond=proba_uncond, optimizer=OptimizerConfig())
    return model_apply, embed_fn, params, pipe.schedule, cfg


def phase_grad_check(torch, pipe):
    from phendiff_tpu_torch.obs.forward_profile import plain_kernels
    from phendiff_tpu_torch.train.train_loop import (
        diffusion_loss, init_train_state, make_draws, make_optimizer, make_train_step)

    model_apply, embed_fn, params, schedule, cfg = train_parts(torch, pipe)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    images = torch.randn(4, RES, RES, 3, generator=gen, device="cuda") * 0.5
    labels = torch.tensor([0, 1, 0, 1], device="cuda")
    draws = make_draws(SEED, 0, tuple(images.shape), schedule.num_train_timesteps, 0.0, "cuda")

    def loss_and_grads():
        loss = diffusion_loss(model_apply, params, schedule, images,
                              embed_fn(params, labels), draws.noise, draws.timesteps)
        names = [n for n, p in params.items() if p.requires_grad]
        return loss, dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))

    def one_step():
        opt = make_optimizer(cfg.optimizer)
        state = init_train_state(params, opt)
        step = make_train_step(model_apply, embed_fn, schedule, cfg, opt)
        return step(state, (images, labels), draws)[0]

    loss_k, grads_k = loss_and_grads()
    state_k = one_step()
    torch.cuda.synchronize()
    with plain_kernels():
        loss_p, grads_p = loss_and_grads()
        state_p = one_step()
    torch.cuda.synchronize()
    grad_errs = {n: rel_l2(grads_k[n], grads_p[n]) for n in grads_p}
    bad = sorted(n for n, gk in grads_k.items()
                 if not bool(torch.isfinite(gk).all()) or float(gk.abs().max()) == 0.0)
    lr = cfg.optimizer.learning_rate
    moved = {n: (state_k.params[n] - state_p.params[n]).detach().abs() for n in params}
    param_max = max(float(m.max()) for m in moved.values())
    # an element whose gradient is at bf16 noise takes Adam's update of
    # either sign, so at most 2 lr apart; the share of such elements is small
    differ = sum(int((m > 0.1 * lr).sum()) for m in moved.values())
    total = sum(m.numel() for m in moved.values())
    worst = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:5]
    rec = {
        "phase": "grad_check", "batch": 4, "n_params": len(grads_p),
        "loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
        "loss_rel_err": abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
        "grad_rel_l2_max": max(grad_errs.values()), "grad_rel_l2_worst": worst,
        "tol_rel_l2": GRAD_REL_L2_TOL, "zero_or_nonfinite_grads": bad,
        "param_max_abs_diff_after_step": param_max, "lr": lr,
        "param_share_differing_by_lr_over_10": differ / total,
    }
    emit(rec)
    if (bad or rec["grad_rel_l2_max"] > GRAD_REL_L2_TOL or rec["loss_rel_err"] > 1e-2
            or param_max > 2.01 * lr or differ / total > 1e-2):
        fail("grad_check: the kernel path's gradients disagree with the plain path")


def phase_train_path(torch, pipe, env):
    from phendiff_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm, fused_group_norm_bwd
    from phendiff_tpu_torch.train.checkpoints import CheckpointManager
    from phendiff_tpu_torch.train.train_loop import (
        init_train_state, make_draws, make_optimizer, make_train_step)

    model_apply, embed_fn, params, schedule, cfg = train_parts(torch, pipe)
    opt = make_optimizer(cfg.optimizer)
    state = init_train_state(params, opt)
    step = make_train_step(model_apply, embed_fn, schedule, cfg, opt)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    images = torch.randn(TRAIN_BATCH, RES, RES, 3, generator=gen, device="cuda") * 0.5
    labels = torch.tensor([0, 1], device="cuda").repeat(TRAIN_BATCH // 2)
    t_steps = schedule.num_train_timesteps

    def run(n):
        nonlocal state
        losses = []
        for _ in range(n):
            draws = make_draws(SEED, state.step, tuple(images.shape), t_steps,
                               cfg.proba_uncond, "cuda")
            state, m = step(state, (images, labels), draws)
            losses.append(m["loss"])
        return torch.stack(losses)

    run(TRAIN_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = 0
    fused_group_norm.launches = fused_group_norm_bwd.launches = 0
    fused_group_norm_bwd.g_copies = 0
    t0 = time.perf_counter()
    losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_attn_fwd": flash_attention.launches,
                "flash_attn_bwd": flash_attention_bwd.launches,
                "group_norm_silu": fused_group_norm.launches,
                "group_norm_silu_bwd": fused_group_norm_bwd.launches}
    want = {"flash_attn_fwd": 6 * TRAIN_STEPS, "flash_attn_bwd": 6 * TRAIN_STEPS,
            "group_norm_silu": 41 * TRAIN_STEPS, "group_norm_silu_bwd": 41 * TRAIN_STEPS}
    g_copies = fused_group_norm_bwd.g_copies
    peak = torch.cuda.max_memory_allocated() / 2**30

    ckpt_dir = tempfile.mkdtemp(prefix="phd_ckpt_")
    mgr = CheckpointManager(ckpt_dir, total_limit=1)
    mgr.save(state.step, state)
    restored = init_train_state(params, opt)
    mgr.restore(restored)
    sd_a, sd_b = state.state_dict(), restored.state_dict()
    bit_equal = sd_a["step"] == sd_b["step"] and all(
        torch.equal(sd_a[k][n], sd_b[k][n]) for k in ("params", "ema_params") for n in sd_a[k]
    ) and all(torch.equal(sd_a["opt_state"][k][n], sd_b["opt_state"][k][n])
              for k in ("mu", "nu") for n in sd_a["opt_state"][k])
    ckpt_bytes = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ckpt_dir)
                     for f in fs)
    rec = {
        "phase": "train_path", "batch": TRAIN_BATCH, "res": RES, "steps": TRAIN_STEPS,
        "seconds": dt, "samples_per_s": TRAIN_BATCH * TRAIN_STEPS / dt,
        "ms_per_step": 1e3 * dt / TRAIN_STEPS, "peak_mem_gib": peak,
        "launches": launches, "launches_expected": want,
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
        "group_norm_bwd_grad_copies": g_copies,
        "losses": [float(x) for x in losses], "loss_finite": bool(torch.isfinite(losses).all()),
        "checkpoint_round_trip_bit_equal": bool(bit_equal), "checkpoint_mib": ckpt_bytes / 2**20,
        "device": env["device"], "nvidia_smi": env["nvidia_smi"],
    }
    emit(rec)
    if not rec["loss_finite"] or not bit_equal:
        fail("train path: non-finite loss or a checkpoint that does not round-trip")
    if launches != want:
        fail(f"train path launch counts {launches} != expected {want}")
    if g_copies:
        fail(f"the GroupNorm backward copied {g_copies} non-contiguous output gradients")
    return rec


def phase_trainer(torch, pipe):
    """``Trainer.run`` over a folder of 2 x 48 random 128 px PNGs: 3 steps
    at batch 32 and one eval that saves the EMA pipeline."""
    import numpy as np
    from PIL import Image

    from phendiff_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm, fused_group_norm_bwd
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.train.train_loop import TrainConfig
    from phendiff_tpu_torch.train.trainer import RunPaths, TrainerConfig, for_ddim_pipeline

    root = tempfile.mkdtemp(prefix="phd_trainer_")
    rng = np.random.default_rng(SEED)
    for cls in ("DMSO", "drug"):
        os.makedirs(os.path.join(root, "data", cls))
        for i in range(48):
            Image.fromarray(rng.integers(0, 255, (RES, RES, 3), dtype=np.uint8)).save(
                os.path.join(root, "data", cls, f"{i:03d}.png"))
    cfg = TrainerConfig(
        train_data_dir=os.path.join(root, "data"), definition=(RES, RES),
        train_batch_size=TRAIN_BATCH, num_epochs=1, eval_every_epochs=1,
        checkpointing_steps=1000, mixed_precision="bf16", metrics_flush_every=3,
        train=TrainConfig(proba_uncond=0.1),
    )
    paths = RunPaths.create(root, "exp", "run0")
    trainer = for_ddim_pipeline(pipe, cfg, paths)
    flash_attention.launches = flash_attention_bwd.launches = 0
    fused_group_norm.launches = fused_group_norm_bwd.launches = 0
    t0 = time.perf_counter()
    state = trainer.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_attn_fwd": flash_attention.launches,
                "flash_attn_bwd": flash_attention_bwd.launches,
                "group_norm_silu": fused_group_norm.launches,
                "group_norm_silu_bwd": fused_group_norm_bwd.launches}
    with open(os.path.join(paths.run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    loaded = ConditionalDDIMPipeline.from_pretrained(paths.full_pipeline_save, device="cuda")
    same = all(torch.equal(p, state.ema_params[n]) for n, p in loaded.model.named_parameters())
    rec = {
        "phase": "trainer_run", "steps": state.step, "seconds": dt,
        "logged_steps": [r["step"] for r in recs], "losses": [r["loss"] for r in recs],
        "checkpoints": trainer.ckpt.all_steps(), "launches": launches,
        "pipeline_saved_and_loaded": same,
    }
    emit(rec)
    # 3 steps; the end-of-epoch eval only saves the EMA pipeline
    want = {"flash_attn_fwd": 18, "flash_attn_bwd": 18, "group_norm_silu": 123,
            "group_norm_silu_bwd": 123}
    if (state.step != 3 or rec["logged_steps"] != [1, 2, 3] or not same
            or not all(math.isfinite(x) for x in rec["losses"]) or launches != want):
        fail(f"trainer run: {rec}")
    return rec


def phase_moments():
    from phendiff_tpu_torch.ops.gn_kernels import channel_moments
    from phendiff_tpu_torch.tools import bench_gn_moments

    channel_moments.launches = 0
    rec = bench_gn_moments.measure()
    rec.update(phase="kernel_check", kernel="channel_moments",
               launches=channel_moments.launches)
    # f32 sums of 8192 terms in another order: 1e-5 of the largest sum
    rec["ok"] = bool(rec["max_rel_err_f64"] < 1e-5 and rec["max_rel_err_plain"] < 1e-5
                     and rec["deterministic"])
    emit(rec)
    if not rec["ok"]:
        fail("channel_moments disagrees with its float64 reference")
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

    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.obs.forward_profile import group_norm_calls, plain_kernels
    from phendiff_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm, fused_group_norm_bwd
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

    # the GroupNorm calls of one forward, by shape, and the launches of one
    per_forward = group_norm_calls(RES)
    flash_attention.launches = fused_group_norm.launches = 0
    denoise(images, torch.full((BATCH,), 500, device="cuda"), src)
    torch.cuda.synchronize()
    attn_per_forward, gn_per_forward = flash_attention.launches, fused_group_norm.launches
    if sum(per_forward.values()) != 41 or gn_per_forward != 41 or attn_per_forward != 6:
        fail(f"expected 41 GroupNorm and 6 attention calls per forward, got "
             f"{sum(per_forward.values())} recorded, {gn_per_forward} and {attn_per_forward}")

    checks_ok = True
    attn = attention_check(torch, BATCH, 1024, 32, 8, sfu_rate)
    checks_ok &= attn["ok"]
    checks_ok &= attention_check(torch, 2, 4096, 10, 64, sfu_rate)["ok"]
    # float32 compute (a pipeline loaded without cast_params) runs the same kernel
    checks_ok &= attention_check(torch, BATCH, 1024, 32, 8, sfu_rate, "float32")["ok"]
    gn_recs, gn_bwd_recs = {}, {}
    for s, c, groups in sorted({(s, c, g) for s, c, g, _ in per_forward}):
        for act in (None, "silu"):
            rec = gn_check(torch, BATCH, s, c, groups, act)
            gn_recs[(s, c, groups, act)] = rec
            checks_ok &= rec["ok"]
            rec = gn_bwd_check(torch, BATCH, s, c, groups, act, sfu_rate)
            gn_bwd_recs[(s, c, groups, act)] = rec
            checks_ok &= rec["ok"]
    copy_check(torch, BATCH, *max(((s, c) for s, c, _, _ in per_forward),
                                  key=lambda sc: sc[0] * sc[1]))
    bwd = attention_bwd_check(torch, BATCH, 1024, 32, 8, sfu_rate)
    checks_ok &= bwd["ok"]
    checks_ok &= attention_bwd_check(torch, BATCH, 1024, 32, 8, sfu_rate, "float32")["ok"]
    checks_ok &= attention_bwd_check(torch, 2, 4096, 10, 64, sfu_rate)["ok"]
    if not checks_ok:
        fail("a kernel disagrees with its plain version (see kernel_check lines)")

    def per_forward_sum(key, recs=gn_recs):
        """Summed over the 41 calls of one forward (or, for the backward's
        records, of one train step's backward)."""
        return sum(n * recs[call][key] for call, n in per_forward.items())

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
    flash_attention.launches = flash_attention_bwd.launches = 0
    fused_group_norm.launches = fused_group_norm_bwd.launches = 0
    t0 = time.perf_counter()
    out = ddib(denoise, pipe.schedule, images, src, tgt, num_inference_steps=STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_attn_fwd": flash_attention.launches,
                "flash_attn_bwd": flash_attention_bwd.launches,
                "group_norm_silu": fused_group_norm.launches,
                "group_norm_silu_bwd": fused_group_norm_bwd.launches}
    forwards = 2 * STEPS
    want = {"flash_attn_fwd": 6 * forwards, "flash_attn_bwd": 0,
            "group_norm_silu": 41 * forwards, "group_norm_silu_bwd": 0}
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

    # -- 6-9. training: gradients, train path, trainer, moments tool --------
    train_pipe = ConditionalDDIMPipeline.init_random(
        ucfg, SchedulerConfig(), seed=SEED, dtype=torch.bfloat16, device="cuda")
    phase_grad_check(torch, train_pipe)
    train = phase_train_path(torch, train_pipe, env)
    trainer = phase_trainer(torch, train_pipe)
    moments = phase_moments()

    # Forward times are per batch-32 UNet forward and backward times per
    # batch-32 train step, each summed over the kernel's calls in it (the
    # GroupNorm backward's 41 calls have the forward's shapes).
    by_path = {
        name: {"transfer": launches.get(name, 0), "train": train["launches"].get(name, 0),
               "trainer": trainer["launches"].get(name, 0)}
        for name in ("flash_attn_fwd", "flash_attn_bwd", "group_norm_silu", "group_norm_silu_bwd")
    }
    kernels = [
        {
            "name": "flash_attn_fwd", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "phendiff_tpu/ops/flash_attention.py:77",
            "launches": launches["flash_attn_fwd"], "max_abs_err": attn["max_abs_err"],
            **{k: attn_per_forward * attn[k]
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": attn["bound_by"], "launches_by_path": by_path["flash_attn_fwd"],
            "design": DESIGN["flash_attn_fwd"],
        },
        {
            "name": "flash_attn_bwd", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "phendiff_tpu/ops/flash_attention.py:155",
            "launches": train["launches"]["flash_attn_bwd"], "max_abs_err": bwd["max_abs_err"],
            **{k: 6 * bwd[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": bwd["bound_by"], "launches_by_path": by_path["flash_attn_bwd"],
            "design": DESIGN["flash_attn_bwd"],
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
            "call_ms": per_forward_sum("call_ms"),
            "launches_by_path": by_path["group_norm_silu"], "design": DESIGN["group_norm_silu"],
        },
        {
            "name": "group_norm_silu_bwd", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/group_norm_silu.cu",
            "replaces": "phendiff_tpu/ops/gn_kernels.py:98",
            "launches": train["launches"]["group_norm_silu_bwd"],
            "max_abs_err": max(r["max_abs_err"] for r in gn_bwd_recs.values()),
            **{k: per_forward_sum(k, gn_bwd_recs)
               for k in ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes", "launches_by_path": by_path["group_norm_silu_bwd"],
            "design": DESIGN["group_norm_silu_bwd"],
        },
        {
            "name": "channel_moments", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/group_norm_silu.cu",
            "replaces": "tools/bench_gn_moments.py:129",
            "launches": moments["launches"], "max_abs_err": moments["max_abs_err"],
            **{k: moments[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by")},
            "launches_by_path": {"moments_tool": moments["launches"]},
        },
    ]
    emit({"kernels": kernels, "seconds_total": time.perf_counter() - t_start})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
