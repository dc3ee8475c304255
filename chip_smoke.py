#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``phendiff_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one JSON line; any
failure exits non-zero before the final line:

1. environment: the card (``nvidia-smi``), torch, CUDA and nvcc versions;
2. build: every CUDA kernel library, from ``phendiff_tpu_torch/csrc``, one
   ``nvcc`` per source, all in parallel, with registers and spills per
   compiled function (``ptxas -v``; the GroupNorm kernels' also on their
   own); a spill in any GroupNorm kernel, or a spill or stack frame in any
   tensor-core (bf16) attention kernel (6 mma.sync; 4 wgmma: the D = 64
   and D = 72 forward, the D = 64 backward's two), fails the run;
3. kernel checks at the main paths' shapes: each kernel against its plain
   PyTorch version on the same inputs, two calls bit-equal, with its time,
   the plain version's, one library call's (a yardstick the port never
   calls) and the bound (``bound_by``: bytes, tensor cores, f32 FMA or exp);
   each attention row names the design its calls took
   (``attention_design``: wgmma, mma_sync or fma) and fails unless both
   calls took it; the GroupNorm forward and backward at each of the
   main path's 12 (S, C) with and without SiLU, with their launch plans, the
   clusters the card holds at once and the registers a thread of the kernel
   takes (their ``ms`` is device time, the calls captured in a CUDA graph,
   since a call from Python takes longer than the kernel at most of these
   shapes; ``call_ms`` is the call's),
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
9. guided_check: one step of the reconstruction-guided transfer at batch 4
   from a fixed latent, weights frozen: its model output and its input
   gradient (through both backward kernels) against the plain path, one
   launch of each backward kernel per attention and GroupNorm, and sample
   0's gradient alone against in the batch;
10. guided_path: ``guided_inverted_start`` at batch 32, 50 steps (50
    inversion forwards, 50 guided steps), with its launch counts, peak
    memory and the inverted latent's moments (``check_gaussianity``);
11. cfg_path: ``cfg_forward_start`` at batch 32, 50 steps, frac 0.5,
    guidance 2.5 (25 cond+uncond forwards at batch 64);
12. inception: ``InceptionExtractor`` (random init) on 32 images of 128 px
    resized to 299, and the card against the CPU on 4 of them;
13. comparison: ``ComparisonExperiment`` over a 2 x 32 image folder this
    script writes, all four methods, 10 steps, batch 32, FID/ISC/KID;
14. evaluator: ``Trainer.run`` with ``compute_metrics=True``, one step and
    one eval (one batch of 32 per class, 10 steps), best model saved;
15. the moments tool (``phendiff_tpu_torch.tools.bench_gn_moments``): its
    kernel against its plain version at [32, 8192, 128] bf16, timed by CUDA
    events around Python calls and by device time (a CUDA graph);
16. serving: ``phendiff_tpu_torch.serving.InferenceEngine`` over a copy of
    the transfer path's pipeline, ``max_batch`` 32, 50 steps: one CUDA graph
    captured per op (generate, transfer, invert) in ``warmup()``, each full
    request bit-equal to the eager op on the same inputs (replayed after
    other work has allocated and freed memory), a 5-image request equal to
    the full one's rows, each capture's launches exact (600 attention and
    4100 GroupNorm a transfer, half that a generate or invert), requests/s
    and a replay's device time, peak memory, and ``swap_params`` to the
    seed-1 pipeline bit-equal to the eager transfer with its weights, with
    no new capture;
17. sd_kernel_check: full-width SD-2.1's self-attention shapes (heads of
    64) at 128 px, batch 64 and 512 px, batch 8, and the train step's at 128
    px, batch 32, both attention kernels against their plain versions and
    SDPA; the cluster GroupNorm kernels at the SD UNet's and the VAE's
    shapes at the same batches; the streaming GroupNorm variant,
    forward and backward, against the plain versions at every (S, C, act)
    of the CPU fault test's list (calls no cluster plan fits: the SD VAE's
    512 px maps among them);
18. sd_forward_check: one full-width SD UNet forward (latent 16, batch 2)
    and VAE encode + decode at 128 px (batch 2) and 512 px (batch 1),
    kernels against plain versions in float32, and in bf16 against the
    float32 plain output no further than the bf16 plain path;
19. sd_path and sd_path_512: ``SDImg2ImgPipeline.init_random`` (full-width
    SD-2.1, seed 0, bf16) and a 50-step DDIB class transfer from images
    through the VAE at 128 px, batch 64 and 512 px, batch 8
    (``bench.py::bench_sd(16, 64)`` and ``bench_sd(64, 8)``'s shapes), with
    exact launches per kernel, warpgroup attention design (``attention_design``
    over the recorded calls; every SD phase's launches are held to it),
    streaming variant and plain-attention route against what the recorded
    calls predict, and no call of a kernel's plain version on the card;
20. sd_guided_check: one guided step at latent 16, batch 4 in bf16, and at
    latent 64, batch 1 in float32 (its one streaming backward), model output
    and input gradient against the plain path;
21. sd_comparison: the SD pipeline saved with ``save_pretrained`` and run
    by ``ComparisonExperiment`` over 2 x 32 random 128 px PNGs, all four
    methods, 10 steps, batch 32; ISC and KID (FID off: its host ``sqrtm``
    already takes most of the DDIM comparison phase);
22. sd_serving: the engine over the full-width SD pipeline at sd_path's
    shape (128 px, ``max_batch`` 64) and sd_path_512's (512 px, 8; its
    graphs hold the streaming GroupNorm launches of the VAE): the same
    checks, the transfer held bit-equal to that phase's output, launches
    against the recorded calls (the UNet's per step, the VAE's encode and
    decode), ``swap_params`` to seed 1 (and at 128 px back to seed 0,
    which restores sd_path's output);
23. sd_train_check: one full-width SD fine-tune step (``for_sd_pipeline``'s:
    frozen bf16 VAE encode, f32 master weights, bf16 compute) at latent 16,
    batch 4, on the kernels and on the plain versions, each held against
    the same step in f32: loss, gradient norm and the UNet's and class
    embedding's gradients; the same step with remat against without; one
    step with the VAE's encoder trained (its gradients finite and nonzero,
    the decoder's zero);
24. sd_train_path: SD fine-tune steps at 128 px, batch 32
    (``bench.py::bench_sd_train``'s shape, plus the frozen VAE encode): 10
    timed steps without remat, 3 with it and 3 with Adam's first moment in
    bf16 (its first step against the f32-moment run's, its second step's
    update against the same update on the host), samples/s, peak memory,
    and exact launches against the recorded calls of one step
    (``tools.kernel_calls.sd_train_calls``: the blocks' recomputed forwards
    under remat);
25. train_cli: ``phendiff_tpu_torch.cli.train_cli.main`` in this process:
    DDIM with ``examples/launch_train_ddim.sh``'s flags and ``--debug``,
    and an SD fine-tune of the folder phase 21 saved (3 steps, one eval);
    each exits 0 with finite losses, a checkpoint and a save that reloads;
26. dp: data parallelism (``phendiff_tpu_torch.parallel``).  (a) World 1
    over NCCL in this process: ``Trainer.run`` for 3 DDIM steps at batch 32
    and one full-width SD fine-tune step at 128 px, batch 32 (frozen bf16
    VAE), each bit-equal to the same run without a process group, with the
    NCCL version and the all-reduce's ms a step.  (b) World 2 over gloo, two
    processes of this script (``--dp-worker``) on ``cuda:0`` (NCCL refuses two
    ranks on one card): 3 DDIM steps at local batch 16 (global 32) on their
    rows of the global draws against this process's batch-32 steps (the first
    step's loss and gradients, the parameters after 3 steps by grad_check's
    rule), exact launches a rank a step, an Evaluator pass (32 images a
    class, 10 steps, f32) whose gathered features match world 1's, the
    DDIB comparison over 2 x 32 PNGs at 10 steps in f32, images within 1e-3
    of world 1's at the ranks' batch of 16, and a metric pass of one FID
    (class 0 against class 1) computed on rank 0 alone.  (c) Per-rank and
    global samples/s and the gloo all-reduce's ms a step: two ranks share
    one card, so these are not scaling figures;
27. reco: the trained-model round trip
    (``phendiff_tpu_torch/tools/trained_round_trip.py``): ``super_small``
    trained 100 steps at 64 px (bf16, batch 32) on a toy set this phase
    writes, then a 50-step sample -> DDIM-invert -> regenerate at batch 16
    in f32 (``tools/reco_err.py``'s ``round_trip``), gated on its threshold
    (mean relative error under 0.05) and finite latents; exact launches of
    the four kernels and each kernel first held against its plain version
    at this path's shapes;
28. tp: tensor parallelism (``phendiff_tpu_torch/parallel/tp.py``): each
    kernel at the shards' shapes (16 of 32 heads, half the channels and
    groups), then two processes of this script (``--tp-worker``, gloo on
    ``cuda:0``, one replica over a model axis of 2): 3 DDIM train steps at
    batch 32 against the dp phase's world-1 steps (grad_check's rule on the
    gathered gradients and parameters), replicated leaves bit-equal on both
    ranks and shards of half width, exact launches a rank a step with the
    attention at 16 heads and 17 GroupNorms a forward at half the channels,
    and one full-width SD-2.1 UNet forward at 128 px, batch 8: in float32
    against world 1 to SD_F32_REL_L2_TOL, in bf16 the shards and world 1
    each against world 1's float32 output to FORWARD_REL_L2_TOL; the step
    times (two ranks share one card: not a
    scaling figure);
29. sd_segmented: the stage-per-device SD route on full-width SD-2.1
    (seed 0): ``SegmentedSDUNet`` bit-equal to ``SDUNet.forward`` at 128 px,
    batch 8 in bf16 (deterministic cuDNN), ``PipelinedSDUNet`` on
    ``cuda:0`` with 4 microbatches against the whole batch in f32, each
    stage's device printed; ``forward_with_input_vjp`` at batch 4 in f32
    against autograd through the monolith, with exact launches (every stage
    recomputed: twice the forward's); ``SegmentedSDTrainStep`` at 128 px,
    batch 32 (frozen bf16 VAE, bf16 compute, ctx stage, EMA, clip at 1.0)
    in each clip mode: its first step against the one-program step from
    the same draws by grad_check's rule, then 3 timed steps with ms/step,
    exact launches and peak memory beside the one-program step's;
    ``train_cli --segmented_sd on`` for 3 steps over phase 21's folder,
    its checkpoint resumed and its save loaded; ``ComparisonExperiment``
    with ``segmented_sd`` (ddib and guided, 10 steps, batch 8, f32) within
    SEG_CMP_LEVELS uint8 levels of the one-module route.
30. dit: DiT-XL/2 at 512 px (``models/dit.py``, random weights, bf16),
    one forward at batch 32 from zeroed attention counters: its 28
    self-attention calls (B 32, S 1024, H 16, D 72) each one launch of the
    D = 72 warpgroup kernel, none on the plain route, the output finite,
    and the forward's time.  The D = 72 forward itself is held against its
    plain version in phase 3, at that shape in bf16 and at S 300 and 17 in
    bf16 and f32;
31. resnet_bias: the residual kernel (``csrc/residual_bias.cu``) at the
    DDIM's largest residual map, (128, 128, 128, 64) in bf16, with one bias
    and with two, bit-equal to its plain version, its device time in a CUDA
    graph against its byte bound (at least RESIDUAL_MIN_SHARE_OF_BOUND),
    ATen's bias and residual adds as the convs ran them (the library
    yardstick) and the plain version, and the same times at SD-2.1's
    (256, 16, 16, 320).  (Phase 3 holds a batch-32 forward to one launch
    for each of the 17 ResnetBlocks and no plain call.)

Then a JSON line of all kernels (the D = 64 warpgroup attention kernels as
rows of their own: their forward's launches on the 512 px SD transfer, their
backward's on the SD train step, which fail the run if either is 0; the
D = 72 forward as a row of its own, its times per DiT-XL/2 forward at batch
32 and its launches on phase 30's forward), the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device":
{...}}``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

BATCH, RES, STEPS = 32, 128, 50
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
# The fused DiT boundary kernel's least share of its byte bound at
# DiT-XL/2's shape in bf16 (80% measured on an H100 80GB HBM3 at 700 W).
ADALN_MIN_SHARE_OF_BOUND = 0.75
# The residual kernel's least share of its byte bound at the DDIM's largest
# residual map, (128, 128, 128, 64) in bf16 (92% measured on an H100 80GB
# HBM3 at 700 W).
RESIDUAL_MIN_SHARE_OF_BOUND = 0.85
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
# Below S = 256 keys (SD-2.1's inner levels: S = 64, 16, 4) the plain
# version's rounding of the normalised p to bf16 is no longer small (p up to
# ~1): its own error against float64 reaches 1.5e-2 per element, beyond
# ATTN_TOL, while the kernel's stays smaller (measured on the card: rel L2
# against float64 1.9e-3-2.1e-3 for the kernel, 2.3e-3 for the plain
# version).  There a bf16 kernel is held by relative L2 against the plain
# version (ATTN_SMALL_S_REL_L2, as the backward) and must be no further from
# float64 than the plain version is.
ATTN_SMALL_S = 256
ATTN_SMALL_S_REL_L2 = 5e-3
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
    "flash_attn_fwd": "bf16 (D = 8, and D = 64 below WGMMA_MIN_S): mma.sync m16n8k8 QK^T / "
                      "m16n8k16 PV, one warp per 16 q rows, online softmax on the accumulator "
                      "fragments, k/v by cp.async double buffer + ldmatrix; f32: CUDA-core FMA",
    "flash_attn_fwd_wgmma": "bf16 D = 64 from WGMMA_MIN_S tokens: a producer warpgroup "
                            "(setmaxnreg 24) issues TMA loads of 128-key k/v tiles (4-D maps "
                            "over the strided qkv slices, 128-byte swizzle) into a 3-stage "
                            "mbarrier ring; two consumer warpgroups of 64 q rows (240 "
                            "registers) run S = QK^T as m64n128k16 with q * scale in "
                            "registers, the online softmax on the accumulators, O += PV as "
                            "m64n64k16 with P in registers and v read transposed; the next "
                            "tile's QK^T and this tile's PV issued together, the two "
                            "warpgroups unsynchronised",
    "flash_attn_fwd_wgmma_d72": "bf16 D = 72 (DiT-XL/2), forward only, every S: the D = 64 "
                                "warpgroup forward with a 16-column tail tile per k/v tile "
                                "(32-byte swizzle, TMA zero fill past column 72), Q K^T "
                                "contracted over 80 in shared memory, P V as m64n64k16 plus "
                                "m64n16k16",
    "flash_attn_bwd": "bf16 (D = 8, and D = 64 below WGMMA_MIN_S): two mma.sync kernels (dq "
                      "per q tile; dk/dv per key tile from S^T = K Q^T), p recomputed from "
                      "the saved lse, no atomics; f32: CUDA-core FMA",
    "flash_attn_bwd_wgmma": "bf16 D = 64 from WGMMA_MIN_S tokens: two warpgroup kernels, each "
                            "a TMA producer and two ping-pong consumer warpgroups over a "
                            "3-stage ring of 64-row tiles: dq per 128 q rows (S, dP as "
                            "m64n64k16 over k/v K-major, dS K over k transposed; writes q * "
                            "scale and the padded lse/delta rows), then dk/dv per 128 keys "
                            "(S^T, dP^T over q*scale/g K-major, dV += P^T G and dK += dS^T Q "
                            "transposed); fixed order, no atomics",
    "adaln_norm": "DiT's sub-layer boundary in one pass: a warp a row of 1152, each lane 4-5 "
                  "16-byte vectors of x and y in registers, x' = x + gate y rounded once and "
                  "written, mean and centred squares over the stored x' by warp shuffles, z = "
                  "LN(x') (1 + scale) + shift rounded once; the [B, C] rows through L1 at "
                  "their row stride; 8 warps a block on consecutive rows, 2 rows a warp, 64 "
                  "registers",
    "residual_bias": "a ResnetBlock's residual with conv2's and the shortcut's biases: a "
                     "thread 4 16-byte vectors of x and h 256 vectors apart (all loads issued "
                     "first), ((x + h) + bias) + bias2 in f32 rounded once, the [C] biases "
                     "through the read-only cache",
    "group_norm_silu": "one launch: a (sample, channel slice of whole groups) tile split over "
                       "a thread-block cluster, each block's rows in shared memory by TMA "
                       "boxes, f32 sums as the boxes land, combined in rank order through "
                       "distributed shared memory, normalised from shared memory: one HBM "
                       "read of x",
    "group_norm_silu_bwd": "one launch holding x and g by TMA: a block takes one channel "
                           "slice of several whole samples (small maps, the call in one "
                           "wave) or of a cluster's share of one sample's rows (large maps); "
                           "per-(sample, channel) sums of dz and dz*x, the per-channel "
                           "coefficients in shared memory (80 registers a thread, three "
                           "blocks an SM), dx from shared memory; dscale/dbias per block in "
                           "sample order, then over the sample groups in order by the last "
                           "block of each channel slice (atomic ticket), all its threads",
    "group_norm_silu_stream": "three launches for maps no cluster plan fits: split f32 "
                              "sums of x and x^2 per channel (gn_stats), a fixed-order "
                              "combine per group, a second read of x that normalises: 2 "
                              "reads + 1 write against the bound's 1 + 1",
    "group_norm_silu_stream_bwd": "two launches: split sums of dz and dz*x^ per channel, "
                                  "added over clusters of 8 splits through distributed "
                                  "shared memory; the last block of each sample (a ticket) "
                                  "adds the clusters' sums in order and computes the "
                                  "group's coefficients, the last sample dscale/dbias in "
                                  "sample order; then a second read of x and g for dx",
}
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP = 32, 10, 2
# The guided step's model output and input gradient, kernels against plain
# versions, use FORWARD_REL_L2_TOL and GRAD_REL_L2_TOL (bf16 through the same
# 41 GroupNorms and 6 attentions, forward and backward).  Sample 0's input
# gradient alone against in a batch of 4, relative L2: cuDNN may pick other
# convolution algorithms by batch, so bf16 roundings differ as they do
# between the kernel and plain paths.
GUIDED_BATCH_REL_L2_TOL = 2e-2
# The same in float32 (f32 kernels, TF32 off), where only summation order
# differs: a kernel that mixed samples would show here.
GUIDED_BATCH_F32_REL_L2_TOL = 1e-4
# InceptionV3 on the card against the CPU, f32 with TF32 off, relative L2 of
# features and logits: f32 convolutions summed in other orders.
INCEPTION_REL_L2_TOL = 1e-3
CMP_PER_CLASS, CMP_STEPS = 32, 10
GN_PTXAS = {}  # ptxas -v of the GroupNorm library's functions, from the build phase
KERNEL_NAMES = ("flash_attn_fwd", "flash_attn_bwd", "group_norm_silu", "group_norm_silu_bwd")
# The residual kernel's launches and its plain calls: a ResnetBlock that
# defers its conv biases makes one call
RESIDUAL_KEYS = ("residual_bias", "residual_bias_plain_calls")
# The SD paths' launch counts: the kernels, those of the attention kernels
# that took the warpgroup design (bf16, D = 64, S >= WGMMA_MIN_S: a subset
# of flash_attn_fwd / flash_attn_bwd), the streaming GroupNorm variant, the
# counted attention_plain route (cross-attention) and the VAE's single-head
# attention.
WGMMA_KEYS = ("flash_attn_fwd_wgmma", "flash_attn_bwd_wgmma")
SD_KEYS = KERNEL_NAMES + WGMMA_KEYS + ("group_norm_silu_stream", "group_norm_silu_stream_bwd",
                                       "attention_plain_route", "single_head_attention")
# (batch, image px): bench.py::bench_sd(16, 64) and bench_sd(64, 8)'s shapes
SD_RUNS = {"sd_path": (64, 128), "sd_path_512": (8, 512)}
SD_CMP_BATCH = 32
# Full-width SD forward and guided step, kernels against plain versions,
# relative L2: bf16 through 61 GroupNorms, 16 self-attentions and their
# backward (as FORWARD_REL_L2_TOL and GRAD_REL_L2_TOL); in f32, f32 rounding
# through the same layers (as the card tests' UNet gradients, 1e-3).
SD_F32_REL_L2_TOL = 1e-3
# bf16 forward: the kernel path's distance to the f32 plain output at most
# this multiple of the bf16 plain path's (each rounds differently, neither
# is the reference).
SD_BF16_VS_PLAIN = 1.25
# The SD train step (bf16 compute) against the same step in f32: the kernel
# path's loss, gradient norm and per-component gradient distances at most
# SD_BF16_VS_PLAIN times the plain path's, or this relative floor where the
# plain path's distance is below it (a loss both paths hit to a few bf16
# ulps).  Remat repeats the same forward kernels on the same inputs: its
# loss equals the step's without remat to f32 rounding of the loss's sum,
# and its gradients are held as the kernel path's.
SD_TRAIN_FLOOR = 1e-3
SD_REMAT_LOSS_REL = 1e-6
# The serving engine: a partial request's rows, and timed full requests per
# op after the checked one.  A replay runs the eager op's kernels on the
# same inputs and every kernel is deterministic, so replays are held
# bit-equal to eager runs.
SERVE_PARTIAL = 5
SERVE_KEYS = ("flash_attn_fwd", "group_norm_silu", "group_norm_silu_stream",
              "flash_attn_fwd_wgmma")
# Data parallelism: two ranks of one card over gloo, 3 train steps.  World 2
# against world 1 runs other batch sizes, so cuDNN may pick other convolution
# algorithms: bf16 train steps are held by grad_check's rule (GRAD_REL_L2_TOL
# per gradient; parameters at most 2.01 lr apart, at most 1% of elements by
# more than lr / 10), and the f32 paths (TF32 off) by f32 rounding through
# 10 sampler steps: Evaluator features by relative L2, comparison images by
# max abs on [0, 1].  The comparison's images are held against world 1 at
# the ranks' batch (16: the same calls on the same rows), not at 32: DDIB
# grows a denoiser call's f32 rounding (6e-6 between batch 16 and 32) 3-4x
# a generation call, to ~0.1 on [0, 1], as much as it grows a one-ulp
# nudge of the images at one batch, under deterministic cuDNN too and on
# the CPU (phendiff_tpu_torch/tools/ddib_batch_gap.py, run on an H100 80GB
# HBM3 at 700.00 W).  grad_check's 2.01 lr
# holds one step; an Adam step moves an element by at most ~1.01 lr
# (|m_hat| / sqrt(v_hat) <= 1.0013 at step 2 with the default betas), so
# after DP_STEPS steps two runs are at most DP_STEPS x 2.01 lr apart.
DP_WORLD, DP_STEPS = 2, 3
DP_FEATURES_REL_L2_TOL = 1e-4
DP_IMAGES_MAX_ABS_TOL = 1e-3
DP_WORKER_TIMEOUT_S = 600
# The trained-model round trip (phase 27): training steps at 64 px chosen
# from tools/trained_round_trip.py --quick on the card (25 to 400 steps all
# passed reco_err's 0.05; 100 steps took 10 s), and the phase's time budget.
RECO_TRAIN_STEPS, RECO_BUDGET_S = 100, 60
# Tensor parallelism (phase 28): one replica over a model axis of 2, both
# ranks on the one card over gloo; the SD forward's batch and dtypes (f32
# holds the shards to f32 rounding, bf16 is what SD trains in).
TP_WORLD, TP_SD_BATCH = 2, 8
TP_SD_DTYPES = {"f32": "float32", "bf16": "bfloat16"}
TP_WORKER_TIMEOUT_S = 600
# The stage-per-device SD route (phase 29): the segmented forward at batch 8
# (bf16, bit-equal to the monolith), four microbatches through the placed
# stages in f32 against the whole batch (f32 rounding of other batch
# sizes), the input VJP at batch 4 in f32 against autograd through the
# monolith (f32 sums in another order through 16 attentions and 61
# GroupNorms), the train step in each clip mode at TRAIN_BATCH against the
# one-program step by grad_check's rule (cache_bf16: the cached gradients
# round to bf16 before the update, so up to twice the share of elements
# may move by more than lr / 10), then the CLI and the comparison (f32
# images within SEG_CMP_LEVELS uint8 levels of the one-program route's).
SEG_FWD_BATCH, SEG_VJP_BATCH, SEG_MICROBATCHES, SEG_STEPS = 8, 4, 4, 3
SEG_PP_REL_L2, SEG_VJP_REL_L2 = 1e-5, 1e-4
SEG_CLIP_MODES = {"recompute": ("recompute", None), "cache": ("cache", None),
                  "cache_bf16": ("cache", "bfloat16")}
SEG_SHARE = {"recompute": 1e-2, "cache": 1e-2, "cache_bf16": 2e-2}
SEG_CMP_BATCH, SEG_CMP_LEVELS, SEG_BUDGET_S = 8, 1, 120


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
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events
    (host time included where it exceeds the device's)."""
    from phendiff_tpu_torch.obs.profiling import events_ms

    return events_ms(fn, iters, warmup)


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn`` with no host time: ``iters`` calls
    captured in one CUDA graph, replayed ``replays`` times."""
    from phendiff_tpu_torch.obs import profiling

    return profiling.graph_ms(fn, iters, replays)


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
    # the bf16 attention kernels: mma.sync (*_mma_kernel<D>, D = 8 and 64: the
    # forward, dq and dk/dv) and the warpgroup kernels (*_wgmma_kernel: the
    # forward at D = 64 and 72, dq and dk/dv at D = 64); none may spill or
    # keep a stack frame (local memory, which ptxas does not count as a spill)
    mma = {fn: props for name in ("flash_attn_fwd", "flash_attn_bwd")
           for fn, props in ptxas[name].items() if "_mma_kernel" in fn}
    wgmma = {fn: props for name in ("flash_attn_fwd", "flash_attn_bwd")
             for fn, props in ptxas[name].items() if "_wgmma_kernel" in fn}
    spills = sorted(fn for fn, props in {**mma, **wgmma}.items()
                    if props.get("spill_bytes", 1) != 0 or props.get("stack_bytes", 1) != 0)
    gn = ptxas["group_norm_silu"]
    GN_PTXAS.update(gn)
    emit({"phase": "build", "seconds": seconds, "kernels": list(_build.KERNELS),
          "ptxas": ptxas, "mma_kernels": len(mma), "wgmma_kernels": len(wgmma),
          "tensor_core_kernels_spilling": spills, "group_norm_kernels": gn,
          "group_norm_kernels_spilling": sorted(fn for fn, p in gn.items()
                                                if p.get("spill_bytes", 0)),
          "adaln_norm_kernels_spilling": sorted(fn for fn, p in ptxas["adaln_norm"].items()
                                                if p.get("spill_bytes", 0))})
    if len(mma) != 6 or len(wgmma) != 4 or spills:
        fail(f"tensor-core attention kernels: expected 6 mma.sync and 4 wgmma kernels without "
             f"spills or stack frames, got {mma} and {wgmma}")
    if any(p.get("spill_bytes", 0) for p in gn.values()):
        fail(f"GroupNorm kernels spill: {gn}")
    # five row widths (vectors a lane) x three variants x bf16 and f32
    adaln = {fn: p for fn, p in ptxas["adaln_norm"].items() if "adaln_norm_kernel" in fn}
    if len(adaln) != 30 or any(p.get("spill_bytes", 0) for p in adaln.values()):
        fail(f"DiT boundary kernels: expected 30 without spills, got {adaln}")
    # bf16 and f32, with one bias and with two
    residual = ptxas["residual_bias"]
    if len(residual) != 4 or any(p.get("spill_bytes", 0) for p in residual.values()):
        fail(f"residual kernels: expected 4 without spills, got {residual}")


def bound_unit(t_bytes, flops, flop_rate, exps, sfu_rate, dtype) -> str:
    """What bounds a call: "bytes", "exp" (the special-function unit), or
    the products' unit ("tensor cores" in bf16, "f32 FMA" in f32)."""
    import torch

    if t_bytes >= max(flops / flop_rate, exps / sfu_rate):
        return "bytes"
    if exps / sfu_rate > flops / flop_rate:
        return "exp"
    return "tensor cores" if dtype == torch.bfloat16 else "f32 FMA"


def attn_launches(direction: str) -> dict:
    """The attention kernels' launch counters in ``direction`` ("fwd" or
    "bwd"): all their launches, and those of the warpgroup design."""
    from phendiff_tpu_torch.ops.routes import launch_counts

    counts = launch_counts()
    return {"all": counts[f"flash_attn_{direction}"],
            "wgmma": counts[f"flash_attn_{direction}_wgmma"]}


def attn_launches_for(design: str, n: int) -> dict:
    """``attn_launches``' change over ``n`` calls that take ``design``."""
    return {"all": n, "wgmma": n if design == "wgmma" else 0}


def attention_check(torch, b, s, h, d, sfu_rate, dtype_name="bfloat16"):
    import torch.nn.functional as F

    from phendiff_tpu_torch.ops.flash_attention import (
        attention_design, attention_plain, flash_attention)

    dtype = getattr(torch, dtype_name)
    tol = ATTN_TOL[dtype_name]
    design = attention_design(s, d, dtype)
    g = torch.Generator(device="cuda").manual_seed(1234 + d)
    # q, k, v as the UNet hands them over: column slices of one fused qkv
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    before = attn_launches("fwd")
    out = flash_attention(q, k, v)
    again = flash_attention(q, k, v)
    torch.cuda.synchronize()
    took = {k_: n - before[k_] for k_, n in attn_launches("fwd").items()}
    ref = attention_plain(q, k, v)
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(out, again))
    small_s = {}
    if dtype == torch.bfloat16 and s < ATTN_SMALL_S:
        exact = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(torch.einsum(
            "bqhd,bkhd->bhqk", q.double() * d**-0.5, k.double()), -1), v.double())
        small_s = {"rel_l2": rel_l2(out, ref), "tol_rel_l2": ATTN_SMALL_S_REL_L2,
                   "kernel_vs_f64_rel_l2": rel_l2(out.double(), exact),
                   "plain_vs_f64_rel_l2": rel_l2(ref.double(), exact)}
        close = (small_s["rel_l2"] <= ATTN_SMALL_S_REL_L2
                 and small_s["kernel_vs_f64_rel_l2"] <= small_s["plain_vs_f64_rel_l2"])
        del exact
    else:
        close = torch.allclose(out.float(), ref.float(), **tol)
    ok = out.dtype == dtype and close and deterministic and took == attn_launches_for(design, 2)
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
        "design": design, "launches": took,
        "shape": {"B": b, "S": s, "H": h, "D": d}, "max_abs_err": err, "ok": bool(ok),
        "deterministic": deterministic, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, **({"small_s": small_s} if small_s else {}),
        "bytes": n_bytes, "flops": flops, "exps": exps,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": bound_unit(t_bytes, flops, flop_rate, exps, sfu_rate, dtype),
    }
    emit(rec)
    return rec


def gn_plan_record(torch, b, s, c, groups, act, backward=False):
    """The bf16 call's launch plan, the clusters of it the card holds at once
    and the registers a thread of its kernel (``ptxas -v``)."""
    from phendiff_tpu_torch.ops import gn_kernels

    plan = gn_kernels.gn_plan(s, c, groups, 2, backward, b if backward else 1)
    # the forward's instantiation without the addend (ADD = false)
    mangled = (f"gn_{'bwd' if backward else 'fwd'}_clusterI13__nv_bfloat16Lb{int(act == 'silu')}E"
               + ("" if backward else "Lb0EE"))
    regs = [p.get("registers") for fn, p in GN_PTXAS.items() if mangled in fn]
    return {"plan": plan._asdict(), "max_active_clusters": gn_kernels.max_active_clusters(
        b, s, c, groups, torch.bfloat16, act, backward), "registers": regs[0] if regs else None}


def gn_check(torch, b, s, c, groups, act, iters=20, dtype_name="bfloat16"):
    import torch.nn.functional as F

    from phendiff_tpu_torch.ops.gn_kernels import (
        _launch, fused_group_norm, group_norm_plain, group_stats_plain)

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(s + c)
    x = (torch.randn(b, s, c, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    scale = torch.randn(c, generator=g, device="cuda")
    bias = torch.randn(c, generator=g, device="cuda")
    kw = dict(num_groups=groups, eps=1e-5, act=act, out_dtype=dtype)
    before = fused_group_norm.launches
    out = fused_group_norm(x, scale, bias, **kw)
    torch.cuda.synchronize()
    again = fused_group_norm(x, scale, bias, **kw)
    torch.cuda.synchronize()
    one_launch = fused_group_norm.launches - before == 2
    ref = group_norm_plain(x, scale, bias, **kw)
    # the [B, G] mean and rstd the forward writes for the backward
    stats = _launch(x, scale, bias, groups, 1e-5, act, dtype)[1:]
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
    sb, bb = scale.to(dtype), bias.to(dtype)

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
    n_bytes = b * s * c * 2 * x.element_size() + 2 * c * 4
    flops = 10 * b * s * c
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    rec = {
        "phase": "kernel_check", "kernel": "group_norm_silu", "dtype": dtype_name,
        "shape": {"B": b, "S": s, "C": c, "G": groups, "act": act}, "max_abs_err": err,
        "ok": bool(ok), "deterministic": bool(torch.equal(out, again)), "tol": GN_TOL,
        "one_launch_per_call": one_launch, "stats_ok": stats_ok,
        "stats_max_rel_err": max(float(((a - r).abs() / r.abs()).max())
                                 for a, r in zip(stats, stats_ref)),
        "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_channels_last_ms": library_channels_last_ms, "bytes": n_bytes,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        **(gn_plan_record(torch, b, s, c, groups, act) if dtype == torch.bfloat16 else {}),
    }
    emit(rec)
    return rec


def gn_addend_check(torch, b, s, c, groups, iters=20):
    """The forward kernel with an addend (a ResnetBlock's time embedding)
    against itself on the materialised sum: output, mean and rstd bit-equal;
    device times of the addend call, of the broadcast add plus the call that
    it replaces, and of the same call without the addend."""
    from phendiff_tpu_torch.ops.gn_kernels import _launch, fused_group_norm

    g = torch.Generator(device="cuda").manual_seed(s + c + 1)
    x = (torch.randn(b, s, c, generator=g, device="cuda") * 2 + 0.5).to(torch.bfloat16)
    addend = torch.randn(b, c, generator=g, device="cuda").to(torch.bfloat16)
    scale = torch.randn(c, generator=g, device="cuda")
    bias = torch.randn(c, generator=g, device="cuda")
    args = (scale, bias, groups, 1e-5, "silu", torch.bfloat16)
    before = fused_group_norm.addend_launches
    got = _launch(x, *args, addend)
    want = _launch(x + addend[:, None, :], *args)
    torch.cuda.synchronize()
    ok = (fused_group_norm.addend_launches - before == 1
          and all(torch.equal(u, w) for u, w in zip(got, want)))
    rec = {"phase": "kernel_check", "kernel": "group_norm_silu_addend",
           "shape": {"B": b, "S": s, "C": c, "G": groups, "act": "silu"}, "ok": bool(ok),
           "ms": graph_ms(lambda: _launch(x, *args, addend), iters),
           "add_then_gn_ms": graph_ms(lambda: _launch(x + addend[:, None, :], *args), iters),
           "gn_ms": graph_ms(lambda: _launch(x, *args), iters),
           "bound_ms": 1e3 * (2 * x.nbytes + addend.nbytes) / HBM_BYTES_PER_S}
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
    design = fa.attention_design(s, d, dtype)
    gen = torch.Generator(device="cuda").manual_seed(4321 + d)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    scale = d**-0.5
    o, lse = fa._launch(q, k, v, scale, with_lse=True)
    before = attn_launches("bwd")
    got = fa.flash_attention_bwd(q, k, v, o, lse, g, scale)
    again = fa.flash_attention_bwd(q, k, v, o, lse, g, scale)
    torch.cuda.synchronize()
    took = {k_: n - before[k_] for k_, n in attn_launches("bwd").items()}
    ref = fa.flash_attention_bwd_plain(q, k, v, g, scale)
    torch.cuda.synchronize()
    errs = {n: rel_l2(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
    max_err = max(max_abs(a, r) for a, r in zip(got, ref))
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (all(a.dtype == dtype and bool(torch.isfinite(a).all()) for a in got)
          and max(errs.values()) <= BWD_REL_L2_TOL[dtype_name] and deterministic
          and took == attn_launches_for(design, 2))
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
    # the two-kernel design's own floor: p recomputed in both kernels, so 7
    # products and 2 exps a score
    t_design = max(t_bytes, 1.4 * flops / flop_rate, 2 * exps / sfu_rate)
    rec = {
        "phase": "kernel_check", "kernel": "flash_attn_bwd", "dtype": dtype_name,
        "design": design, "launches": took,
        "shape": {"B": b, "S": s, "H": h, "D": d}, "max_abs_err": max_err, "rel_l2": errs,
        "tol_rel_l2": BWD_REL_L2_TOL[dtype_name], "ok": bool(ok),
        "deterministic": deterministic, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bytes": n_bytes, "flops": flops,
        "exps": exps, "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": bound_unit(t_bytes, flops, flop_rate, exps, sfu_rate, dtype),
        "design_floor_ms": 1e3 * t_design,
    }
    emit(rec)
    return rec


def read_launches(keys=KERNEL_NAMES) -> dict:
    """The launch counters of ``keys`` (``ops.routes.launch_counts``)."""
    from phendiff_tpu_torch.ops.routes import launch_counts

    counts = launch_counts()
    return {k: counts[k] for k in keys}


def launches_for(forwards: int, backwards: int) -> dict:
    """The four kernels' launches for UNet forwards and input/parameter
    backwards of the ``super_small`` model."""
    return dict(zip(KERNEL_NAMES, (6 * forwards, 6 * backwards, 41 * forwards, 41 * backwards)))


def write_image_folder(root: str, per_class: int) -> str:
    """Two class folders of random 128 px PNGs drawn from ``SEED``."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    for cls in ("DMSO", "drug"):
        os.makedirs(os.path.join(root, cls))
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 255, (RES, RES, 3), dtype=np.uint8)).save(
                os.path.join(root, cls, f"{i:03d}.png"))
    return root


def train_parts(torch, pipe, proba_uncond=0.1):
    """What ``bench.py``'s ``bench_train`` builds, in the port: the model
    apply (bf16 compute) and embedding functions over an f32 copy of the
    pipeline's parameters, its schedule, the train config, and the model
    (built on the meta device) that ``model_apply`` calls."""
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
    return model_apply, embed_fn, params, pipe.schedule, cfg, model


def phase_grad_check(torch, pipe):
    from phendiff_tpu_torch.ops.routes import plain_kernels
    from phendiff_tpu_torch.train.train_loop import (
        diffusion_loss, init_train_state, make_draws, make_optimizer, make_train_step)

    model_apply, embed_fn, params, schedule, cfg, _ = train_parts(torch, pipe)
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
    worst = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:5]
    rec = {
        "phase": "grad_check", "batch": 4, "n_params": len(grads_p),
        "loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
        "loss_rel_err": abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
        "grad_rel_l2_max": max(grad_errs.values()), "grad_rel_l2_worst": worst,
        "tol_rel_l2": GRAD_REL_L2_TOL, "zero_or_nonfinite_grads": bad, "lr": lr,
        "params_after_step": param_rule(state_k.params, state_p.params, lr),
    }
    emit(rec)
    if (bad or rec["grad_rel_l2_max"] > GRAD_REL_L2_TOL or rec["loss_rel_err"] > 1e-2
            or not rec["params_after_step"]["ok"]):
        fail("grad_check: the kernel path's gradients disagree with the plain path")


def phase_train_path(torch, pipe, env):
    from phendiff_tpu_torch.ops.routes import launch_counts, reset_launch_counts
    from phendiff_tpu_torch.train.checkpoints import CheckpointManager
    from phendiff_tpu_torch.train.train_loop import (
        init_train_state, make_draws, make_optimizer, make_train_step)

    model_apply, embed_fn, params, schedule, cfg, _ = train_parts(torch, pipe)
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
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    want = launches_for(TRAIN_STEPS, TRAIN_STEPS)
    g_copies = launch_counts()["group_norm_bwd_g_copies"]
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
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.train.train_loop import TrainConfig
    from phendiff_tpu_torch.train.trainer import RunPaths, TrainerConfig, for_ddim_pipeline

    root = tempfile.mkdtemp(prefix="phd_trainer_")
    write_image_folder(os.path.join(root, "data"), 48)
    cfg = TrainerConfig(
        train_data_dir=os.path.join(root, "data"), definition=(RES, RES),
        train_batch_size=TRAIN_BATCH, num_epochs=1, eval_every_epochs=1,
        checkpointing_steps=1000, mixed_precision="bf16", metrics_flush_every=3,
        compute_metrics=False,  # the evaluator phase runs the Evaluator
        train=TrainConfig(proba_uncond=0.1),
    )
    paths = RunPaths.create(root, "exp", "run0")
    trainer = for_ddim_pipeline(pipe, cfg, paths)
    reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
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
    want = launches_for(3, 3)
    if (state.step != 3 or rec["logged_steps"] != [1, 2, 3] or not same
            or not all(math.isfinite(x) for x in rec["losses"]) or launches != want):
        fail(f"trainer run: {rec}")
    return rec


def phase_guided_check(torch, pipe):
    """One guided step at batch 4 from a fixed latent, weights frozen; the
    batch-independence check also in float32."""
    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.ops.routes import plain_kernels, reset_launch_counts
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.pipelines.transfer import guided_gradient

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    x = torch.randn(4, RES, RES, 3, generator=gen, device="cuda")
    target = torch.randn(4, RES, RES, 3, generator=gen, device="cuda")
    emb = pipe.class_embeddings(torch.tensor([1, 0, 1, 0]))
    t = int(S.timestep_pairs(pipe.scheduler_config, STEPS)[0][1])  # the 2nd generation step
    den = pipe.denoiser_fn()
    with pipe.frozen():
        reset_launch_counts()
        out_k, grad_k = guided_gradient(den, pipe.schedule, x, t, target, emb)
        torch.cuda.synchronize()
        launches = read_launches()
        with plain_kernels():
            out_p, grad_p = guided_gradient(den, pipe.schedule, x, t, target, emb)
        _, grad_1 = guided_gradient(den, pipe.schedule, x[:1], t, target[:1], emb[:1])
        torch.cuda.synchronize()
    pipe32 = ConditionalDDIMPipeline.init_random(pipe.unet_config, pipe.scheduler_config,
                                                 seed=SEED, device="cuda")
    with pipe32.frozen():
        den32 = pipe32.denoiser_fn()
        _, g4 = guided_gradient(den32, pipe32.schedule, x, t, target, emb)
        _, g1 = guided_gradient(den32, pipe32.schedule, x[:1], t, target[:1], emb[:1])
    rec = {
        "phase": "guided_check", "batch": 4, "t": t, "launches_per_step": launches,
        "model_out_rel_l2": rel_l2(out_k, out_p), "grad_rel_l2": rel_l2(grad_k, grad_p),
        "grad_max_abs_err": max_abs(grad_k, grad_p), "grad_abs_max": float(grad_p.abs().max()),
        "tol_rel_l2": {"model_out": FORWARD_REL_L2_TOL, "grad": GRAD_REL_L2_TOL,
                       "batch_independence": GUIDED_BATCH_REL_L2_TOL,
                       "batch_independence_f32": GUIDED_BATCH_F32_REL_L2_TOL},
        "sample0_alone_vs_batch_rel_l2": rel_l2(grad_1[0], grad_k[0]),
        "sample0_alone_vs_batch_rel_l2_f32": rel_l2(g1[0], g4[0]),
        "finite": bool(torch.isfinite(out_k).all() and torch.isfinite(grad_k).all()),
        "param_grads_left": sum(p.grad is not None for p in pipe.model.parameters()),
        "params_require_grad_after": all(p.requires_grad for p in pipe.model.parameters()),
    }
    emit(rec)
    if (not rec["finite"] or rec["model_out_rel_l2"] > FORWARD_REL_L2_TOL
            or rec["grad_rel_l2"] > GRAD_REL_L2_TOL
            or rec["sample0_alone_vs_batch_rel_l2"] > GUIDED_BATCH_REL_L2_TOL
            or rec["sample0_alone_vs_batch_rel_l2_f32"] > GUIDED_BATCH_F32_REL_L2_TOL
            or rec["param_grads_left"] or float(grad_k.abs().max()) == 0.0):
        fail(f"guided_check: {rec}")
    if launches != launches_for(1, 1):
        fail(f"guided step launch counts {launches} != expected {launches_for(1, 1)}")
    return rec


def phase_guided_path(torch, pipe, images, src, tgt, env):
    """``guided_inverted_start`` at batch 32, 50 steps, weights frozen."""
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.pipelines.conditional_ddim import ddim_invert
    from phendiff_tpu_torch.pipelines.transfer import check_gaussianity, guided_inverted_start

    den = pipe.denoiser_fn()
    with pipe.frozen():
        guided_inverted_start(den, pipe.schedule, images, src, tgt, num_inference_steps=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = guided_inverted_start(den, pipe.schedule, images, src, tgt,
                                    num_inference_steps=STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        latents = ddim_invert(den, pipe.schedule, images, src, num_inference_steps=STEPS)
        torch.cuda.synchronize()
        t_invert = time.perf_counter() - t0
    gauss = {k: float(v) for k, v in check_gaussianity(latents).items()}
    want = launches_for(2 * STEPS, STEPS)
    rec = {
        "phase": "guided_path", "batch": BATCH, "res": RES, "steps": STEPS, "seconds": dt,
        "transfers_per_s": BATCH / dt, "inversion_seconds": t_invert,
        "ms_per_guided_step": 1e3 * (dt - t_invert) / STEPS, "peak_mem_gib": peak,
        "launches": launches, "launches_expected": want, "gaussianity": gauss,
        "finite": bool(torch.isfinite(out).all()), "shape": list(out.shape),
        "out_mean": float(out.mean()), "out_std": float(out.std()),
        "device": env["device"], "nvidia_smi": env["nvidia_smi"],
    }
    emit(rec)
    if not rec["finite"] or tuple(out.shape) != (BATCH, RES, RES, 3):
        fail("guided path: output not finite or of the wrong shape")
    if not all(math.isfinite(v) for v in gauss.values()):
        fail(f"guided path: non-finite latent moments {gauss}")
    if launches != want:
        fail(f"guided path launch counts {launches} != expected {want}")
    return rec


def phase_cfg_path(torch, pipe, images, tgt, env):
    """``cfg_forward_start`` at batch 32, 50 steps, frac 0.5, guidance 2.5."""
    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.pipelines.transfer import cfg_forward_start

    den = pipe.denoiser_fn()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    cfg_forward_start(den, pipe.schedule, images, tgt, gen, num_inference_steps=4)
    torch.cuda.synchronize()
    forwards = len(S.timestep_pairs(pipe.scheduler_config, STEPS, 0.5)[0])
    reset_launch_counts()
    t0 = time.perf_counter()
    out = cfg_forward_start(den, pipe.schedule, images, tgt, gen, guidance_scale=2.5,
                            frac_diffusion_skipped=0.5, num_inference_steps=STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    want = launches_for(forwards, 0)
    rec = {
        "phase": "cfg_path", "batch": BATCH, "res": RES, "steps": STEPS,
        "forwards_at_batch_64": forwards, "seconds": dt, "transfers_per_s": BATCH / dt,
        "ms_per_forward_b64": 1e3 * dt / forwards, "launches": launches,
        "launches_expected": want, "finite": bool(torch.isfinite(out).all()),
        "device": env["device"], "nvidia_smi": env["nvidia_smi"],
    }
    emit(rec)
    if forwards != STEPS // 2 or launches != want or not rec["finite"]:
        fail(f"cfg path: {rec}")
    return rec


def phase_inception(torch):
    """The random-init extractor on 32 images of 128 px (resized to 299),
    and the card against the CPU on 4 of them."""
    from phendiff_tpu_torch.metrics.inception import InceptionExtractor

    ext = InceptionExtractor(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    imgs = torch.rand(BATCH, RES, RES, 3, generator=gen, device="cuda")
    ms = cuda_ms(lambda: ext(imgs), iters=5, warmup=2)
    f_card, l_card = ext(imgs[:4])
    f_cpu, l_cpu = InceptionExtractor(device="cpu")(imgs[:4].cpu())
    rec = {
        "phase": "inception", "batch": BATCH, "res_in": RES, "res": ext.resolution(),
        "pretrained": ext.pretrained, "ms_per_batch": ms,
        "features_rel_l2_card_vs_cpu": rel_l2(f_card.cpu(), f_cpu),
        "logits_rel_l2_card_vs_cpu": rel_l2(l_card.cpu(), l_cpu),
        "tol_rel_l2": INCEPTION_REL_L2_TOL, "shapes": [list(f_card.shape), list(l_card.shape)],
    }
    emit(rec)
    if (max(rec["features_rel_l2_card_vs_cpu"], rec["logits_rel_l2_card_vs_cpu"])
            > INCEPTION_REL_L2_TOL or rec["shapes"] != [[4, 2048], [4, 1008]]):
        fail(f"inception: {rec}")
    return rec


def phase_comparison(torch, pipe, env):
    """``ComparisonExperiment`` in a temporary directory: the random
    pipeline saved, a 2 x 32 folder of 128 px PNGs, all four methods at 10
    steps and batch 32, FID/ISC/KID (KID over subsets of 16)."""
    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.experiments.comparison import (
        METHODS, ComparisonConfig, ComparisonExperiment)
    from phendiff_tpu_torch.ops.routes import reset_launch_counts

    root = tempfile.mkdtemp(prefix="phd_cmp_")
    pipe.save_pretrained(os.path.join(root, "pipe"))
    data = write_image_folder(os.path.join(root, "data"), CMP_PER_CLASS)
    cfg = ComparisonConfig.from_dict({
        "output_dir": os.path.join(root, "out"), "pipelines": {"ddim": os.path.join(root, "pipe")},
        "dataset_train": data, "definition": [RES, RES], "methods": list(METHODS),
        "method_params": {m: {"batch_size": BATCH} for m in METHODS},
        "num_inference_steps": CMP_STEPS,
        "metrics": {"fid": True, "isc": True, "kid": True, "kid_subset_size": 16},
    })
    exp = ComparisonExperiment(cfg, device="cuda")
    reset_launch_counts()
    t0 = time.perf_counter()
    exp.run_transfers()
    torch.cuda.synchronize()
    t_transfers = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    metrics = exp.compute_metrics()
    t_metrics = time.perf_counter() - t0
    batches = 2 * CMP_PER_CLASS // BATCH
    cfg_fwd = len(S.timestep_pairs(pipe.scheduler_config, CMP_STEPS, 0.5)[0])
    forwards = batches * (2 * CMP_STEPS * 3 + cfg_fwd)  # ddib, regeneration, guided; cfg
    want = launches_for(forwards, batches * CMP_STEPS)
    pngs = {m: len([f for _, _, fs in os.walk(os.path.join(cfg.output_dir, m)) for f in fs
                    if "_to_" in f]) for m in METHODS}
    with open(os.path.join(cfg.output_dir, "timings.json")) as f:
        timings = json.load(f)
    keys = [f"{m}/ddim/train/{k}" for m in METHODS for k in (
        "frechet_inception_distance", "inception_score_mean", "kernel_inception_distance_mean",
        "DMSO/frechet_inception_distance", "drug/kernel_inception_distance_mean")]
    rec = {
        "phase": "comparison", "batch": BATCH, "res": RES, "steps": CMP_STEPS,
        "images_per_method": 2 * CMP_PER_CLASS, "pngs_per_method": pngs,
        "transfer_seconds": t_transfers, "metrics_seconds": t_metrics,
        "images_per_s": {k: v["images_per_sec"] for k, v in timings.items()},
        "launches": launches, "launches_expected": want,
        "metrics": {k: metrics[k] for k in keys if k in metrics},
        "n_metrics": len(metrics), "missing_keys": [k for k in keys if k not in metrics],
        "metrics_finite": all(math.isfinite(v) for v in metrics.values()),
        "device": env["device"], "nvidia_smi": env["nvidia_smi"],
    }
    emit(rec)
    if (any(n != 2 * CMP_PER_CLASS for n in pngs.values()) or rec["missing_keys"]
            or not rec["metrics_finite"] or launches != want):
        fail(f"comparison: {rec}")
    return rec, data


def phase_evaluator(torch, pipe, data):
    """``Trainer.run`` with ``compute_metrics=True``: one step, then one
    eval of one batch of 32 per class at 10 steps, best model saved."""
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.train.eval_loop import EvalConfig
    from phendiff_tpu_torch.train.train_loop import TrainConfig
    from phendiff_tpu_torch.train.trainer import RunPaths, TrainerConfig, for_ddim_pipeline

    cfg = TrainerConfig(
        train_data_dir=data, definition=(RES, RES), train_batch_size=TRAIN_BATCH,
        num_epochs=1, max_train_steps=1, eval_every_epochs=1, mixed_precision="bf16",
        compute_metrics=True, train=TrainConfig(proba_uncond=0.1),
        eval=EvalConfig(nb_generated_images=BATCH, eval_batch_size=BATCH,
                        num_inference_steps=CMP_STEPS),
    )
    paths = RunPaths.create(tempfile.mkdtemp(prefix="phd_eval_"), "exp", "run0")
    trainer = for_ddim_pipeline(pipe, cfg, paths)
    reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    want = launches_for(1 + 2 * CMP_STEPS, 1)  # a train step; 10 steps a class
    with open(os.path.join(paths.run_dir, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "main_metric_mean" in r]
    loaded = ConditionalDDIMPipeline.from_pretrained(paths.full_pipeline_save, device="cuda")
    saved = all(torch.equal(p, state.ema_params[n]) for n, p in loaded.model.named_parameters())
    ev = evals[0] if evals else {}
    rec = {
        "phase": "evaluator", "seconds": dt, "evals": len(evals),
        "metrics": {k: v for k, v in ev.items() if k not in ("ts",)},
        "best_metric": trainer.best_metric, "best_model_saved": saved,
        "launches": launches, "launches_expected": want,
    }
    emit(rec)
    fids = [ev.get(f"{c}/frechet_inception_distance", float("nan")) for c in ("DMSO", "drug")]
    if (len(evals) != 1 or not all(math.isfinite(v) for v in fids)
            or not math.isfinite(ev["main_metric_mean"]) or not saved
            or trainer.best_metric != ev["main_metric_mean"] or launches != want):
        fail(f"evaluator: {rec}")
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


def predicted_launches(calls: dict, forward: bool = True, backward: bool = False) -> dict:
    """The launches one recorded forward (``ops.routes.record_calls``)
    makes on the card, by ``gn_route``, ``attention.takes_kernel`` and
    ``attention_design``, and those of its input backward."""
    import torch

    from phendiff_tpu_torch.ops.attention import takes_kernel
    from phendiff_tpu_torch.ops.flash_attention import attention_design
    from phendiff_tpu_torch.ops.gn_kernels import gn_route

    out = dict.fromkeys(SD_KEYS, 0)
    for (s, c, g, _, isz), n in calls["group_norm"].items():
        if forward:
            stream = gn_route(s, c, g, isz) == "stream"
            out["group_norm_silu_stream" if stream else "group_norm_silu"] += n
        if backward:
            stream = gn_route(s, c, g, isz, backward=True) == "stream"
            out["group_norm_silu_stream_bwd" if stream else "group_norm_silu_bwd"] += n
    for (s_q, s_kv, _, d, isz), n in calls["attention"].items():
        if takes_kernel(s_q, s_kv, d):
            out["flash_attn_fwd"] += n * forward
            out["flash_attn_bwd"] += n * backward
            dtype = torch.bfloat16 if isz == 2 else torch.float32
            if attention_design(s_q, d, dtype) == "wgmma":
                out["flash_attn_fwd_wgmma"] += n * forward
                out["flash_attn_bwd_wgmma"] += n * backward
        else:
            out["attention_plain_route"] += n * forward
    out["single_head_attention"] += calls["single_head_attention"] * forward
    return out


def add_launches(*terms) -> dict:
    """Sum of (count, launches) terms."""
    return {k: sum(n * d[k] for n, d in terms) for k in SD_KEYS}


def counting_plain_calls():
    """A context counting the calls of the kernels' plain versions on CUDA
    tensors (the kernel wrappers' CPU fallbacks; the card's paths make none)."""
    import collections
    import contextlib

    import torch

    from phendiff_tpu_torch.ops import flash_attention as fa
    from phendiff_tpu_torch.ops import gn_kernels as gk
    from phendiff_tpu_torch.ops import residual_bias as rb

    @contextlib.contextmanager
    def ctx():
        counts = collections.Counter()
        names = ((fa, "attention_plain"), (fa, "flash_attention_bwd_plain"),
                 (gk, "group_norm_plain"), (gk, "group_norm_bwd_plain"),
                 (rb, "residual_bias_plain"))
        saved = [(mod, name, getattr(mod, name)) for mod, name in names]
        for mod, name, fn in saved:
            def counted(*a, _fn=fn, _name=name, **kw):
                if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                    counts[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)
        try:
            yield counts
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    return ctx()


def gn_stream_check(torch, b, s, c, groups, act, dtype_name, sfu_rate, iters=10):
    """The streaming GroupNorm variant, forward and backward, against the
    plain versions at one shape: errors, determinism, device times (CUDA
    graphs), plain and library times and the bounds.  The forward moves 2
    reads + 1 write against the bound's 1 + 1, the backward 4 reads + 1
    write against 2 + 1."""
    import torch.nn.functional as F

    from phendiff_tpu_torch.ops import gn_kernels as gk

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(s + c + 2)
    x = (torch.randn(b, s, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    gout = torch.randn(b, s, c, generator=gen, device="cuda").to(dtype)
    scale = torch.randn(c, generator=gen, device="cuda")
    bias = torch.randn(c, generator=gen, device="cuda")
    kw = dict(num_groups=groups, eps=1e-6, act=act, out_dtype=dtype)
    tol = GN_TOL if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)

    def fwd():
        return gk._launch(x, scale, bias, groups, 1e-6, act, dtype)

    mean_r, rstd_r = gk.group_stats_plain(x, groups, 1e-6)

    def bwd():
        return gk.fused_group_norm_bwd(x, gout, scale, bias, mean_r, rstd_r, num_groups=groups,
                                       act=act)

    # both directions through the streaming variant, also where one of them
    # has a cluster plan at this shape
    route, gk.gn_route = gk.gn_route, lambda *a, **kw: "stream"

    before = (gk.fused_group_norm.stream_launches, gk.fused_group_norm_bwd.stream_launches)
    (out, mean, rstd), again = fwd(), fwd()[0]
    got, got2 = bwd(), bwd()
    torch.cuda.synchronize()
    counted = (gk.fused_group_norm.stream_launches - before[0],
               gk.fused_group_norm_bwd.stream_launches - before[1]) == (2, 2)
    ref = gk.group_norm_plain(x, scale, bias, **kw)
    ref_b = gk.group_norm_bwd_plain(x, gout, scale, bias, mean_r, rstd_r, num_groups=groups,
                                    act=act)
    torch.cuda.synchronize()
    stats_ok = all(torch.allclose(a, r, **GN_STATS_TOL) for a, r in zip((mean, rstd),
                                                                        (mean_r, rstd_r)))
    errs = {n: rel_l2(a, r) for n, a, r in zip(("dx", "dscale", "dbias"), got, ref_b)}
    dx_tol = GN_BWD_DX_REL_L2 if dtype == torch.bfloat16 else 1e-5
    deterministic = torch.equal(out, again) and all(torch.equal(a, b2)
                                                    for a, b2 in zip(got, got2))
    ok = (torch.allclose(out.float(), ref.float(), **tol) and stats_ok and deterministic
          and counted and errs["dx"] <= dx_tol and errs["dscale"] <= GN_BWD_PARAM_REL_L2
          and errs["dbias"] <= GN_BWD_PARAM_REL_L2)
    max_err, max_err_b = max_abs(out, ref), max_abs(got[0], ref_b[0])
    del again, got2, ref, ref_b
    ms, bwd_ms = graph_ms(lambda: fwd(), iters), graph_ms(lambda: bwd(), iters)
    gk.gn_route = route
    plain_ms = cuda_ms(lambda: gk.group_norm_plain(x, scale, bias, **kw), iters=3, warmup=1)
    plain_bwd_ms = cuda_ms(lambda: gk.group_norm_bwd_plain(
        x, gout, scale, bias, mean_r, rstd_r, num_groups=groups, act=act), iters=3, warmup=1)
    xc = x.transpose(1, 2).contiguous()
    sb, bb = scale.to(dtype), bias.to(dtype)

    def library(xin):
        y = F.group_norm(xin, groups, sb, bb, 1e-6)
        return F.silu(y) if act == "silu" else y

    library_ms = cuda_ms(lambda: library(xc), iters=iters)
    xg = xc.requires_grad_()
    sg, bg = sb.clone().requires_grad_(), bb.clone().requires_grad_()
    y = F.group_norm(xg, groups, sg, bg, 1e-6)
    y = F.silu(y) if act == "silu" else y
    gc = gout.transpose(1, 2).contiguous()
    library_bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, (xg, sg, bg), gc, retain_graph=True),
                             iters=iters)
    el, isz = b * s * c, x.element_size()
    n_bytes, n_bytes_b = 2 * el * isz + 2 * c * 4, 3 * el * isz + 4 * c * 4 + 2 * b * groups * 4
    t_ops = 10 * el / F32_FLOPS
    t_ops_b = max(20 * el / F32_FLOPS, (el if act == "silu" else 0) / sfu_rate)
    rec = {
        "phase": "kernel_check", "kernel": "group_norm_silu_stream", "dtype": dtype_name,
        "shape": {"B": b, "S": s, "C": c, "G": groups, "act": act},
        "max_abs_err": max_err, "bwd_max_abs_err": max_err_b, "bwd_rel_l2": errs,
        "tol": tol, "tol_bwd_rel_l2": {"dx": dx_tol, "dscale": GN_BWD_PARAM_REL_L2,
                                       "dbias": GN_BWD_PARAM_REL_L2},
        "ok": bool(ok), "stats_ok": stats_ok, "deterministic": deterministic,
        "one_count_per_call": counted,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": 1e3 * max(n_bytes / HBM_BYTES_PER_S, t_ops), "bytes": n_bytes,
        "bwd_ms": bwd_ms, "bwd_plain_ms": plain_bwd_ms, "bwd_library_ms": library_bwd_ms,
        "bwd_bound_ms": 1e3 * max(n_bytes_b / HBM_BYTES_PER_S, t_ops_b), "bwd_bytes": n_bytes_b,
        "bytes_moved_over_bound": {"forward": "2 reads + 1 write vs 1 + 1",
                                   "backward": "4 reads + 1 write vs 2 + 1"},
    }
    emit(rec)
    return rec


def sd_streamed_calls() -> set:
    """(S, C, G, act, itemsize) of every GroupNorm call without a cluster plan,
    in either direction, in the configs of the CPU fault test (the four
    denoiser presets, full-width SD-2.1 at latent 16 and 64, the VAE at 128
    and 512 px, bf16 and f32)."""
    import glob

    import torch

    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
    from phendiff_tpu_torch.models.config import UNet2DConfig
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.ops.gn_kernels import gn_route
    from phendiff_tpu_torch.tools.kernel_calls import sd_unet_calls, unet_calls, vae_calls

    out = {}  # key -> the VAE's image px where the call is the VAE's, else 0
    for dtype in (torch.bfloat16, torch.float32):
        recs = [(unet_calls(cfg, cfg.sample_size, dtype), 0) for cfg in map(
            UNet2DConfig.from_json, sorted(glob.glob("configs/denoiser/*.json")))]
        recs += [(sd_unet_calls(SDUNetConfig(), lat, dtype), 0) for lat in (16, 64)]
        recs += [(vae_calls(AutoencoderKLConfig(), res, dtype), res) for res in (128, 512)]
        for rec, res in recs:
            for key in rec["group_norm"]:
                if any(gn_route(*key[:3], key[4], bwd) == "stream" for bwd in (False, True)):
                    out[key] = max(out.get(key, 0), res)
    return out


def phase_sd_kernel_check(torch, sfu_rate, runs):
    """Both attention kernels at SD-2.1's self-attention shapes, the cluster
    GroupNorm kernels at the SD UNet's and the VAE's shapes (the backward at
    the UNet's, the one the guided method and the train step differentiate),
    each at its path's batch, and the streaming GroupNorm variant at every
    streamed shape.  ``runs``: {path: (batch, the UNet forward's recorded
    calls, the recorded calls that run forward only beside them: the VAE's,
    or for the train step its whole forward)}."""
    from phendiff_tpu_torch.ops.gn_kernels import gn_route

    attn, gn = {}, {}
    for name, (b, unet_calls, fwd_only_calls) in runs.items():
        for (s_q, s_kv, h, d, _), n in unet_calls["attention"].items():
            if s_q == s_kv and d <= 64:
                f = attention_check(torch, b, s_q, h, d, sfu_rate)
                bw = attention_bwd_check(torch, b, s_q, h, d, sfu_rate)
                attn[(name, s_q, h)] = (n, f, bw)
        for model, calls in (("unet", unet_calls), ("vae", fwd_only_calls)):
            for (s, c, g, act, isz), n in calls["group_norm"].items():
                pair = gn.setdefault((name, s, c, g, act), [None, None])
                if pair[0] is None and gn_route(s, c, g, isz) == "cluster":
                    pair[0] = gn_check(torch, b, s, c, g, act, iters=10)
                if model == "unet" and pair[1] is None and gn_route(s, c, g, isz, True) == "cluster":
                    pair[1] = gn_bwd_check(torch, b, s, c, g, act, sfu_rate, iters=10)
    stream = {}
    for (s, c, g, act, isz), res in sorted(sd_streamed_calls().items(),
                                           key=lambda kv: (kv[0][4], kv[0][0], kv[0][1])):
        b = SD_RUNS["sd_path_512"][0] if res == 512 else 1
        stream[(s, c, g, act, isz)] = gn_stream_check(
            torch, b, s, c, g, act, "bfloat16" if isz == 2 else "float32", sfu_rate)
    ok = (all(f["ok"] and bw["ok"] for _, f, bw in attn.values())
          and all(r["ok"] for pair in gn.values() for r in pair if r)
          and all(r["ok"] for r in stream.values()))
    if not ok:
        fail("an SD-shape kernel disagrees with its plain version (see kernel_check lines)")
    return attn, gn, stream


def phase_sd_forward_check(torch, pipe, pipe32):
    """The full-width SD UNet (latent 16, batch 2) and the VAE's encode +
    decode (128 px, batch 2; 512 px, batch 1, its streaming GroupNorms), the
    kernels against the plain path: in float32, to SD_F32_REL_L2_TOL; in
    bf16, the kernel path no further from the float32 plain output than the
    bf16 plain path is (within SD_BF16_VS_PLAIN), since both round through
    the same ~60 layers."""
    from phendiff_tpu_torch.ops.routes import plain_kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    x = torch.randn(2, 16, 16, 4, generator=gen, device="cuda")
    t = torch.full((2,), 500, device="cuda")
    seq = pipe.encode_class(torch.tensor([0, 1]))
    inputs = {"unet": None}
    for b, res in ((2, 128), (1, 512)):
        inputs[f"vae_{res}px"] = torch.rand(b, res, res, 3, generator=gen, device="cuda") * 2 - 1

    def run(p, name):
        if name == "unet":
            return p.denoiser_fn()(x, t, seq)
        lat = p.encode_images(inputs[name])
        return torch.cat([lat.flatten(), p.decode_latents(lat).flatten()])

    rec = {"phase": "sd_forward_check", "unet": {"batch": 2, "latent": 16},
           "tol": {"f32_rel_l2": SD_F32_REL_L2_TOL, "bf16_vs_plain": SD_BF16_VS_PLAIN}}
    ok = True
    for name in inputs:
        out32 = run(pipe32, name)
        out16 = run(pipe, name)
        with plain_kernels():
            ref32 = run(pipe32, name)
            ref16 = run(pipe, name)
        r = {"f32_rel_l2": rel_l2(out32, ref32), "f32_max_abs_err": max_abs(out32, ref32),
             "bf16_rel_l2": rel_l2(out16, ref16), "bf16_max_abs_err": max_abs(out16, ref16),
             "bf16_kernel_vs_f32_plain": rel_l2(out16, ref32),
             "bf16_plain_vs_f32_plain": rel_l2(ref16, ref32),
             "finite": bool(torch.isfinite(out16).all() and torch.isfinite(out32).all())}
        rec.setdefault(name, {}).update(r)
        ok &= (r["finite"] and r["f32_rel_l2"] <= SD_F32_REL_L2_TOL
               and r["bf16_kernel_vs_f32_plain"] <= SD_BF16_VS_PLAIN * r["bf16_plain_vs_f32_plain"])
    emit(rec)
    if not ok:
        fail(f"sd_forward_check: {rec}")
    return rec


def phase_sd_path(torch, pipe, name, env, unet_calls_by_latent, vae_calls_by_res):
    """50-step DDIB from images through the VAE: encode, transfer, decode."""
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.pipelines.transfer import ddib

    b, res = SD_RUNS[name]
    lat_res = res // 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    images01 = torch.rand(b, res, res, 3, generator=gen, device="cuda")
    images = images01 * 2 - 1
    src = pipe.encode_class(torch.zeros(b, dtype=torch.long))
    tgt = pipe.encode_class(torch.ones(b, dtype=torch.long))
    den = pipe.denoiser_fn()
    warm = pipe.encode_images(images)
    pipe.decode_latents(ddib(den, pipe.schedule, warm, src, tgt, num_inference_steps=2))
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with counting_plain_calls() as plain:
        t0 = time.perf_counter()
        lat = pipe.encode_images(images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ddib(den, pipe.schedule, lat, src, tgt, num_inference_steps=STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        img = pipe.decode_latents(out)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    launches = read_launches(SD_KEYS)
    want = add_launches((2 * STEPS, predicted_launches(unet_calls_by_latent[lat_res])),
                        (1, predicted_launches(vae_calls_by_res[res])))
    rec = {
        "phase": name, "batch": b, "res": res, "latent": lat_res, "steps": STEPS,
        "seconds": t3 - t0, "transfers_per_s": b / (t3 - t0),
        "ms_per_unet_forward": 1e3 * (t2 - t1) / (2 * STEPS),
        "vae_encode_ms": 1e3 * (t1 - t0), "vae_decode_ms": 1e3 * (t3 - t2),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "launches_expected": want, "plain_version_calls": dict(plain),
        "finite": bool(torch.isfinite(img).all()), "shape": list(img.shape),
        "out_mean": float(img.float().mean()), "out_std": float(img.float().std()),
        "device": env["device"], "nvidia_smi": env["nvidia_smi"],
    }
    emit(rec)
    if not rec["finite"] or tuple(img.shape) != (b, res, res, 3):
        fail(f"{name}: output not finite or of the wrong shape")
    if launches != want or plain:
        fail(f"{name}: launches {launches} != expected {want}, or plain calls {dict(plain)}")
    # the transfer's inputs (source class 0, target 1) and its [0, 1] images,
    # which the sd_serving phase's engine must reproduce
    return rec, (images01.cpu().numpy(), ((img.float() / 2 + 0.5).clamp(0, 1)).cpu().numpy())


def phase_sd_guided_check(torch, pipe, pipe32, unet_calls_by_latent, unet32_calls_latent64):
    """One guided step in bf16 (latent 16, batch 4) and in f32 (latent 64,
    batch 1), weights frozen, kernels against the plain path."""
    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.ops.routes import plain_kernels, reset_launch_counts
    from phendiff_tpu_torch.pipelines.transfer import guided_gradient

    t = int(S.timestep_pairs(pipe.scheduler_config, STEPS)[0][1])
    rec = {"phase": "sd_guided_check", "t": t,
           "tol_rel_l2": {"bf16": [FORWARD_REL_L2_TOL, GRAD_REL_L2_TOL], "f32": SD_F32_REL_L2_TOL}}
    ok = True
    for tag, p, b, lat, calls, tol in (
            ("bf16", pipe, 4, 16, unet_calls_by_latent[16], (FORWARD_REL_L2_TOL, GRAD_REL_L2_TOL)),
            ("f32", pipe32, 1, 64, unet32_calls_latent64, (SD_F32_REL_L2_TOL,) * 2)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
        x = torch.randn(b, lat, lat, 4, generator=gen, device="cuda")
        target = torch.randn(b, lat, lat, 4, generator=gen, device="cuda")
        seq = p.encode_class(torch.tensor([1, 0, 1, 0][:b]))
        den = p.denoiser_fn()
        with p.frozen():
            reset_launch_counts()
            with counting_plain_calls() as plain:
                out_k, grad_k = guided_gradient(den, p.schedule, x, t, target, seq)
                torch.cuda.synchronize()
            launches = read_launches(SD_KEYS)
            with plain_kernels():
                out_p, grad_p = guided_gradient(den, p.schedule, x, t, target, seq)
        want = predicted_launches(calls, backward=True)
        r = {"batch": b, "latent": lat, "model_out_rel_l2": rel_l2(out_k, out_p),
             "grad_rel_l2": rel_l2(grad_k, grad_p), "grad_max_abs_err": max_abs(grad_k, grad_p),
             "launches": launches, "launches_expected": want, "plain_version_calls": dict(plain),
             "finite": bool(torch.isfinite(out_k).all() and torch.isfinite(grad_k).all()),
             "param_grads_left": sum(q.grad is not None for q in p.unet.parameters())}
        rec[tag] = r
        ok &= (r["finite"] and r["model_out_rel_l2"] <= tol[0] and r["grad_rel_l2"] <= tol[1]
               and launches == want and not plain and not r["param_grads_left"]
               and float(grad_k.abs().max()) > 0)
    emit(rec)
    if not ok:
        fail(f"sd_guided_check: {rec}")
    return rec


def phase_sd_comparison(torch, pipe32, env, unet_calls_by_latent, vae_calls_by_res):
    """The engine over a saved full-width SD pipeline folder: all four
    methods, 10 steps, batch 32, 2 x 32 random 128 px PNGs; ISC and KID."""
    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.experiments.comparison import (
        METHODS, ComparisonConfig, ComparisonExperiment)
    from phendiff_tpu_torch.ops.routes import reset_launch_counts

    root = tempfile.mkdtemp(prefix="phd_sdcmp_")
    t0 = time.perf_counter()
    pipe32.save_pretrained(os.path.join(root, "pipe"))
    t_save = time.perf_counter() - t0
    data = write_image_folder(os.path.join(root, "data"), CMP_PER_CLASS)
    cfg = ComparisonConfig.from_dict({
        "output_dir": os.path.join(root, "out"), "pipelines": {"sd": os.path.join(root, "pipe")},
        "dataset_train": data, "definition": [RES, RES], "methods": list(METHODS),
        "method_params": {m: {"batch_size": SD_CMP_BATCH} for m in METHODS},
        "num_inference_steps": CMP_STEPS,
        "metrics": {"fid": False, "isc": True, "kid": True, "kid_subset_size": 16},
    })
    t0 = time.perf_counter()
    exp = ComparisonExperiment(cfg, device="cuda")
    t_load = time.perf_counter() - t0
    reset_launch_counts()
    with counting_plain_calls() as plain:
        t0 = time.perf_counter()
        exp.run_transfers()
        torch.cuda.synchronize()
        t_transfers = time.perf_counter() - t0
    launches = read_launches(SD_KEYS)
    t0 = time.perf_counter()
    metrics = exp.compute_metrics()
    t_metrics = time.perf_counter() - t0
    batches = 2 * CMP_PER_CLASS // SD_CMP_BATCH
    cfg_fwd = len(S.timestep_pairs(exp.pipes["sd"].scheduler_config, CMP_STEPS, 0.5)[0])
    unet = unet_calls_by_latent[RES // 8]
    want = add_launches(
        (batches * (2 * CMP_STEPS * 3 + cfg_fwd), predicted_launches(unet)),
        (batches * CMP_STEPS, predicted_launches(unet, forward=False, backward=True)),
        (batches * len(METHODS), predicted_launches(vae_calls_by_res[RES])))
    pngs = {m: len([f for _, _, fs in os.walk(os.path.join(cfg.output_dir, m)) for f in fs
                    if "_to_" in f]) for m in METHODS}
    with open(os.path.join(cfg.output_dir, "timings.json")) as f:
        timings = json.load(f)
    keys = [f"{m}/sd/train/{k}" for m in METHODS for k in (
        "inception_score_mean", "kernel_inception_distance_mean",
        "DMSO/kernel_inception_distance_mean", "drug/kernel_inception_distance_mean")]
    rec = {
        "phase": "sd_comparison", "batch": SD_CMP_BATCH, "res": RES, "steps": CMP_STEPS,
        "metrics_computed": "ISC and KID; FID off (its float64 host sqrtm of 2048 x 2048 "
                            "already takes most of the DDIM comparison phase)",
        "images_per_method": 2 * CMP_PER_CLASS, "pngs_per_method": pngs,
        "save_seconds": t_save, "load_seconds": t_load, "transfer_seconds": t_transfers,
        "metrics_seconds": t_metrics,
        "images_per_s": {k: v["images_per_sec"] for k, v in timings.items()},
        "launches": launches, "launches_expected": want, "plain_version_calls": dict(plain),
        "metrics": {k: metrics[k] for k in keys if k in metrics}, "n_metrics": len(metrics),
        "missing_keys": [k for k in keys if k not in metrics],
        "metrics_finite": all(math.isfinite(v) for v in metrics.values()),
        "device": env["device"], "nvidia_smi": env["nvidia_smi"],
    }
    emit(rec)
    if (any(n != 2 * CMP_PER_CLASS for n in pngs.values()) or rec["missing_keys"]
            or not rec["metrics_finite"] or launches != want or plain):
        fail(f"sd_comparison: {rec}")
    return rec, os.path.join(root, "pipe"), data


def sd_pipeline(dtype, seed: int = 0, cast: bool = True):
    """Full-width SD-2.1 (``SDUNetConfig()``, ``AutoencoderKLConfig()``) with
    random weights from ``seed`` on the card, the transfer scheduler of
    ``bench.py``; compute in ``dtype``, and conv and linear weights too
    unless ``cast`` is False (f32 weights, as a trainer takes them)."""
    import torch

    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline

    pipe = SDImg2ImgPipeline.init_random(
        SDUNetConfig(), AutoencoderKLConfig(),
        SchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                        clip_sample=False), seed=seed, dtype=dtype, device="cuda")
    return pipe.cast_params(dtype) if cast and dtype != torch.float32 else pipe


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


def sd_train_run(torch, pipe, images, labels, draws, mixed_precision="bf16", remat=False,
                 components=("denoiser", "class_embedding")):
    """One SD train step (``for_sd_pipeline``'s) from ``pipe``'s weights: its
    metrics and the gradients its optimizer was given."""

    step, state, _, opt = sd_train_step(pipe, remat, components, proba_uncond=0.0,
                                        mixed_precision=mixed_precision)
    grads, update = {}, opt.update

    def capture(g, opt_state, params):
        grads.update(g)
        update(g, opt_state, params)

    opt.update = capture
    state, metrics = step(state, (images, labels), draws)
    del opt.update  # no reference cycle keeps the gradients alive after the phase
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(p).all()) for p in state.params.values())
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params_finite": finite}, grads


def component_rel_l2(got, want, prefix):
    """Relative L2 distance of all the gradients under ``prefix`` together."""
    names = [n for n in want if n.startswith(prefix)]
    diff = sum(float((got[n].float() - want[n].float()).square().sum()) for n in names)
    ref = sum(float(want[n].float().square().sum()) for n in names)
    return math.sqrt(diff / max(ref, 1e-30))


def phase_sd_train_check(torch):
    """One full-width SD train step at latent 16, batch 4 (f32 master weights,
    bf16 compute, frozen bf16 VAE): on the kernels against the same step
    under the plain versions, both held against the step in f32 (plain
    versions, f32 VAE); with remat against without; and with the VAE's
    encoder trained."""
    from phendiff_tpu_torch.ops.routes import plain_kernels
    from phendiff_tpu_torch.train.train_loop import make_draws

    pipe = sd_pipeline(torch.bfloat16, SEED, cast=False)
    pipe32 = sd_pipeline(torch.float32, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    images = torch.rand(4, RES, RES, 3, generator=gen, device="cuda") * 2 - 1
    labels = torch.tensor([0, 1, 1, 0], device="cuda")
    draws = make_draws(SEED, 0, (4, RES // 8, RES // 8, 4), pipe.schedule.num_train_timesteps,
                       0.0, "cuda", posterior=True)
    comps = ("unet.", "class_embedding.")
    with plain_kernels():
        ref, g_ref = sd_train_run(torch, pipe32, images, labels, draws, mixed_precision="no")
        plain, g_plain = sd_train_run(torch, pipe, images, labels, draws)
    kern, g_kern = sd_train_run(torch, pipe, images, labels, draws)

    def versus_f32(m, g):
        return {"loss_rel_err": abs(m["loss"] - ref["loss"]) / abs(ref["loss"]),
                "grad_norm_rel_err": abs(m["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                **{f"{c}grad_rel_l2": component_rel_l2(g, g_ref, c) for c in comps}}

    d_plain, d_kern = versus_f32(plain, g_plain), versus_f32(kern, g_kern)
    rec = {"phase": "sd_train_check", "batch": 4, "latent": RES // 8,
           "tol": {"kernel_vs_f32_at_most_times_plain_vs_f32": SD_BF16_VS_PLAIN,
                   "floor": SD_TRAIN_FLOOR, "remat_loss_rel_err": SD_REMAT_LOSS_REL},
           "f32": ref, "plain": plain, "kernel": kern,
           "plain_vs_f32": d_plain, "kernel_vs_f32": d_kern,
           "kernel_vs_plain": {f"{c}grad_rel_l2": component_rel_l2(g_kern, g_plain, c)
                               for c in comps}}
    ok = kern["params_finite"] and all(
        d_kern[k] <= max(SD_BF16_VS_PLAIN * d_plain[k], SD_TRAIN_FLOOR) for k in d_plain)
    del g_plain, g_ref
    remat, g_remat = sd_train_run(torch, pipe, images, labels, draws, remat=True)
    rec["remat"] = {**remat, "loss_rel_err_vs_no_remat": abs(remat["loss"] - kern["loss"])
                    / abs(kern["loss"]),
                    **{f"{c}grad_rel_l2_vs_no_remat": component_rel_l2(g_remat, g_kern, c)
                       for c in comps}}
    ok &= (rec["remat"]["loss_rel_err_vs_no_remat"] <= SD_REMAT_LOSS_REL
           and all(rec["remat"][f"{c}grad_rel_l2_vs_no_remat"]
                   <= max(SD_BF16_VS_PLAIN * d_plain[f"{c}grad_rel_l2"], SD_TRAIN_FLOOR)
                   for c in comps))
    del g_remat, g_kern
    vae_run, g_vae = sd_train_run(torch, pipe, images, labels, draws,
                                  components=("denoiser", "class_embedding", "autoencoder"))
    enc = {n: g for n, g in g_vae.items()
           if n.split(".")[:2] in (["vae", "encoder"], ["vae", "quant_conv"])}
    dec = {n: g for n, g in g_vae.items() if n.startswith("vae.") and n not in enc}
    rec["autoencoder"] = {
        **vae_run, "encoder_tensors": len(enc),
        "encoder_zero_or_nonfinite": sorted(n for n, g in enc.items() if not bool(
            torch.isfinite(g).all()) or float(g.abs().max()) == 0.0),
        "decoder_tensors": len(dec),
        "decoder_max_abs_grad": max(float(g.abs().max()) for g in dec.values())}
    ok &= (len(enc) > 0 and not rec["autoencoder"]["encoder_zero_or_nonfinite"]
           and rec["autoencoder"]["decoder_max_abs_grad"] == 0.0 and vae_run["params_finite"])
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        fail(f"sd_train_check: {rec}")
    del pipe, pipe32, g_vae
    torch.cuda.empty_cache()
    return rec


def phase_sd_train_path(torch, env, train_calls):
    """Full-width SD-2.1 fine-tune steps at 128 px, batch 32 over a frozen bf16
    VAE (``bench.py::bench_sd_train``'s shape): 2 warm-up and 10 timed steps
    without remat, then 1 and 3 with it, then 2 and 3 without remat with
    Adam's first moment in bf16 (``bf16_moment``: its moments' dtypes; its
    first step's parameters against the f32-moment run's first step by
    grad_check's rule, a sanity check only, since at count 1 the moment is
    still zero and both updates are the same arithmetic; and its second
    step's update against ``host_update_check``); launches against the
    recorded calls.  Its device-time breakdown is the ``sd21_128.finetune``
    cell's (``portbench/run.py --trace 1``)."""
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.train.train_loop import make_draws

    pipe = sd_pipeline(torch.bfloat16, SEED, cast=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    images = torch.rand(TRAIN_BATCH, RES, RES, 3, generator=gen, device="cuda") * 2 - 1
    labels = torch.tensor([0, 1], device="cuda").repeat(TRAIN_BATCH // 2)
    rec = {"phase": "sd_train_path", "batch": TRAIN_BATCH, "res": RES, "latent": RES // 8,
           "params": sum(p.numel() for p in pipe.unet.parameters())
           + sum(p.numel() for p in pipe.class_embedding.parameters()),
           "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    ok = True
    first_step = None  # the f32-moment run's parameters after its first step, on the host
    for mode, remat, warm, steps, moment_dtype in (
            ("no_remat", False, 2, 10, "float32"), ("remat", True, 1, 3, "float32"),
            ("bf16_moment", False, 2, 3, "bfloat16")):
        step, state, kw, opt = sd_train_step(pipe, remat, moment_dtype=moment_dtype)
        shape = kw["diffusion_shape"](tuple(images.shape))

        def run(n):
            nonlocal state
            losses = []
            for _ in range(n):
                draws = make_draws(SEED, state.step, shape, pipe.schedule.num_train_timesteps,
                                   0.1, "cuda", posterior=True)
                state, m = step(state, (images, labels), draws)
                losses.append(m["loss"])
            return torch.stack(losses)

        with counting_plain_calls() as plain_first:
            run(1)
        if mode == "no_remat":
            first_step = {n: p.detach().to("cpu", copy=True) for n, p in state.params.items()}
        elif mode == "bf16_moment":
            first = param_rule(state.params, first_step, 1e-5)
            first_step = None
            with counting_plain_calls() as plain_second:
                second = host_update_check(torch, opt, state, lambda: run(1))
            warm -= 1
        if warm > 1:
            run(warm - 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with counting_plain_calls() as plain:
            t0 = time.perf_counter()
            losses = run(steps)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = read_launches(SD_KEYS)
        calls = train_calls[remat]
        want = add_launches((steps, predicted_launches(calls["forward"])),
                            (steps, predicted_launches(calls["backward"], False, True)))
        peak = torch.cuda.max_memory_allocated() / 2**30
        r = {"steps": steps, "seconds": dt, "samples_per_s": TRAIN_BATCH * steps / dt,
             "ms_per_step": 1e3 * dt / steps, "peak_mem_gib": peak, "launches": launches,
             "launches_expected": want, "plain_version_calls": dict(plain),
             "losses": [float(x) for x in losses],
             "loss_finite": bool(torch.isfinite(losses).all()),
             "mu_dtypes": sorted({str(t.dtype) for t in state.opt_state.mu.values()}),
             "nu_dtypes": sorted({str(t.dtype) for t in state.opt_state.nu.values()})}
        ok &= r["loss_finite"] and launches == want and not plain and not plain_first
        ok &= r["mu_dtypes"] == [f"torch.{moment_dtype}"] and r["nu_dtypes"] == ["torch.float32"]
        if mode == "bf16_moment":
            r["first_step_against_f32_moment"] = first
            r["second_update_against_host"] = second
            ok &= first["ok"] and second["ok"] and not plain_second
        rec[mode] = r
        del step, state, kw
        torch.cuda.empty_cache()
    emit(rec)
    if not ok:
        fail(f"sd_train_path: {rec}")
    del pipe
    torch.cuda.empty_cache()
    return rec


def host_update_check(torch, opt, state, one_step, lr=1e-5, nu_rtol=1e-5,
                      norm_rtol=1e-5) -> dict:
    """One step's optimizer update on the card against the same update on
    the host.  As the step hands its gradients to ``opt.update``, they, the
    state they update and the update's clip factor (``opt.clip_factor`` on
    the card) are copied to the host; after the step the port's
    ``Optimizer.update`` (held against optax by ``tests/test_torch_train.py``)
    runs on those copies on the CPU, clipped by that factor, so that only
    the elementwise arithmetic is compared and not a norm summed in another
    order.  The card's first moments must lie within one ulp of their dtype
    of the host's, the second moments within ``nu_rtol``, the parameters by
    grad_check's rule, and the card's gradient norm within ``norm_rtol`` of
    the float64 norm of the same gradients."""
    import dataclasses

    from phendiff_tpu_torch.train.train_loop import AdamWState, Optimizer, global_norm

    def host(d):
        return {n: t.detach().to("cpu", copy=True) for n, t in d.items()}

    cap, update = {}, opt.update

    def capture(grads, st, params):
        names = list(st.mu)
        with torch.no_grad():
            g = [grads[n].float() for n in names]
            clip = opt.clip_factor(g, names)
            norm = global_norm(g, [n in opt.sharded for n in names])
        clip = torch.ones(()) if clip is None else clip.cpu()
        cap.update(grads=host(grads), params=host(params), clip=clip, norm=float(norm),
                   opt_state=AdamWState(count=st.count, mu=host(st.mu), nu=host(st.nu)))
        update(grads, st, params)

    opt.update = capture
    try:
        one_step()
    finally:
        del opt.update
    t0 = time.perf_counter()
    want = cap["opt_state"]
    names = list(want.mu)
    norm64 = math.sqrt(sum(float(cap["grads"][n].double().square().sum()) for n in names))
    host_norm = float(global_norm([cap["grads"][n] for n in names],
                                  [n in opt.sharded for n in names]))
    grads = {n: g * cap["clip"] for n, g in cap["grads"].items()}
    ref = Optimizer(dataclasses.replace(opt.cfg, max_grad_norm=None), opt.trainable_mask,
                    opt.sharded)
    ref.update(grads, want, cap["params"])
    rec = {"count": want.count, "host_s": time.perf_counter() - t0,
           "mu_dtype": str(next(iter(state.opt_state.mu.values())).dtype),
           "clip": float(cap["clip"]), "grad_norm": cap["norm"], "grad_norm_f64": norm64,
           "grad_norm_rel_err": abs(cap["norm"] - norm64) / norm64, "norm_rtol": norm_rtol,
           "host_grad_norm_rel_err": abs(host_norm - norm64) / norm64}
    mu_far = mu_differ = total = 0
    nu_rel = 0.0
    for n, w in want.mu.items():
        fi = torch.finfo(w.dtype)
        got, w = state.opt_state.mu[n].float().cpu(), w.float()
        # one ulp of the stored dtype at the host's value: 2^(e - 1) eps for
        # w = m 2^e, m in [0.5, 1); the smallest subnormal at and below
        # the normal range
        tiny = fi.smallest_normal * fi.eps
        ulp = torch.ldexp(torch.full_like(w, fi.eps), torch.frexp(w).exponent - 1)
        ulp = torch.where(w == 0, tiny, ulp.clamp_min(tiny))
        diff = (got - w).abs()
        mu_far += int((diff > ulp).sum())
        mu_differ += int((diff > 0).sum())
        total += w.numel()
        g_nu = state.opt_state.nu[n].cpu()
        nu_rel = max(nu_rel, float(((g_nu - want.nu[n]).abs()
                                    / want.nu[n].abs().clamp_min(1e-30)).max()))
    rec.update(mu_elements=total, mu_differing=mu_differ, mu_beyond_one_ulp=mu_far,
               nu_max_rel_diff=nu_rel, nu_rtol=nu_rtol,
               params=param_rule(state.params, cap["params"], lr))
    rec["ok"] = bool(mu_far == 0 and nu_rel <= nu_rtol and rec["params"]["ok"]
                     and rec["grad_norm_rel_err"] <= norm_rtol)
    return rec


def phase_train_cli(torch, sd_folder, data):
    """``phendiff_tpu_torch.cli.train_cli.main`` in this process, twice: DDIM
    with the flags of ``examples/launch_train_ddim.sh`` and ``--debug
    --train_batch_size 32 --max_num_steps 5``, and an SD fine-tune of the
    saved full-width folder, 3 steps at batch 32 with one eval; each over
    the 2 x 32 PNG folder at 128 px."""
    import shlex

    from phendiff_tpu_torch.cli import train_cli
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline

    with open(os.path.join("examples", "launch_train_ddim.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "train_cli" in ln)
    words = shlex.split(line.replace('"${DATA_DIR:-data/prepared/train}"', shlex.quote(data)))
    script_flags = [w for w in words[words.index("phendiff_tpu.cli.train_cli") + 1:] if w != "$@"]
    root = tempfile.mkdtemp(prefix="phd_train_cli_")
    # FID off in both (its float64 host sqrtm of 2048 x 2048 takes ~13 s a
    # class); ISC and KID rank the evals
    metrics = ["--no_compute_fid", "--compute_isc", "--compute_kid", "--main_metric", "kid"]
    runs = {
        "ddim": (script_flags + ["--debug", "--train_batch_size", "32", "--max_num_steps", "5"]
                 + metrics, ConditionalDDIMPipeline, "ddim_128px"),
        "sd": (["--run_name", "sd_128px", "--model_type", "StableDiffusion",
                "--pretrained_model_name_or_path", sd_folder, "--train_data_dir", data,
                "--definition", str(RES), "--train_batch_size", "32", "--max_num_steps", "3",
                "--eval_save_model_every_opti_steps", "3", "--eval_batch_size", "32",
                "--nb_generated_images", "32", "--num_inference_steps", "10",
                "--kid_subset_size", "16", "--proba_uncond", "0.1", "--guidance_factor", "2.5",
                "--learning_rate", "1e-5"] + metrics, SDImg2ImgPipeline, "sd_128px"),
    }
    rec = {"phase": "train_cli",
           "metrics_computed": "ISC and KID; FID off (its float64 host sqrtm of 2048 x 2048 "
                               "takes ~13 s a class)"}
    ok = True
    for name, (argv, cls, run_name) in runs.items():
        argv = argv + ["--exp_output_dirs_parent_folder", os.path.join(root, name)]
        t0 = time.perf_counter()
        rc = train_cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run_dir = os.path.join(root, name, "phendiff-tpu", run_name)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        evals = [r["main_metric_mean"] for r in recs if "main_metric_mean" in r]
        t1 = time.perf_counter()
        loaded = cls.from_pretrained(os.path.join(run_dir, "full_pipeline_save"), device="cuda")
        t_load = time.perf_counter() - t1
        params = sum(p.numel() for p in (loaded.model if name == "ddim" else loaded.unet)
                     .parameters())
        r = {"rc": rc, "seconds": dt, "load_seconds": t_load, "argv": argv,
             "steps": [r["step"] for r in recs if "loss" in r], "losses": losses,
             "main_metric_mean": evals, "checkpoints": sorted(os.listdir(
                 os.path.join(run_dir, "checkpoints"))), "reloaded_params": params,
             "reloaded_finite": all(bool(torch.isfinite(p).all()) for p in (
                 loaded.model if name == "ddim" else loaded.unet).parameters())}
        rec[name] = r
        ok &= (rc == 0 and bool(losses) and all(math.isfinite(x) for x in losses)
               and bool(r["checkpoints"]) and r["reloaded_finite"] and bool(evals)
               and all(math.isfinite(x) for x in evals))
        del loaded
        torch.cuda.empty_cache()
    rec["steps_note"] = ("--debug sets max_num_steps 30 and 3 epochs (the JAX package's "
                         "modify_args_for_debug): the DDIM run takes 3 epochs of 2 batches")
    emit(rec)
    if not ok:
        fail(f"train_cli: {rec}")
    return rec


def serving_run(torch, name, eng, inputs, refs, want_launches, env, swap=None, timed=2):
    """Drive an engine's ops as a client would: ``warmup()`` (a capture per
    op, with no call of a kernel's plain version), the eager op on the same
    inputs (``refs[op]()``: other work allocating and freeing memory between
    capture and replay), a full request held bit-equal to it, a partial
    request held to the full one's rows, each capture's launches against
    ``want_launches[op]``, then ``timed`` full requests (wall) and one bare
    replay between CUDA events (device).  With ``swap = (pipeline, ref)``:
    ``swap_params`` and a transfer held bit-equal to ``ref()``, with no new
    capture."""
    import numpy as np

    images, src, labels, seed = inputs
    b = eng.config.max_batch
    requests = {"transfer": lambda k: eng.transfer(images[:k], src[:k]),
                "generate": lambda k: eng.generate(labels[:k], seed=seed),
                "invert": lambda k: eng.invert(images[:k], src[:k])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting_plain_calls() as plain:
        warm = eng.warmup()
    rec = {"phase": name, "max_batch": b, "steps": eng.config.num_inference_steps,
           "warmup_s": warm, "plain_version_calls": dict(plain), "ops": {}}
    for op in eng.config.ops:
        want = refs[op]()
        full = requests[op](b)
        part = requests[op](SERVE_PARTIAL)
        walls = []
        for _ in range(timed):
            t0 = time.perf_counter()
            requests[op](b)
            walls.append(time.perf_counter() - t0)
        graph = eng._ops[op].graph
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        request_s = sum(walls) / len(walls)
        rec["ops"][op] = {
            "bit_equal": bool(np.array_equal(full, want)),
            "max_abs_err": float(np.abs(full - want).max()),
            "partial_bit_equal": bool(np.array_equal(part, full[:SERVE_PARTIAL])),
            "finite": bool(np.isfinite(full).all()), "shape": list(full.shape),
            "request_s": walls, "images_per_s": b / request_s,
            "replay_device_ms": start.elapsed_time(end),
            "host_ms_per_request": 1e3 * request_s - start.elapsed_time(end),
            "launches_per_replay": eng.stats()["launches_per_replay"][op],
            "launches_expected": want_launches[op],
        }
    if swap is not None:
        new, ref = swap
        captures = eng.stats()["captures"]
        eng.swap_params(new)
        want = ref()
        got = requests["transfer"](b)
        rec["swap"] = {"bit_equal": bool(np.array_equal(got, want)),
                       "max_abs_err": float(np.abs(got - want).max()),
                       "recaptures": eng.stats()["captures"] - captures}
    stats = eng.stats()
    replays = {op: n + 1 for op, n in stats["replays"].items()}  # and the bare replay
    rec.update({
        "captures": stats["captures"], "replays": replays,
        "launches": {k: sum(stats["launches_per_replay"][op][k] * n for op, n in replays.items())
                     for k in SERVE_KEYS},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "device": env["device"], "nvidia_smi": env["nvidia_smi"],
    })
    emit(rec)
    for op, r in rec["ops"].items():
        if not (r["bit_equal"] and r["partial_bit_equal"] and r["finite"]):
            fail(f"{name}: {op} replay differs from the eager op or its padding: {r}")
        if r["launches_per_replay"] != r["launches_expected"]:
            fail(f"{name}: {op} captured {r['launches_per_replay']} launches, expected "
                 f"{r['launches_expected']}")
    if plain or rec["captures"] != len(eng.config.ops):
        fail(f"{name}: plain calls {dict(plain)} or captures {rec['captures']}")
    if swap is not None and not (rec["swap"]["bit_equal"] and rec["swap"]["recaptures"] == 0):
        fail(f"{name}: swap_params: {rec['swap']}")
    return rec


def phase_serving(torch, pipe, ucfg, sched_cfg, env):
    """The serving engine over a copy of the main path's pipeline
    (``super_small``, bf16), ``max_batch`` 32, 50 steps: each op against
    the eager op (the main path's ``ddib``, the pipeline's ``generate`` and
    ``invert``), then ``swap_params`` to the seed-1 pipeline."""
    import copy

    import numpy as np

    from phendiff_tpu_torch.pipelines.conditional_ddim import to_images
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.pipelines.transfer import ddib
    from phendiff_tpu_torch.serving import EngineConfig, InferenceEngine

    rng = np.random.default_rng(SEED + 31)
    images = rng.random((BATCH, RES, RES, 3), dtype=np.float32)
    src, labels = rng.integers(0, 2, BATCH), rng.integers(0, 2, BATCH)
    seed = SEED + 32

    def refs(p):
        x = torch.as_tensor(images * 2.0 - 1.0, device="cuda")
        s, lab = torch.as_tensor(src, device="cuda"), torch.as_tensor(labels, device="cuda")
        return {
            "transfer": lambda: to_images(ddib(
                p.denoiser_fn(), p.schedule, x, p.class_embeddings(s),
                p.class_embeddings(1 - s), num_inference_steps=STEPS)).cpu().numpy(),
            "generate": lambda: to_images(p.generate(
                lab, torch.Generator(device="cuda").manual_seed(seed),
                num_inference_steps=STEPS)).cpu().numpy(),
            "invert": lambda: p.invert(x, s, num_inference_steps=STEPS).float().cpu().numpy(),
        }

    def fwd(forwards):
        return {**{k: launches_for(forwards, 0)[k] for k in SERVE_KEYS[:2]},
                "group_norm_silu_stream": 0, "flash_attn_fwd_wgmma": 0}

    pipe1 = ConditionalDDIMPipeline.init_random(
        ucfg, sched_cfg, seed=SEED + 1, dtype=torch.bfloat16, device="cuda"
    ).cast_params(torch.bfloat16)
    eng = InferenceEngine(copy.deepcopy(pipe), EngineConfig(max_batch=BATCH,
                                                            num_inference_steps=STEPS))
    rec = serving_run(torch, "serving", eng, (images, src, labels, seed), refs(pipe),
                      {"transfer": fwd(2 * STEPS), "generate": fwd(STEPS),
                       "invert": fwd(STEPS)}, env, swap=(pipe1, refs(pipe1)["transfer"]),
                      timed=3)
    del eng
    torch.cuda.empty_cache()
    return rec


def vae_part_calls(torch, res: int, part: str) -> dict:
    """The recorded calls of the full-width VAE's encode or decode alone."""
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
    from phendiff_tpu_torch.ops.routes import record_calls

    cfg = AutoencoderKLConfig()

    def run():
        with torch.device("meta"):
            vae = AutoencoderKL(cfg, dtype=torch.bfloat16)
            if part == "encode":
                vae.encode(torch.zeros(1, res, res, cfg.in_channels))
            else:
                vae.decode(torch.zeros(1, res // 8, res // 8, cfg.latent_channels))

    return record_calls(run)


def phase_sd_serving(torch, sd, sd_outputs, env, unet_by_lat, vae_by_res):
    """The serving engine over the full-width SD pipeline (bf16) at each SD
    run's batch and size: the transfer held bit-equal to that run's output
    (sd_path, sd_path_512), generate and invert to the pipeline's eager
    ops; at 128 px ``swap_params`` to the seed-1 pipeline and back, at 512
    px to the seed-1 pipeline.  The modules of ``sd`` hold seed 1's weights
    afterwards."""
    import dataclasses

    import numpy as np

    from phendiff_tpu_torch.pipelines.conditional_ddim import to_images
    from phendiff_tpu_torch.pipelines.transfer import ddib
    from phendiff_tpu_torch.serving import EngineConfig, InferenceEngine

    def at_latent(p, lat):
        return dataclasses.replace(p, unet_config=dataclasses.replace(p.unet_config,
                                                                      sample_size=lat))

    sd1 = sd_pipeline(torch.bfloat16, SEED + 1)
    recs = {}
    for run, (b, res) in SD_RUNS.items():
        lat = res // 8
        images, sd_path_out = sd_outputs[run]
        rng = np.random.default_rng(SEED + 41)
        src, labels, seed = np.zeros(b, np.int64), rng.integers(0, 2, b), SEED + 42

        def refs(p):
            x = torch.as_tensor(images * 2.0 - 1.0, device="cuda")
            s, lab = torch.as_tensor(src, device="cuda"), torch.as_tensor(labels, device="cuda")

            def transfer():
                out = ddib(p.denoiser_fn(), p.schedule, p.encode_images(x), p.encode_class(s),
                           p.encode_class(1 - s), num_inference_steps=STEPS)
                return to_images(p.decode_latents(out).float()).cpu().numpy()

            return {
                "transfer": transfer,
                "generate": lambda: to_images(p.generate(
                    lab, torch.Generator(device="cuda").manual_seed(seed),
                    num_inference_steps=STEPS)).cpu().numpy(),
                "invert": lambda: p.invert(x, s, num_inference_steps=STEPS).float().cpu().numpy(),
            }

        unet = predicted_launches(unet_by_lat[lat])
        enc, dec = (predicted_launches(vae_part_calls(torch, res, part))
                    for part in ("encode", "decode"))
        if add_launches((1, enc), (1, dec)) != predicted_launches(vae_by_res[res]):
            fail(f"sd_serving: the VAE's encode and decode calls at {res} px do not add up")
        want = {op: {k: add_launches(*terms)[k] for k in SERVE_KEYS}
                for op, terms in (
            ("transfer", ((2 * STEPS, unet), (1, enc), (1, dec))),
            ("generate", ((STEPS, unet), (1, dec))), ("invert", ((STEPS, unet), (1, enc))))}
        served = at_latent(sd, lat)
        eng = InferenceEngine(served, EngineConfig(max_batch=b, num_inference_steps=STEPS))
        ref = refs(served)
        ref["transfer"] = lambda: sd_path_out  # the sd_path run's images
        name = {"sd_path": "sd_serving", "sd_path_512": "sd_serving_512"}[run]
        recs[name] = serving_run(torch, name, eng, (images, src, labels, seed), ref, want, env,
                                 swap=(at_latent(sd1, lat), refs(at_latent(sd1, lat))["transfer"]),
                                 timed=1)
        if run == "sd_path":  # swap back: the 512 px engine serves seed 0 again
            sd0 = at_latent(sd_pipeline(torch.bfloat16, SEED), lat)
            eng.swap_params(sd0)
            back = eng.transfer(images, src)
            del sd0
            recs[name]["swap_back_bit_equal"] = bool(np.array_equal(back, sd_path_out))
            emit({"phase": name + "_swap_back", "bit_equal": recs[name]["swap_back_bit_equal"],
                  "recaptures": eng.stats()["captures"] - len(eng.config.ops)})
            if not recs[name]["swap_back_bit_equal"] or eng.stats()["captures"] != 3:
                fail(f"{name}: swapping seed 0 back does not restore the sd_path output")
        del eng
        torch.cuda.empty_cache()
    return recs


def dp_train(torch, model_parallel=1):
    """``DP_STEPS`` DDIM train steps (``train_parts``: super_small, 128 px,
    bf16 compute) on this data rank's rows of the batch-32 batch and of each
    step's global draws; world 1 without a process group.  With
    ``model_parallel`` > 1 the ranks of a replica hold their shards
    (``parallel/tp.py``).  Returns the record, the first step's gradients
    as the optimizer got them (averaged over the data ranks, gathered over
    the model ranks) and the full parameters after the first step and after
    the last; with a model axis the record also holds this rank's own
    tensors and the widths its kernel calls took."""
    import collections

    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models import unet2d
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.ops import group_norm as GN
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.parallel import tp
    from phendiff_tpu_torch.parallel.mesh import (
        data_size, local_rows, make_mesh, replicate, shard_batch)
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.train import train_loop as TL

    pipe = ConditionalDDIMPipeline.init_random(super_small(), SchedulerConfig(), seed=SEED,
                                               dtype=torch.bfloat16, device="cuda")
    model_apply, embed_fn, params, schedule, cfg, model = train_parts(torch, pipe)
    checksum = sum(float(p.detach().double().sum()) for p in params.values())
    replicate(params)
    make_mesh(model_parallel)
    plan = tp.shard_module(model)
    opt = TL.make_optimizer(cfg.optimizer, sharded=plan)
    state = TL.init_train_state(tp.shard_params(params, plan), opt)
    step = TL.make_train_step(model_apply, embed_fn, schedule, cfg, opt)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    images = torch.randn(TRAIN_BATCH, RES, RES, 3, generator=gen, device="cuda") * 0.5
    labels = torch.tensor([0, 1], device="cuda").repeat(TRAIN_BATCH // 2)
    batch, rows = shard_batch((images, labels)), local_rows(TRAIN_BATCH)
    first_grads, update, reduce_events = {}, opt.update, []

    def capture(g, opt_state, p):
        if not first_grads:
            first_grads.update({n: t.clone() for n, t in tp.gather_params(g, plan).items()})
        update(g, opt_state, p)

    # the widths of the kernels' calls: channels and groups of each
    # GroupNorm, heads of each attention
    widths = {"group_norm": collections.Counter(), "attention_heads": collections.Counter()}
    gn_fn, attn_fn = GN.fused_group_norm, unet2d.multi_head_attention

    def gn_recording(x, *a, num_groups, **kw):
        widths["group_norm"][(x.shape[-1], num_groups)] += 1
        return gn_fn(x, *a, num_groups=num_groups, **kw)

    def attn_recording(q, *a, **kw):
        widths["attention_heads"][q.shape[2]] += 1
        return attn_fn(q, *a, **kw)

    inner = TL.all_reduce_mean_

    def timed_all_reduce(tensors):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        inner(tensors)
        ev[1].record()
        reduce_events.append(ev)

    opt.update, TL.all_reduce_mean_ = capture, timed_all_reduce
    GN.fused_group_norm, unet2d.multi_head_attention = gn_recording, attn_recording
    times, losses, first_params = [], [], {}
    try:
        reset_launch_counts()
        with counting_plain_calls() as plain:
            for i in range(DP_STEPS):
                t0 = time.perf_counter()
                draws = TL.make_draws(SEED, state.step, tuple(images.shape),
                                      schedule.num_train_timesteps, cfg.proba_uncond, "cuda")
                state, m = step(state, batch, draws.rows(rows))
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if i == 0:
                    first_params = {n: p.clone() for n, p in
                                    tp.gather_params(state.params, plan).items()}
        launches = read_launches()
    finally:
        TL.all_reduce_mean_ = inner
        GN.fused_group_norm, unet2d.multi_head_attention = gn_fn, attn_fn
        del opt.update
    local = rows.stop - rows.start
    steady = sum(times[1:]) / len(times[1:])
    rec = {"world": data_size(), "local_batch": local, "init_checksum": checksum,
           "losses": losses, "loss_finite": all(map(math.isfinite, losses)),
           "step_seconds": times, "samples_per_s_rank": local / steady,
           "samples_per_s_global": TRAIN_BATCH / steady,
           "all_reduce_ms_per_step": [a.elapsed_time(b) for a, b in reduce_events],
           "launches": launches, "launches_expected": launches_for(DP_STEPS, DP_STEPS),
           "plain_version_calls": dict(plain),
           "widths": {k: {str(w): n for w, n in v.items()} for k, v in widths.items()}}
    if plan:
        rec.update(model_parallel=model_parallel, sharded_leaves=len(plan),
                   local_params={n: p.detach() for n, p in state.params.items()})
    return rec, first_grads, (first_params, tp.gather_params(state.params, plan))


def dp_evaluator(torch, pipe, data):
    """The Evaluator over ``pipe`` (f32): each class's gathered features (32
    images, 10 steps), then a whole pass (ISC and KID, FID off)."""
    from phendiff_tpu_torch.data.imagefolder import scan_imagefolder
    from phendiff_tpu_torch.metrics.fidelity import MetricsConfig
    from phendiff_tpu_torch.train.eval_loop import EvalConfig, Evaluator

    ev = Evaluator(EvalConfig(nb_generated_images=BATCH, eval_batch_size=BATCH,
                              num_inference_steps=CMP_STEPS,
                              metrics=MetricsConfig(fid=False, isc=True, kid=True,
                                                    kid_subset_size=16)),
                   scan_imagefolder(data), (RES, RES), device="cuda")

    def generate(labels, generator, steps):
        return pipe.generate(labels, generator, num_inference_steps=steps)

    t0 = time.perf_counter()
    features = [ev._generate_class(generate, c)[0] for c in (0, 1)]
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    return {"features": features, "generate_seconds": t_gen,
            "metrics": ev.evaluate(generate, 0)}


def dp_comparison(torch, pipe_dir, data, out_dir, fid, batch=BATCH):
    """The DDIB comparison over the saved f32 pipeline (2 x 32 PNGs, 10 steps,
    f32, batches of ``batch``): the [0, 1] images rank 0 saved, the PNGs,
    the metrics and how many FIDs this rank computed."""
    import numpy as np

    from phendiff_tpu_torch.experiments import comparison as C
    from phendiff_tpu_torch.metrics import fidelity

    cfg = C.ComparisonConfig.from_dict({
        "output_dir": out_dir, "pipelines": {"ddim": pipe_dir}, "dataset_train": data,
        "definition": [RES, RES], "methods": ["ddib"],
        "method_params": {"ddib": {"batch_size": batch}}, "num_inference_steps": CMP_STEPS,
        "metrics": {"fid": fid, "isc": True, "kid": True, "kid_subset_size": 16},
        "inference_param_dtype": None,
    })
    saved, fids = [], []
    save, frechet = C._save_batch, fidelity.frechet_distance

    def recording_save(images01, *args):
        saved.append(images01.copy())
        save(images01, *args)

    def counting_frechet(*args, **kw):
        fids.append(1)
        return frechet(*args, **kw)

    C._save_batch, fidelity.frechet_distance = recording_save, counting_frechet
    try:
        exp = C.ComparisonExperiment(cfg, device="cuda")
        t0 = time.perf_counter()
        exp.run_transfers()
        torch.cuda.synchronize()
        t_transfers = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = exp.compute_metrics()
        t_metrics = time.perf_counter() - t0
    finally:
        C._save_batch, fidelity.frechet_distance = save, frechet
    pngs = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, fs in os.walk(out_dir) for f in fs if "_to_" in f)
    return {"images01": np.concatenate(saved) if saved else None, "pngs": pngs,
            "metrics": metrics, "fid_calls": len(fids), "transfer_seconds": t_transfers,
            "metrics_seconds": t_metrics}


def dp_fid_calls(torch, pipe_dir, data, out_dir):
    """The comparison's metric pass (``compute_metrics``: rank 0 computes,
    the others wait for its broadcast) over one FID, of the folder's class 0
    against its class 1 in Inception features: how many FIDs this rank
    computed, and the metrics it got."""
    import numpy as np

    from phendiff_tpu_torch.experiments import comparison as C
    from phendiff_tpu_torch.metrics import fidelity

    cfg = C.ComparisonConfig.from_dict({
        "output_dir": out_dir, "pipelines": {"ddim": pipe_dir}, "dataset_train": data,
        "definition": [RES, RES], "methods": ["ddib"], "inference_param_dtype": None})
    exp = C.ComparisonExperiment(cfg, device="cuda")
    fids, frechet = [], fidelity.frechet_distance

    def one_class_pass():
        index = exp.splits["train"]
        feats, labels = exp._features(index)[0], np.array(index.labels)
        return {"fid_class0_vs_class1": fidelity.fid_from_features(feats[labels == 0],
                                                                  feats[labels == 1])}

    def counting_frechet(*args, **kw):
        fids.append(1)
        return frechet(*args, **kw)

    exp._metrics, fidelity.frechet_distance = one_class_pass, counting_frechet
    t0 = time.perf_counter()
    try:
        metrics = exp.compute_metrics()
    finally:
        fidelity.frechet_distance = frechet
    return {"fid_calls": len(fids), "fid_metrics": metrics,
            "fid_seconds": time.perf_counter() - t0}


def dp_worker(argv) -> None:
    """One rank of the dp phase's world-2 run: gloo on ``cuda:0``, file://
    rendezvous; saves what it saw to ``<out_dir>/rank<r>.pt``."""
    rank, init_file, out_dir, pipe_dir, data = argv
    import torch

    from phendiff_tpu_torch.parallel import mesh
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(WORLD_SIZE=str(DP_WORLD), RANK=rank, LOCAL_RANK="0")
    device = mesh.init_distributed("cuda", backend="gloo", init_method=f"file://{init_file}")
    train, grads, params = dp_train(torch)
    pipe = ConditionalDDIMPipeline.from_pretrained(pipe_dir, device="cuda")
    result = {"rank": mesh.data_rank(), "world": mesh.data_size(), "device": str(device),
              "backend": torch.distributed.get_backend(), "train": train,
              "grads": grads if rank == "0" else None, "params": params,
              "evaluator": dp_evaluator(torch, pipe, data),
              "comparison": dp_comparison(torch, pipe_dir, data, os.path.join(out_dir, "cmp"),
                                          fid=False)}
    result["comparison"].update(dp_fid_calls(torch, pipe_dir, data, os.path.join(out_dir, "fid")))
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.destroy()


def dp_grad_rule(torch, got_grads, want_grads, got_params, want_params, lr):
    """grad_check's rule between two runs of the same steps: the first
    step's gradients, and the parameters after the first step (2.01 lr
    apart at most) and after DP_STEPS steps (DP_STEPS x 2.01 lr), at most 1%
    of elements by more than lr / 10."""
    errs = {n: rel_l2(got_grads[n], want_grads[n]) for n in want_grads}
    rec = {"grad_rel_l2_max": max(errs.values()),
           "grad_rel_l2_worst": sorted(errs.items(), key=lambda kv: -kv[1])[:3], "lr": lr}
    ok = rec["grad_rel_l2_max"] <= GRAD_REL_L2_TOL
    for tag, got, want, steps in (("step_1", got_params[0], want_params[0], 1),
                                  (f"step_{DP_STEPS}", got_params[1], want_params[1], DP_STEPS)):
        rec[tag] = param_rule(got, want, lr, steps)
        ok &= rec[tag]["ok"]
    rec["ok"] = bool(ok)
    return rec


def param_rule(got, want, lr, steps=1, share=1e-2):
    """grad_check's rule on the parameters of two runs after ``steps`` steps
    (``want`` may lie on the host): at most steps x 2.01 lr apart, at most
    ``share`` of the elements by more than lr / 10.  An element whose
    gradient is at bf16 noise takes Adam's update of either sign, so two
    runs may put it 2 lr apart; the share of such elements is small."""
    param_max, far, total = 0.0, 0, 0
    for n, w in want.items():
        moved = (got[n].detach() - w.to(got[n].device)).abs()
        param_max = max(param_max, float(moved.max()))
        far, total = far + int((moved > 0.1 * lr).sum()), total + moved.numel()
    return {"param_max_abs_diff": param_max, "bound": 2.01 * lr * steps,
            "param_share_differing_by_lr_over_10": far / total, "share_bound": share,
            "bit_equal": param_max == 0.0,
            "ok": bool(param_max <= 2.01 * lr * steps and far / total <= share)}


def phase_dp(torch, env, data):
    """Data parallelism: (a) world 1 over NCCL bit-equal to no group, (b)
    world 2 over gloo on this card against world 1, (c) the times."""
    import shutil

    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.parallel import mesh
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.train import train_loop as TL
    from phendiff_tpu_torch.train.train_loop import TrainConfig
    from phendiff_tpu_torch.train.trainer import RunPaths, TrainerConfig, for_ddim_pipeline

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phd_dp_")
    rec = {"phase": "dp", "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    ok = True

    # -- (a) world 1 over NCCL against no group -----------------------------
    ddim = ConditionalDDIMPipeline.init_random(super_small(), SchedulerConfig(), seed=SEED,
                                               dtype=torch.bfloat16, device="cuda")
    sd = sd_pipeline(torch.bfloat16, SEED, cast=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    sd_images = torch.rand(TRAIN_BATCH, RES, RES, 3, generator=gen, device="cuda") * 2 - 1
    sd_labels = torch.tensor([0, 1], device="cuda").repeat(TRAIN_BATCH // 2)
    reduce_events = []
    inner = TL.all_reduce_mean_

    def timed_all_reduce(tensors):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        inner(tensors)
        ev[1].record()
        reduce_events.append(ev)

    def trainer_run(tag):
        cfg = TrainerConfig(train_data_dir=data, definition=(RES, RES),
                            train_batch_size=TRAIN_BATCH, num_epochs=2, max_train_steps=DP_STEPS,
                            eval_every_epochs=None, checkpointing_steps=1000,
                            mixed_precision="bf16", metrics_flush_every=DP_STEPS,
                            compute_metrics=False, train=TrainConfig(proba_uncond=0.1))
        trainer = for_ddim_pipeline(ddim, cfg, RunPaths.create(root, "exp", tag))
        reduce_events.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        state = trainer.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return ({"params": {n: p.detach() for n, p in state.params.items()},
                 "ema": state.ema_params},
                {"seconds": dt, "launches": read_launches(), "lr_scale":
                 trainer.train_cfg.optimizer.lr_scale,
                 "all_reduce_ms_per_step": [a.elapsed_time(b) for a, b in reduce_events]})

    def sd_step():
        step, state, kw, _ = sd_train_step(sd)
        draws = TL.make_draws(SEED, 0, kw["diffusion_shape"](tuple(sd_images.shape)),
                              sd.schedule.num_train_timesteps, 0.1, "cuda", posterior=True)
        reduce_events.clear()
        t0 = time.perf_counter()
        state, m = step(state, (sd_images, sd_labels), draws)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        params = {n: p.detach().clone() for n, p in state.params.items()}
        return params, {"seconds": dt, "loss": float(m["loss"]),
                        "all_reduce_ms": [a.elapsed_time(b) for a, b in reduce_events]}

    # the same arithmetic run after run: deterministic cuDNN algorithms and
    # index-add backward (the class embedding's), on both sides
    fill = torch.utils.deterministic.fill_uninitialized_memory
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    TL.all_reduce_mean_ = timed_all_reduce
    try:
        ddim_ref, _ = trainer_run("no_group")
        sd_ref, sd_ref_rec = sd_step()
        device = mesh.init_distributed("cuda", init_method=f"file://{os.path.join(root, 'nccl')}")
        nccl = {"backend": torch.distributed.get_backend(), "world": mesh.data_size(),
                "device": str(device),
                "nccl_version": ".".join(map(str, torch.cuda.nccl.version()))}
        ddim_got, ddim_rec = trainer_run("nccl_world1")
        sd_got, sd_rec = sd_step()
        mesh.destroy()
    finally:
        TL.all_reduce_mean_ = inner
        torch.backends.cudnn.deterministic = deterministic[0]
        torch.use_deterministic_algorithms(deterministic[1])
        torch.utils.deterministic.fill_uninitialized_memory = fill
    ddim_equal = all(torch.equal(ddim_got[k][n], ddim_ref[k][n])
                     for k in ("params", "ema") for n in ddim_ref[k])
    sd_equal = all(torch.equal(sd_got[n], sd_ref[n]) for n in sd_ref)
    rec["world1_nccl"] = {
        **nccl, "ddim_trainer": ddim_rec, "ddim_trainer_bit_equal_to_no_group": ddim_equal,
        "ddim_max_abs_diff": max(max_abs(ddim_got[k][n], ddim_ref[k][n])
                                 for k in ("params", "ema") for n in ddim_ref[k]),
        "sd_step": sd_rec, "sd_step_no_group": sd_ref_rec, "sd_step_bit_equal_to_no_group":
        sd_equal, "sd_max_abs_diff": max(max_abs(sd_got[n], sd_ref[n]) for n in sd_ref)}
    dp_launches = {"dp_world1_trainer": ddim_rec["launches"]}
    ok &= (ddim_equal and sd_equal and nccl["world"] == 1 and nccl["backend"] == "nccl"
           and ddim_rec["launches"] == launches_for(DP_STEPS, DP_STEPS)
           and ddim_rec["lr_scale"] == 1.0)
    del ddim_ref, ddim_got, sd_ref, sd_got, sd, sd_images
    torch.cuda.empty_cache()

    # -- (b) world 2 over gloo on this card against world 1 ------------------
    ref_train, ref_grads, ref_params = dp_train(torch)
    pipe32 = ConditionalDDIMPipeline.init_random(super_small(), SchedulerConfig(), seed=SEED,
                                                 device="cuda")
    pipe_dir = os.path.join(root, "pipe32")
    pipe32.save_pretrained(pipe_dir)
    ref_eval = dp_evaluator(torch, pipe32, data)
    ref_cmp = dp_comparison(torch, pipe_dir, data, os.path.join(root, "cmp_world1"), fid=False,
                            batch=BATCH // DP_WORLD)
    out_dir = os.path.join(root, "world2")
    os.makedirs(out_dir)
    worker_env = {k: v for k, v in os.environ.items()
                  if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    logs = [open(os.path.join(root, f"rank{r}.log"), "w+") for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
         os.path.join(root, "gloo"), out_dir, pipe_dir, data],
        env=worker_env, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(DP_WORLD)]
    try:
        codes = [p.wait(timeout=DP_WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_world2 = time.perf_counter() - t0
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read()[-3000:])
        log.close()
    if any(codes):
        fail(f"dp: a world-2 rank failed (exit codes {codes}):\n" + "\n---\n".join(tails))
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
           for r in range(DP_WORLD)]
    lr = TrainConfig().optimizer.learning_rate
    train_rule = dp_grad_rule(torch, got[0]["grads"], ref_grads, got[0]["params"], ref_params,
                              lr)
    replicas_equal = all(torch.equal(got[1]["params"][1][n], got[0]["params"][1][n])
                         for n in ref_params[1])
    feat_err = [rel_l2(torch.from_numpy(a), torch.from_numpy(b))
                for g in got for a, b in zip(g["evaluator"]["features"],
                                             ref_eval["features"])]
    w2_cmp = got[0]["comparison"]
    img_err = float(abs(w2_cmp["images01"] - ref_cmp["images01"]).max())
    loss_rel = abs(got[0]["train"]["losses"][0] - ref_train["losses"][0]) / abs(
        ref_train["losses"][0])
    world2 = {
        "ranks": [{k: g[k] for k in ("rank", "world", "device", "backend")} for g in got],
        "seconds": t_world2, "train_rank0": got[0]["train"], "train_rank1": got[1]["train"],
        "train_world1": ref_train, "first_step_loss_rel_err": loss_rel, "grad_rule": train_rule,
        "replicas_bit_equal": replicas_equal,
        "evaluator_features_rel_l2": feat_err, "tol_features_rel_l2": DP_FEATURES_REL_L2_TOL,
        "evaluator_metrics_equal_on_ranks": got[0]["evaluator"]["metrics"]
        == got[1]["evaluator"]["metrics"], "evaluator_metrics": got[0]["evaluator"]["metrics"],
        "comparison_pngs_equal_world1": w2_cmp["pngs"] == ref_cmp["pngs"],
        "comparison_pngs": len(w2_cmp["pngs"]),
        "comparison_images_max_abs_vs_world1_batch16": img_err,
        "tol_images_max_abs": DP_IMAGES_MAX_ABS_TOL,
        "comparison_fid_calls_by_rank": [g["comparison"]["fid_calls"] for g in got],
        "comparison_metrics_equal_on_ranks": w2_cmp["metrics"] == got[1]["comparison"]["metrics"],
        "comparison_seconds": {k: w2_cmp[k] for k in ("transfer_seconds", "metrics_seconds",
                                                     "fid_seconds")},
        "comparison_fid_metrics_by_rank": [g["comparison"]["fid_metrics"] for g in got],
    }
    rec["world2_gloo"] = world2
    want = launches_for(DP_STEPS, DP_STEPS)
    dp_launches["dp_world2_train_per_rank"] = got[0]["train"]["launches"]
    ok &= (all(g["world"] == DP_WORLD and g["backend"] == "gloo" and g["device"] == "cuda:0"
               for g in got)
           and all(g["train"]["launches"] == want and not g["train"]["plain_version_calls"]
                   and g["train"]["loss_finite"] for g in got)
           and got[0]["train"]["init_checksum"] == ref_train["init_checksum"]
           and loss_rel <= 1e-2 and train_rule["ok"] and replicas_equal
           and max(feat_err) <= DP_FEATURES_REL_L2_TOL
           and world2["evaluator_metrics_equal_on_ranks"]
           and world2["comparison_pngs_equal_world1"] and len(w2_cmp["pngs"]) == 2 * CMP_PER_CLASS
           and img_err <= DP_IMAGES_MAX_ABS_TOL
           and world2["comparison_fid_calls_by_rank"] == [1, 0]
           and got[0]["comparison"]["fid_metrics"] == got[1]["comparison"]["fid_metrics"]
           and all(map(math.isfinite, got[0]["comparison"]["fid_metrics"].values()))
           and world2["comparison_metrics_equal_on_ranks"]
           and all(math.isfinite(v) for v in w2_cmp["metrics"].values()))

    # -- (c) times -------------------------------------------------------------
    rec["times"] = {
        "note": "two ranks share one card: not a scaling figure",
        "world2_samples_per_s_by_rank": [g["train"]["samples_per_s_rank"] for g in got],
        "world2_samples_per_s_global": mean_of([g["train"]["samples_per_s_global"] for g in got]),
        "world1_samples_per_s": ref_train["samples_per_s_global"],
        "gloo_all_reduce_ms_per_step": mean_of([x for g in got
                                            for x in g["train"]["all_reduce_ms_per_step"]]),
        "nccl_world1_all_reduce_ms_per_step_ddim": mean_of(ddim_rec["all_reduce_ms_per_step"]),
        "nccl_world1_all_reduce_ms_sd_step": mean_of(sd_rec["all_reduce_ms"]),
        "nvidia_smi": env["nvidia_smi"],
    }
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = bool(ok)
    emit(rec)
    print(f"dp times ({env['nvidia_smi']}; two ranks share one card, not a scaling figure): "
          f"world 2 over gloo {rec['times']['world2_samples_per_s_global']:.2f} samples/s "
          f"global, {rec['times']['gloo_all_reduce_ms_per_step']:.2f} ms gloo all-reduce a "
          f"step; world 1 {rec['times']['world1_samples_per_s']:.2f} samples/s", flush=True)
    if not ok:
        fail(f"dp: {json.dumps(rec, default=str)[:4000]}")
    shutil.rmtree(root, ignore_errors=True)
    return rec, dp_launches, (ref_train, ref_grads, ref_params)

def phase_reco(torch, env, sfu_rate):
    """The trained-model round trip (``tools/trained_round_trip.py``'s
    ``quick_round_trip``): ``super_small`` trained ``RECO_TRAIN_STEPS`` steps
    at 64 px on a toy set, then a 50-step sample -> invert -> regenerate at
    batch 16 in f32, gated on ``reco_err``'s threshold; first each kernel at
    the shapes this path gives it."""
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.tools import trained_round_trip as R
    from phendiff_tpu_torch.tools.kernel_calls import group_norm_calls

    res, b_train, b_rt = R.QUICK_RES, R.QUICK_BATCH, R.RT_BATCH
    ok = True
    ok &= attention_check(torch, b_rt, (res // 4) ** 2, 32, 8, sfu_rate, "float32")["ok"]
    ok &= attention_check(torch, b_train, (res // 4) ** 2, 32, 8, sfu_rate)["ok"]
    ok &= attention_bwd_check(torch, b_train, (res // 4) ** 2, 32, 8, sfu_rate)["ok"]
    for s, c, g, act in sorted(group_norm_calls(res), key=str):
        ok &= gn_check(torch, b_rt, s, c, g, act, iters=3, dtype_name="float32")["ok"]
        ok &= gn_check(torch, b_train, s, c, g, act, iters=3)["ok"]
        ok &= gn_bwd_check(torch, b_train, s, c, g, act, sfu_rate, iters=3)["ok"]
    if not ok:
        fail("reco: a kernel disagrees with its plain version at the round trip's shapes")
    root = tempfile.mkdtemp(prefix="phd_reco_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launch_counts()
    with counting_plain_calls() as plain:
        run = R.quick_round_trip(root, RECO_TRAIN_STEPS, "cuda")
    launches = read_launches()
    dt = time.perf_counter() - t0
    want = launches_for(RECO_TRAIN_STEPS + 3 * R.RT_STEPS, RECO_TRAIN_STEPS)
    rec = {"phase": "reco", **run, "seconds": dt, "budget_s": RECO_BUDGET_S,
           "launches": launches, "launches_expected": want, "plain_version_calls": dict(plain),
           "threshold": 0.05, "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    emit(rec)
    if not (run["finite"] and run["summary"]["pass"] and launches == want and not plain):
        fail(f"reco: {json.dumps(rec, default=str)[:3000]}")
    shutil.rmtree(root, ignore_errors=True)
    return rec


def tp_sd_forward(torch, dtype_name):
    """One full-width SD-2.1 UNet forward at 128 px (latent 16), batch
    ``TP_SD_BATCH``, in ``dtype_name`` (TF32 off), on this rank's shards under the
    layout ``make_mesh`` made (whole at model size 1), after one warm-up
    forward: its launches, seconds and output (on the host).  The inputs
    and the weights (before the bf16 cast) are the same in both dtypes."""
    from torch.func import functional_call

    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.parallel import tp

    unet = sd_pipeline(getattr(torch, dtype_name), SEED).unet
    plan = tp.shard_module(unet)
    params = tp.shard_params(dict(unet.named_parameters()), plan)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    lat = RES // 8
    x = torch.randn(TP_SD_BATCH, lat, lat, 4, generator=gen, device="cuda")
    ctx = torch.randn(TP_SD_BATCH, 77, 1024, generator=gen, device="cuda")
    t = torch.full((TP_SD_BATCH,), 500, device="cuda")
    with torch.no_grad():
        functional_call(unet, params, (x, t, ctx))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = functional_call(unet, params, (x, t, ctx)).float()
        torch.cuda.synchronize()
    rec = {"seconds": time.perf_counter() - t0, "launches": read_launches(),
           "sharded_leaves": len(plan), "finite": bool(torch.isfinite(out).all())}
    return rec, out.cpu()


def tp_worker(argv) -> None:
    """One rank of the tp phase: gloo on ``cuda:0``, world ``TP_WORLD``, all
    of it one model axis; saves what it saw to ``<out_dir>/rank<r>.pt``."""
    rank, init_file, out_dir = argv
    import torch

    from phendiff_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(WORLD_SIZE=str(TP_WORLD), RANK=rank, LOCAL_RANK="0")
    device = mesh.init_distributed("cuda", backend="gloo", init_method=f"file://{init_file}")
    train, grads, params = dp_train(torch, model_parallel=TP_WORLD)
    sd = {k: tp_sd_forward(torch, dt) for k, dt in TP_SD_DTYPES.items()}
    result = {"rank": int(rank), "layout": mesh.make_mesh(TP_WORLD),
              "model_rank": mesh.model_rank(), "data_rank": mesh.data_rank(),
              "device": str(device), "backend": torch.distributed.get_backend(),
              "train": train, "grads": grads if rank == "0" else None, "params": params,
              "sd": {k: rec for k, (rec, _) in sd.items()},
              "sd_out": {k: out for k, (_, out) in sd.items()}}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.destroy()


def phase_tp(torch, env, sfu_rate, dp_ref):
    """Tensor parallelism (``parallel/tp.py``): each kernel at the shards'
    shapes, then two processes of this script (``--tp-worker``, gloo on
    ``cuda:0``, one replica over a model axis of 2): ``DP_STEPS`` DDIM train
    steps at batch 32 against the dp phase's world-1 steps, and one
    full-width SD UNet forward at 128 px, batch 8, in f32 and in bf16,
    against world 1."""
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.ops.attention import takes_kernel
    from phendiff_tpu_torch.ops.gn_kernels import gn_route
    from phendiff_tpu_torch.tools.kernel_calls import group_norm_calls, sd_unet_calls
    from phendiff_tpu_torch.train.train_loop import TrainConfig

    t_phase = time.perf_counter()
    mp = TP_WORLD
    # the kernels at the shards' shapes: half the heads, half the channels
    # and groups of every GroupNorm a ResnetBlock's norm2 could take
    ok = attention_check(torch, TRAIN_BATCH, 1024, 32 // mp, 8, sfu_rate)["ok"]
    ok &= attention_bwd_check(torch, TRAIN_BATCH, 1024, 32 // mp, 8, sfu_rate)["ok"]
    for s, c, g, act in sorted({k for k in group_norm_calls(RES) if k[3] == "silu"}):
        ok &= gn_check(torch, TRAIN_BATCH, s, c // mp, g // mp, act, iters=3)["ok"]
        ok &= gn_bwd_check(torch, TRAIN_BATCH, s, c // mp, g // mp, act, sfu_rate, iters=3)["ok"]
    for dname in TP_SD_DTYPES.values():
        sd_calls = sd_unet_calls(SDUNetConfig(), RES // 8, getattr(torch, dname))
        for s_q, s_kv, h, d in sorted({k[:4] for k in sd_calls["attention"]}):
            if takes_kernel(s_q, s_kv, d) and h % mp == 0:
                ok &= attention_check(torch, TP_SD_BATCH, s_q, h // mp, d, sfu_rate,
                                      dname)["ok"]
        for s, c, g, act, isz in sorted({k for k in sd_calls["group_norm"] if k[3] == "silu"}):
            if gn_route(s, c // mp, g // mp, isz, False) == "cluster":
                ok &= gn_check(torch, TP_SD_BATCH, s, c // mp, g // mp, act, iters=3,
                               dtype_name=dname)["ok"]
    if not ok:
        fail("tp: a kernel disagrees with its plain version at the shards' shapes")

    ref_train, ref_grads, ref_params = dp_ref
    sd_ref, sd_ref_out = {}, {}
    for k, dt in TP_SD_DTYPES.items():
        sd_ref[k], sd_ref_out[k] = tp_sd_forward(torch, dt)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="phd_tp_")
    worker_env = {k: v for k, v in os.environ.items()
                  if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    logs = [open(os.path.join(root, f"rank{r}.log"), "w+") for r in range(mp)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
         os.path.join(root, "gloo"), root],
        env=worker_env, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(mp)]
    try:
        codes = [p.wait(timeout=TP_WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_workers = time.perf_counter() - t0
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read()[-3000:])
        log.close()
    if any(codes):
        fail(f"tp: a rank failed (exit codes {codes}):\n" + "\n---\n".join(tails))
    got = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(mp)]

    lr = TrainConfig().optimizer.learning_rate
    rule = dp_grad_rule(torch, got[0]["grads"], ref_grads, got[0]["params"], ref_params, lr)
    gathered_equal = all(torch.equal(got[1]["params"][1][n], got[0]["params"][1][n])
                         for n in ref_params[1])
    local = [g["train"].pop("local_params") for g in got]
    replicated_equal, shard_shapes = True, True
    for n, full in ref_params[1].items():
        a, b = local[0][n], local[1][n]
        if a.shape == full.shape:
            replicated_equal &= bool(torch.equal(a, b))
        else:
            dims = [i for i, (x, y) in enumerate(zip(a.shape, full.shape)) if x != y]
            shard_shapes &= (len(dims) == 1 and a.shape == b.shape
                             and a.shape[dims[0]] * mp == full.shape[dims[0]])
    loss_rel = abs(got[0]["train"]["losses"][0] - ref_train["losses"][0]) / abs(
        ref_train["losses"][0])
    want = launches_for(DP_STEPS, DP_STEPS)

    def narrow_calls(widths):
        """GroupNorm calls at half the groups (the norm2 of the 17 ResnetBlocks)
        and attention calls at half the heads, of DP_STEPS forwards."""
        gn = sum(n for w, n in widths["group_norm"].items() if w.endswith(f" {32 // mp})"))
        return {"group_norm_half": gn, "attention_half_heads":
                widths["attention_heads"].get(str(32 // mp), 0),
                "attention_calls": sum(widths["attention_heads"].values())}

    narrow = [narrow_calls(g["train"]["widths"]) for g in got]
    # f32: the shards against world 1, f32 rounding alone.  bf16: the shards
    # and world 1 each against world 1's f32 output, at the bf16 forward
    # limit; the shards' distance over world 1's is recorded (a row layer's
    # two partial sums round to bf16 before the all-reduce adds them)
    sd_err = [rel_l2(g["sd_out"]["f32"], sd_ref_out["f32"]) for g in got]
    ref32 = sd_ref_out["f32"]
    bf16_world1 = rel_l2(sd_ref_out["bf16"], ref32)
    bf16_err = [rel_l2(g["sd_out"]["bf16"], ref32) for g in got]
    sd_bf16 = {"world1_vs_f32_world1": bf16_world1, "by_rank_vs_f32_world1": bf16_err,
               "by_rank_vs_bf16_world1": [rel_l2(g["sd_out"]["bf16"], sd_ref_out["bf16"])
                                          for g in got],
               "ratio_by_rank": [e / bf16_world1 for e in bf16_err],
               "tol_rel_l2": FORWARD_REL_L2_TOL}
    rec = {
        "phase": "tp", "world": mp, "layouts": [g["layout"] for g in got],
        "model_ranks": [g["model_rank"] for g in got],
        "ranks": [{k: g[k] for k in ("rank", "device", "backend")} for g in got],
        "worker_seconds": t_workers, "train_rank0": got[0]["train"],
        "train_rank1": got[1]["train"], "first_step_loss_rel_err": loss_rel,
        "grad_rule": rule, "gathered_params_bit_equal_on_ranks": gathered_equal,
        "replicated_leaves_bit_equal": replicated_equal, "shard_shapes_ok": shard_shapes,
        "narrow_calls_by_rank": narrow,
        "sd_forward": {"world1": sd_ref, "by_rank": [g["sd"] for g in got],
                       "f32_rel_l2_vs_world1": sd_err, "f32_tol_rel_l2": SD_F32_REL_L2_TOL,
                       "bf16": sd_bf16},
        "times": {"note": "two ranks share one card: not a scaling figure",
                  "step_seconds_by_rank": [g["train"]["step_seconds"] for g in got],
                  "samples_per_s_by_rank": [g["train"]["samples_per_s_rank"] for g in got],
                  "world1_samples_per_s": ref_train["samples_per_s_global"],
                  "sd_forward_seconds_by_rank": [{k: r["seconds"] for k, r in g["sd"].items()}
                                                 for g in got],
                  "sd_forward_seconds_world1": {k: r["seconds"] for k, r in sd_ref.items()},
                  "nvidia_smi": env["nvidia_smi"]},
    }
    ok = (all(g["layout"] == {"data": 1, "model": mp} and g["backend"] == "gloo"
              and g["device"] == "cuda:0" for g in got)
          and [g["model_rank"] for g in got] == list(range(mp))
          and all(g["train"]["launches"] == want and not g["train"]["plain_version_calls"]
                  and g["train"]["loss_finite"] for g in got)
          and all(n == {"group_norm_half": 17 * DP_STEPS, "attention_half_heads": 6 * DP_STEPS,
                        "attention_calls": 6 * DP_STEPS} for n in narrow)
          and got[0]["train"]["init_checksum"] == ref_train["init_checksum"]
          and loss_rel <= 1e-2 and rule["ok"] and gathered_equal and replicated_equal
          and shard_shapes
          and all(g["sd"][k]["finite"] and g["sd"][k]["launches"] == sd_ref[k]["launches"]
                  for g in got for k in TP_SD_DTYPES)
          and max(sd_err) <= SD_F32_REL_L2_TOL
          and max(bf16_world1, *bf16_err) <= FORWARD_REL_L2_TOL)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = bool(ok)
    emit(rec)
    print(f"tp times ({env['nvidia_smi']}; two ranks share one card, not a scaling figure): "
          f"a DDIM train step at batch {TRAIN_BATCH} "
          f"{mean_of(got[0]['train']['step_seconds'][1:]):.4f} s "
          f"on model rank 0 of 2 over gloo, "
          f"{mean_of(ref_train['step_seconds'][1:]):.4f} s at world 1", flush=True)
    if not ok:
        fail(f"tp: {json.dumps(rec, default=str)[:4000]}")
    shutil.rmtree(root, ignore_errors=True)
    return {"tp_train_per_rank": got[0]["train"]["launches"],
            **{f"tp_sd_forward_{k}_per_rank": got[0]["sd"][k]["launches"] for k in TP_SD_DTYPES}}

def seg_train_step(torch, pipe, clip_mode, cache_dtype):
    """The segmented SD step (``SegmentedSDTrainStep``) as the segmented
    trainer builds it over ``pipe`` (bf16 compute, f32 master weights
    cloned from the pipeline, ctx stage, EMA, global clip at 1.0, lr 1e-5,
    the optimizer of ``sd_train_step``): ``(step, params, opt_state, ema)``."""
    from phendiff_tpu_torch.models.sd_segmented import SegmentedSDUNet
    from phendiff_tpu_torch.models.sd_unet import SDUNet
    from phendiff_tpu_torch.train.ema import EMAConfig
    from phendiff_tpu_torch.train.segmented_train import CtxEmbed, SegmentedSDTrainStep
    from phendiff_tpu_torch.train.train_loop import Optimizer, OptimizerConfig

    with torch.device("meta"):
        seg = SegmentedSDUNet(SDUNet(pipe.unet_config, dtype=torch.bfloat16))
        ctx = CtxEmbed(pipe.num_classes, pipe.class_embedding_dim, dtype=torch.bfloat16)
    opt = Optimizer(OptimizerConfig(learning_rate=1e-5, max_grad_norm=None))
    step = SegmentedSDTrainStep(
        seg, pipe.schedule, opt, proba_uncond=0.0, ema=EMAConfig(), max_grad_norm=1.0,
        clip_mode=clip_mode, ctx_module=ctx,
        cache_dtype=None if cache_dtype is None else getattr(torch, cache_dtype))
    params = {n: p.detach().float().clone() for n, p in pipe.unet.named_parameters()}
    params["class_embedding.embedding.weight"] = (
        pipe.class_embedding.embedding.weight.detach().float().clone())
    return step, params, step.init_opt_state(params), {n: t.clone() for n, t in params.items()}


def phase_sd_segmented(torch, env, sd_folder, data):
    """The stage-per-device SD route (``models/sd_segmented.py``,
    ``parallel/pp.py``, ``train/segmented_train.py``, the segmented trainer,
    ``--segmented_sd on``, the comparison's ``segmented_sd``): full-width
    SD-2.1, seed-0 weights, the one card."""
    import dataclasses

    import numpy as np
    from PIL import Image

    from phendiff_tpu_torch.cli import args as cli_args
    from phendiff_tpu_torch.cli import train_cli
    from phendiff_tpu_torch.experiments.comparison import ComparisonConfig, ComparisonExperiment
    from phendiff_tpu_torch.models.autoencoder_kl import encode_to_latents
    from phendiff_tpu_torch.models.sd_segmented import SegmentedSDUNet
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.ops.routes import reset_launch_counts
    from phendiff_tpu_torch.parallel.pp import PipelinedSDUNet
    from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline
    from phendiff_tpu_torch.tools.kernel_calls import sd_unet_calls
    from phendiff_tpu_torch.train.segmented_trainer import SegmentedSDTrainer
    from phendiff_tpu_torch.train.train_loop import make_draws
    from phendiff_tpu_torch.train.trainer import RunPaths

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phd_seg_")
    rec = {"phase": "sd_segmented", "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    ok = True
    lat = RES // 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    pipe = sd_pipeline(torch.bfloat16, SEED, cast=False)
    pipe32 = sd_pipeline(torch.float32, SEED)

    with counting_plain_calls() as plain:
        # -- 1. the segmented forward, and four microbatches through the stages
        x = torch.randn(SEG_FWD_BATCH, lat, lat, 4, generator=gen, device="cuda")
        t = torch.randint(0, 1000, (SEG_FWD_BATCH,), generator=gen, device="cuda")
        seq = pipe.encode_class(torch.arange(SEG_FWD_BATCH, device="cuda") % 2)
        deterministic = (torch.backends.cudnn.deterministic,
                         torch.are_deterministic_algorithms_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with torch.no_grad():
                mono = pipe.unet(x, t, seq)
                segd = SegmentedSDUNet(pipe.unet)(x, t, seq)
        finally:
            torch.backends.cudnn.deterministic = deterministic[0]
            torch.use_deterministic_algorithms(deterministic[1])
        pp = PipelinedSDUNet(pipe32.unet, devices=["cuda:0"])
        pp.place_params()
        with torch.no_grad():
            whole = pp(x, t, seq)
            micro = pp(x, t, seq, num_microbatches=SEG_MICROBATCHES)
        torch.cuda.synchronize()
        rec["forward"] = {
            "batch": SEG_FWD_BATCH, "latent": lat, "bf16_bit_equal_to_monolith":
            bool(torch.equal(segd, mono)), "finite": bool(torch.isfinite(segd).all()),
            "f32_microbatches": SEG_MICROBATCHES, "microbatched_vs_whole_rel_l2":
            rel_l2(micro, whole), "tol_rel_l2": SEG_PP_REL_L2,
            "stage_devices": {k: str(d) for k, d in pp.device_of.items()}}
        ok &= (rec["forward"]["bf16_bit_equal_to_monolith"] and rec["forward"]["finite"]
               and rec["forward"]["microbatched_vs_whole_rel_l2"] <= SEG_PP_REL_L2)
        print(f"sd_segmented stage devices: {rec['forward']['stage_devices']}", flush=True)

        # -- 2. the input VJP against autograd through the monolith, f32 -----
        xb, tb, sb = x[:SEG_VJP_BATCH], t[:SEG_VJP_BATCH], seq[:SEG_VJP_BATCH]
        w = torch.randn(xb.shape, generator=gen, device="cuda")
        with pipe32.frozen():
            xx = xb.clone().requires_grad_()
            (want_dx,) = torch.autograd.grad(pipe32.unet(xx, tb, sb), xx, w)
            reset_launch_counts()
            out, vjp_fn = SegmentedSDUNet(pipe32.unet).forward_with_input_vjp(xb, tb, sb)
            got_dx = vjp_fn(w)
            torch.cuda.synchronize()
            launches = read_launches(SD_KEYS)
        calls32 = sd_unet_calls(SDUNetConfig(), lat, torch.float32)
        want = add_launches((2, predicted_launches(calls32)),
                            (1, predicted_launches(calls32, False, True)))
        rec["input_vjp"] = {"batch": SEG_VJP_BATCH, "rel_l2": rel_l2(got_dx, want_dx),
                            "tol_rel_l2": SEG_VJP_REL_L2, "launches": launches,
                            "launches_expected": want}
        ok &= rec["input_vjp"]["rel_l2"] <= SEG_VJP_REL_L2 and launches == want
        # vjp_fn holds the f32 UNet: drop it before the train step's peaks
        del pp, whole, micro, mono, segd, out, vjp_fn, got_dx, want_dx, xx
        del pipe32
        torch.cuda.empty_cache()

        # -- 3. the train step in each clip mode against the one-program step
        images = torch.rand(TRAIN_BATCH, RES, RES, 3, generator=gen, device="cuda") * 2 - 1
        labels = torch.tensor([0, 1], device="cuda").repeat(TRAIN_BATCH // 2)
        shape = (TRAIN_BATCH, lat, lat, 4)
        draws0 = make_draws(SEED, 0, shape, pipe.schedule.num_train_timesteps, 0.0, "cuda",
                            posterior=True)
        step1, state1, _, opt1 = sd_train_step(pipe, False, proba_uncond=0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state1, m1 = step1(state1, (images, labels), draws0)
        torch.cuda.synchronize()
        one = {"loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
               "seconds_first_step": time.perf_counter() - t0,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        # the one-program parameters after the step, on the host: the
        # segmented modes' peaks are measured without the one-program state
        ref = {n[len("unet."):] if n.startswith("unet.") else n: p.detach().cpu()
               for n, p in state1.params.items()}
        del step1, opt1, state1, m1
        rec["one_program"] = one
        lr = 1e-5
        enc = vae_part_calls(torch, RES, "encode")
        unet_calls = sd_unet_calls(SDUNetConfig(), lat)
        rec["train"] = {}
        for mode, (clip_mode, cache_dtype) in SEG_CLIP_MODES.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step, params, opt_state, ema = seg_train_step(torch, pipe, clip_mode, cache_dtype)

            def run(k, draws):
                with torch.no_grad():
                    latents = encode_to_latents(pipe.vae, images, noise=draws.enc_noise)
                return step(params, opt_state, latents, labels, draws, ema_params=ema, step=k)[3]

            m = run(0, draws0)
            torch.cuda.synchronize()
            r = {"clip_mode": clip_mode, "cache_dtype": cache_dtype,
                 "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "loss_rel_err": abs(float(m["loss"]) - one["loss"]) / abs(one["loss"]),
                 "grad_norm_rel_err": abs(float(m["grad_norm"]) - one["grad_norm"])
                 / one["grad_norm"], **param_rule(params, ref, lr, share=SEG_SHARE[mode])}
            reset_launch_counts()
            t0 = time.perf_counter()
            for k in range(1, 1 + SEG_STEPS):
                m = run(k, make_draws(SEED, k, shape, pipe.schedule.num_train_timesteps, 0.0,
                                      "cuda", posterior=True))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            chains = 2 if clip_mode == "recompute" else 1
            want = add_launches(
                (SEG_STEPS, predicted_launches(enc)),
                (SEG_STEPS * (1 + chains), predicted_launches(unet_calls)),
                (SEG_STEPS * chains, predicted_launches(unet_calls, False, True)))
            r.update({"ms_per_step": 1e3 * dt / SEG_STEPS,
                      "samples_per_s": TRAIN_BATCH * SEG_STEPS / dt,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": read_launches(SD_KEYS), "launches_expected": want,
                      "loss_finite": math.isfinite(float(m["loss"]))})
            rec["train"][mode] = r
            ok &= (r["loss_rel_err"] <= 1e-2 and r["ok"] and r["launches"] == want
                   and r["loss_finite"])
            del step, params, opt_state, ema
        del ref
        torch.cuda.empty_cache()

        # -- 4. the CLI: 3 steps, then the checkpoint resumed, the save loaded
        argv = ["--run_name", "seg_128px", "--model_type", "StableDiffusion",
                "--pretrained_model_name_or_path", sd_folder, "--train_data_dir", data,
                "--definition", str(RES), "--train_batch_size", str(TRAIN_BATCH),
                "--max_num_steps", "3", "--eval_save_model_every_opti_steps", "3",
                "--no_compute_fid", "--proba_uncond", "0.1", "--learning_rate", "1e-5",
                "--components_to_train", "denoiser", "class_embedding",
                "--segmented_sd", "on", "--segmented_clip_mode", "recompute",
                "--exp_output_dirs_parent_folder", os.path.join(root, "cli")]
        t0 = time.perf_counter()
        rc = train_cli.main(argv)
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        run_dir = os.path.join(root, "cli", "phendiff-tpu", "seg_128px")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        t0 = time.perf_counter()
        args = cli_args.build_parser().parse_args(argv + ["--resume_from_checkpoint", "latest"])
        resumed = SegmentedSDTrainer(pipe, train_cli.trainer_config_from_args(args),
                                     RunPaths(run_dir, os.path.join(run_dir, "checkpoints"),
                                              os.path.join(run_dir, "full_pipeline_save"),
                                              os.path.join(root, "cli", ".fidelity_cache")))
        epoch, skip = resumed.maybe_resume()
        t_resume = time.perf_counter() - t0
        t0 = time.perf_counter()
        saved = SDImg2ImgPipeline.from_pretrained(os.path.join(run_dir, "full_pipeline_save"),
                                                  device="cuda")
        t_load = time.perf_counter() - t0
        # the save (at step 3) holds the EMA weights the checkpoint restored
        ema_equal = all(torch.equal(p, resumed.state.ema_params[n])
                        for n, p in saved.unet.named_parameters())
        rec["cli"] = {"rc": rc, "seconds": t_cli, "argv": argv,
                      "steps": [r["step"] for r in recs if "loss" in r], "losses": losses,
                      "checkpoints": sorted(os.listdir(os.path.join(run_dir, "checkpoints"))),
                      "resumed_step": resumed.state.step, "resume_epoch_skip": [epoch, skip],
                      "resume_seconds": t_resume, "load_seconds": t_load,
                      "saved_equals_resumed_ema": ema_equal,
                      "saved_finite": all(bool(torch.isfinite(p).all())
                                          for p in saved.unet.parameters())}
        ok &= (rc == 0 and len(losses) == 3 and all(math.isfinite(v) for v in losses)
               and resumed.state.step == 3 and ema_equal and rec["cli"]["saved_finite"])
        del resumed, saved
        torch.cuda.empty_cache()

        # -- 5. the comparison's segmented route against its one-module route
        methods = ["ddib", "linear_interp_custom_guidance_inverted_start"]
        cfg = ComparisonConfig.from_dict({
            "output_dir": os.path.join(root, "cmp_seg"), "pipelines": {"sd": sd_folder},
            "dataset_train": data, "definition": [RES, RES], "methods": methods,
            "method_params": {m: {"batch_size": SEG_CMP_BATCH} for m in methods},
            "num_inference_steps": CMP_STEPS, "debug": True, "inference_param_dtype": None,
            "metrics": {"fid": False, "isc": False, "kid": False}, "segmented_sd": True})
        t0 = time.perf_counter()
        exp = ComparisonExperiment(cfg, device="cuda")
        exp.run_transfers()
        exp.config, exp.segmented = dataclasses.replace(
            cfg, output_dir=os.path.join(root, "cmp_one"), segmented_sd=False), False
        exp.run_transfers()
        torch.cuda.synchronize()
        t_cmp = time.perf_counter() - t0
        levels = {}
        for method in methods:
            a_dir = os.path.join(root, "cmp_seg", method)
            files = sorted(os.path.relpath(os.path.join(d, f), a_dir)
                           for d, _, fs in os.walk(a_dir) for f in fs if "_to_" in f)
            diffs = [np.abs(np.asarray(Image.open(os.path.join(a_dir, f)), np.int16)
                            - np.asarray(Image.open(os.path.join(root, "cmp_one", method, f)),
                                         np.int16)) for f in files]
            levels[method] = {"images": len(files), "max_levels": int(max(d.max() for d in diffs)),
                              "share_differing": float(np.mean([(d > 0).mean() for d in diffs]))}
        rec["comparison"] = {"batch": SEG_CMP_BATCH, "steps": CMP_STEPS, "dtype": "float32",
                             "seconds_both_routes": t_cmp, "levels": levels,
                             "bound_levels": SEG_CMP_LEVELS}
        ok &= all(v["images"] == SEG_CMP_BATCH and v["max_levels"] <= SEG_CMP_LEVELS
                  for v in levels.values())
        del exp
    rec["plain_version_calls"] = dict(plain)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["budget_s"] = SEG_BUDGET_S
    ok &= not plain
    rec["ok"] = bool(ok)
    emit(rec)
    print(f"sd_segmented ({env['nvidia_smi']}): one-program step peak "
          f"{one['peak_mem_gib']:.2f} GiB; " + "; ".join(
              f"{k} {v['ms_per_step']:.1f} ms/step, peak {v['peak_mem_gib']:.2f} GiB"
              for k, v in rec["train"].items()), flush=True)
    if not ok:
        fail(f"sd_segmented: {json.dumps(rec, default=str)[:4000]}")
    del pipe
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return {f"sd_segmented_{k}": v["launches"] for k, v in rec["train"].items()}


def adaln_check(torch):
    """The fused DiT boundary kernel at DiT-XL/2's (32, 1024, 1152) in bf16:
    each variant once against the composition (x' within one bf16 ulp of
    ``addcmul``'s, z no farther from the f32 composition than the bf16
    composition is), and the full variant's device time in a CUDA graph
    against its byte bound (x and y read, x' and z written) and the bf16
    composition (the library yardstick) and the f32 one (the plain
    version)."""
    from phendiff_tpu_torch.ops.adaln_norm import adaln_norm, adaln_norm_plain

    b, s, c = BATCH, 1024, 1152
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x, y = (torch.randn(b, s, c, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    mod = (0.5 * torch.randn(b, 6, c, generator=g, device="cuda")).to(torch.bfloat16)
    mod[:, 1::3] += 1
    shift, scale1p, gate = mod[:, 3], mod[:, 4], mod[:, 2]  # unbind views, row stride 6C
    xf, gf, yf, sf, cf = (t.float() for t in (x, gate, y, shift, scale1p))
    worst = {}
    ok = True
    with torch.no_grad():
        for variant, keep in (("full", True), ("no_y", True), ("no_write", False)):
            gg, yy, g32, y32 = (None,) * 4 if variant == "no_y" else (gate, y, gf, yf)
            got_x, got_z = adaln_norm(x, gg, yy, shift, scale1p, eps=1e-6, keep_x=keep)
            plain_x, plain_z = adaln_norm_plain(x, gg, yy, shift, scale1p, eps=1e-6)
            _, ref_z = adaln_norm_plain(xf, g32, y32, sf, cf, eps=1e-6)
            rec = {"z_rel_l2": rel_l2(got_z, ref_z), "composition_z_rel_l2": rel_l2(plain_z, ref_z)}
            if variant == "full":
                rec["x_ulps"] = int((got_x.view(torch.int16).int()
                                     - plain_x.view(torch.int16).int()).abs().max())
            ok &= (rec["z_rel_l2"] <= rec["composition_z_rel_l2"] and rec.get("x_ulps", 0) <= 1
                   and (got_x is None) == (variant == "no_write"))
            worst[variant] = rec
        ms = graph_ms(lambda: adaln_norm(x, gate, y, shift, scale1p, eps=1e-6))
        library_ms = graph_ms(lambda: adaln_norm_plain(x, gate, y, shift, scale1p, eps=1e-6))
        plain_ms = graph_ms(lambda: adaln_norm_plain(xf, gf, yf, sf, cf, eps=1e-6), iters=5)
    bound_ms = 4 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    rec = {"phase": "adaln_check", "shape": [b, s, c], "dtype": "bfloat16", "variants": worst,
           "ms": ms, "bound_ms": bound_ms, "pct_of_bound": 100 * bound_ms / ms,
           "library_ms": library_ms, "plain_ms": plain_ms, "ok": ok}
    emit(rec)
    if not ok:
        fail(f"the fused DiT boundary kernel against its composition: {worst}")
    if bound_ms / ms < ADALN_MIN_SHARE_OF_BOUND:
        fail(f"the fused DiT boundary kernel reads {100 * bound_ms / ms:.1f}% of its byte bound, "
             f"below {100 * ADALN_MIN_SHARE_OF_BOUND:.0f}%")
    return rec


def phase_dit(torch):
    """DiT-XL/2 at 512 px (random weights, bf16) at batch 32: one forward's
    launches from zeroed counters (its 28 attention calls each one launch
    of the D = 72 warpgroup kernel, none on the plain route; its 57
    sub-layer boundaries each one launch of the fused boundary kernel, none
    on the composition, so 85 glue launches with the 28 GELUs) and the
    forward's time."""
    from phendiff_tpu_torch.models import dit as dit_mod
    from phendiff_tpu_torch.models.dit import DiT, DiTConfig
    from phendiff_tpu_torch.ops.routes import launch_counts, reset_launch_counts
    from phendiff_tpu_torch.pipelines.latent_vae import build_on

    cfg = DiTConfig()
    model = build_on(lambda: DiT(cfg, dtype=torch.bfloat16), torch.device("cuda"))
    model = model.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    model = model.to(torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(BATCH, cfg.input_size, cfg.input_size, cfg.in_channels, generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.full((BATCH,), 500, device="cuda")
    y = torch.arange(BATCH, device="cuda") % cfg.num_classes
    with torch.no_grad():
        model(x, t, y)  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        dit_mod.glue_launches = 0
        out = model(x, t, y)
        torch.cuda.synchronize()
        launches, counts = attn_launches("fwd"), launch_counts()
        plain_route = counts["attention_plain_route"]
        boundary = {"glue": dit_mod.glue_launches, "launches": counts["adaln_norm"],
                    "plain_calls": counts["adaln_norm_plain_calls"]}
        ms = cuda_ms(lambda: model(x, t, y), iters=5, warmup=1)
    want_boundary = {"glue": 1 + 3 * cfg.depth, "launches": 1 + 2 * cfg.depth, "plain_calls": 0}
    rec = {"phase": "dit", "batch": BATCH, "res": 8 * cfg.input_size, "depth": cfg.depth,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim,
           "params": sum(p.numel() for p in model.parameters()),
           "attention_calls": cfg.depth, "launches": launches,
           "plain_route_calls": plain_route, "boundary": boundary,
           "boundary_expected": want_boundary, "finite": bool(torch.isfinite(out).all()),
           "ms_per_forward": ms}
    emit(rec)
    if launches != attn_launches_for("wgmma", cfg.depth) or plain_route or not rec["finite"]:
        fail(f"DiT-XL/2's forward: expected {cfg.depth} launches of the D = 72 warpgroup kernel "
             f"and none on the plain route, got {launches} and {plain_route} (finite: "
             f"{rec['finite']})")
    if boundary != want_boundary:
        fail(f"DiT-XL/2's forward: boundary kernel counts {boundary} != {want_boundary}")
    del model, x, out
    torch.cuda.empty_cache()
    return rec


def residual_times(torch, shape):
    """Device times (CUDA graphs) of the residual kernel at ``shape`` in bf16,
    with one bias and with two, each call first held bit-equal to the plain
    version; ATen's adds as the convs ran them (a [C] broadcast add after
    each conv, then the residual add: the library yardstick); the plain
    version; the byte bound (x and h read, out written)."""
    from phendiff_tpu_torch.ops.residual_bias import residual_bias, residual_bias_plain

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x, h = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    b, b2 = (torch.randn(shape[-1], generator=g, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    rec = {"shape": list(shape), "dtype": "bfloat16",
           "bound_ms": 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3}
    ok = True
    with torch.no_grad():
        for name, biases, library in (("one_bias", (b,), lambda: x + (h + b)),
                                      ("two_biases", (b, b2), lambda: (x + b2) + (h + b))):
            ok &= bool(torch.equal(residual_bias(x, h, *biases),
                                   residual_bias_plain(x, h, *biases)))
            ms = graph_ms(lambda: residual_bias(x, h, *biases))
            rec[name] = {"ms": ms, "pct_of_bound": 100 * rec["bound_ms"] / ms,
                         "library_ms": graph_ms(library),
                         "plain_ms": graph_ms(lambda: residual_bias_plain(x, h, *biases),
                                              iters=5)}
    rec["ok"] = ok
    return rec


def phase_resnet_bias(torch):
    """The residual kernel at the DDIM's largest residual map and at SD's:
    bit-equal to its plain version, and its device time against its byte
    bound."""
    ddim = residual_times(torch, (128, RES, RES, 64))
    sd = residual_times(torch, (256, 16, 16, 320))
    worst = min(ddim["one_bias"]["pct_of_bound"], ddim["two_biases"]["pct_of_bound"])
    rec = {"phase": "resnet_bias", "ddim": ddim, "sd": sd}
    emit(rec)
    if not (ddim["ok"] and sd["ok"]):
        fail(f"the residual kernel against its plain version: {rec}")
    if worst < 100 * RESIDUAL_MIN_SHARE_OF_BOUND:
        fail(f"the residual kernel reads {worst:.1f}% of its byte bound, below "
             f"{100 * RESIDUAL_MIN_SHARE_OF_BOUND:.0f}%")
    return rec


def mean_of(xs) -> float:
    return sum(xs) / len(xs) if xs else float("nan")


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
    from phendiff_tpu_torch.ops.routes import launch_counts, plain_kernels, reset_launch_counts
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.pipelines.transfer import ddib
    from phendiff_tpu_torch.tools.kernel_calls import group_norm_calls, unet_calls

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
    addend_per_forward = unet_calls(ucfg, RES)["group_norm_addend"]
    reset_launch_counts()
    denoise(images, torch.full((BATCH,), 500, device="cuda"), src)
    torch.cuda.synchronize()
    counts = launch_counts()
    attn_per_forward, gn_per_forward = counts["flash_attn_fwd"], counts["group_norm_silu"]
    if sum(per_forward.values()) != 41 or gn_per_forward != 41 or attn_per_forward != 6:
        fail(f"expected 41 GroupNorm and 6 attention calls per forward, got "
             f"{sum(per_forward.values())} recorded, {gn_per_forward} and {attn_per_forward}")
    # the 17 ResnetBlocks' time embeddings go into the GroupNorm kernel
    addend_counts = (counts["group_norm_silu_addend"], counts["group_norm_addend_materialised"])
    if sum(addend_per_forward.values()) != 17 or addend_counts != (17, 0):
        fail(f"expected 17 GroupNorm launches with an addend and none materialised per "
             f"forward, got {sum(addend_per_forward.values())} recorded, {addend_counts}")
    # and their conv biases to the GroupNorm addend and the residual kernel
    residual_per_forward = {k: counts[k] for k in RESIDUAL_KEYS}
    if tuple(residual_per_forward.values()) != (17, 0):
        fail(f"expected 17 residual launches and no plain call per forward (one a deferring "
             f"ResnetBlock), got {residual_per_forward}")

    checks_ok = True
    attn = attention_check(torch, BATCH, 1024, 32, 8, sfu_rate)
    checks_ok &= attn["ok"]
    checks_ok &= attention_check(torch, 2, 4096, 10, 64, sfu_rate)["ok"]
    # DiT-XL/2's heads of 72 (the warpgroup kernel at every S in bf16): its
    # transfer's shape, then a partial 128-key tile and S below one tile
    dit_attn = attention_check(torch, BATCH, 1024, 16, 72, sfu_rate)
    checks_ok &= dit_attn["ok"]
    for s_ragged in (300, 17):
        for dtype_name in ("bfloat16", "float32"):
            checks_ok &= attention_check(torch, 2, s_ragged, 3, 72, sfu_rate, dtype_name)["ok"]
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
    addend_recs = {}
    for s, c, groups, _, _ in sorted(addend_per_forward):
        addend_recs[(s, c, groups)] = rec = gn_addend_check(torch, BATCH, s, c, groups)
        checks_ok &= rec["ok"]
    emit({"phase": "gn_addend", "calls_per_forward": sum(addend_per_forward.values()),
          **{k: sum(n * addend_recs[key[:3]][k] for key, n in addend_per_forward.items())
             for k in ("ms", "add_then_gn_ms", "gn_ms", "bound_ms")}})
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
    reset_launch_counts()
    t0 = time.perf_counter()
    out = ddib(denoise, pipe.schedule, images, src, tgt, num_inference_steps=STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    forwards = 2 * STEPS
    want = launches_for(forwards, 0)
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

    # -- 6-8. training: gradients, train path, trainer ----------------------
    train_pipe = ConditionalDDIMPipeline.init_random(
        ucfg, SchedulerConfig(), seed=SEED, dtype=torch.bfloat16, device="cuda")
    phase_grad_check(torch, train_pipe)
    train = phase_train_path(torch, train_pipe, env)
    trainer = phase_trainer(torch, train_pipe)

    # -- 9-15. the comparison experiment (guided and cfg transfers, Inception,
    # the engine, the trainer's Evaluator), then the moments tool -------------
    phase_guided_check(torch, pipe)
    guided = phase_guided_path(torch, pipe, images, src, tgt, env)
    cfg_path = phase_cfg_path(torch, pipe, images, tgt, env)
    phase_inception(torch)
    comparison, cmp_data = phase_comparison(torch, pipe, env)
    evaluator = phase_evaluator(torch, train_pipe, cmp_data)
    moments = phase_moments()

    # -- 16. the serving engine ---------------------------------------------
    serving = {"serving": phase_serving(torch, pipe, ucfg, sched_cfg, env)}

    # -- 17-22. SD-2.1 class transfer and its serving engine ------------------
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.ops.attention import takes_kernel
    from phendiff_tpu_torch.ops.gn_kernels import gn_route
    from phendiff_tpu_torch.tools.kernel_calls import sd_train_calls, sd_unet_calls, vae_calls

    unet_by_lat = {lat: sd_unet_calls(SDUNetConfig(), lat) for lat in (16, 64)}
    unet32_64 = sd_unet_calls(SDUNetConfig(), 64, torch.float32)
    vae_by_res = {res: vae_calls(AutoencoderKLConfig(), res) for res in (128, 512)}
    # one SD train step's calls at 128 px, without and with remat
    train_calls = {remat: sd_train_calls(SDUNetConfig(), AutoencoderKLConfig(), RES, remat)
                   for remat in (False, True)}
    sd_attn, sd_gn, sd_stream = phase_sd_kernel_check(torch, sfu_rate, {
        **{name: (b, unet_by_lat[res // 8], vae_by_res[res]) for name, (b, res) in SD_RUNS.items()},
        "sd_train_path": (TRAIN_BATCH, train_calls[False]["backward"],
                          train_calls[False]["forward"])})
    t0 = time.perf_counter()
    sd = sd_pipeline(torch.bfloat16, SEED)
    sd32 = sd_pipeline(torch.float32, SEED)
    torch.cuda.synchronize()
    emit({"phase": "sd_init", "seconds": time.perf_counter() - t0,
          "unet_params": sum(p.numel() for p in sd.unet.parameters()),
          "vae_params": sum(p.numel() for p in sd.vae.parameters()),
          "gib_allocated": torch.cuda.memory_allocated() / 2**30})
    phase_sd_forward_check(torch, sd, sd32)
    sd_runs, sd_outputs = {}, {}
    for name in SD_RUNS:
        sd_runs[name], sd_outputs[name] = phase_sd_path(torch, sd, name, env, unet_by_lat,
                                                        vae_by_res)
    sd_guided = phase_sd_guided_check(torch, sd, sd32, unet_by_lat, unet32_64)
    sd_cmp, sd_folder, sd_data = phase_sd_comparison(torch, sd32, env, unet_by_lat, vae_by_res)
    serving.update(phase_sd_serving(torch, sd, sd_outputs, env, unet_by_lat, vae_by_res))
    del sd, sd32, sd_outputs
    torch.cuda.empty_cache()

    # -- 23-25. SD-2.1 fine-tuning and the training CLI -----------------------
    phase_sd_train_check(torch)
    sd_train = phase_sd_train_path(torch, env, train_calls)
    phase_train_cli(torch, sd_folder, sd_data)

    # -- 26. data parallelism ------------------------------------------------
    dp, dp_launches, dp_ref = phase_dp(torch, env, cmp_data)

    # -- 27. the trained-model round trip; 28. tensor parallelism --------------
    reco = phase_reco(torch, env, sfu_rate)
    tp_launches = phase_tp(torch, env, sfu_rate, dp_ref)

    # -- 29. the stage-per-device SD route -------------------------------------
    seg_launches = phase_sd_segmented(torch, env, sd_folder, sd_data)

    # -- 30. DiT-XL/2's forward on the D = 72 kernel and the boundary kernel ----
    adaln = adaln_check(torch)
    dit = phase_dit(torch)

    # -- 31. the ResnetBlock's deferred conv biases and the residual kernel ---
    resnet = phase_resnet_bias(torch)

    # Forward times are per batch-32 UNet forward and backward times per
    # batch-32 train step, each summed over the kernel's calls in it (the
    # GroupNorm backward's 41 calls have the forward's shapes).
    def sd_by_path(name):
        return {**{run: sd_runs[run]["launches"][name] for run in SD_RUNS},
                "sd_guided": sd_guided["bf16"]["launches"][name]
                + sd_guided["f32"]["launches"][name],
                "sd_comparison": sd_cmp["launches"][name],
                "sd_train_path": sd_train["no_remat"]["launches"][name],
                "sd_train_path_remat": sd_train["remat"]["launches"][name],
                "sd_train_path_bf16_moment": sd_train["bf16_moment"]["launches"][name]}

    def serving_by_path(name):
        """Launches at capture times replays, per serving path (serving runs
        no backward)."""
        return {path: rec["launches"].get(name, 0) for path, rec in serving.items()}

    by_path = {
        name: {**sd_by_path(name), **serving_by_path(name)} for name in WGMMA_KEYS}
    by_path.update({
        name: {"transfer": launches.get(name, 0), "train": train["launches"].get(name, 0),
               "trainer": trainer["launches"].get(name, 0), "guided": guided["launches"][name],
               "cfg": cfg_path["launches"][name], "comparison": comparison["launches"][name],
               "evaluator": evaluator["launches"][name], **sd_by_path(name),
               **serving_by_path(name), **{p: n[name] for p, n in dp_launches.items()},
               "reco": reco["launches"][name],
               **{p: n[name] for p, n in tp_launches.items()},
               **{p: n[name] for p, n in seg_launches.items()}}
        for name in KERNEL_NAMES
    })

    def sd_attn_per_forward(which, design=None):
        """Summed over the self-attention calls of one SD UNet forward (or
        its input backward) at each SD run's shapes (with ``design``: over
        the calls that take it)."""
        return {run: {k: sum(n * recs[which][k] for (r, _, _), (n, *recs) in sd_attn.items()
                             if r == run and design in (None, recs[which]["design"]))
                      for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
                for run in (*SD_RUNS, "sd_train_path")}

    def wgmma_calls(which):
        """The SD kernel checks' records (forward 0, backward 1) of calls
        that take the warpgroup design."""
        return [recs[which] for (n, *recs) in sd_attn.values()
                if recs[which]["design"] == "wgmma"]

    def contract_bound(unit):
        return "bytes" if unit == "bytes" else "operations"

    def wgmma_bound_by(which):
        """What bounds the 512 px SD UNet's warpgroup calls (forward 0,
        backward 1) summed: bytes or operations, by the share of the summed
        bound_ms of the calls each one bounds."""
        share = {"bytes": 0.0, "operations": 0.0}
        for (run, _, _), (n, *recs) in sd_attn.items():
            if run == "sd_path_512" and recs[which]["design"] == "wgmma":
                share[contract_bound(recs[which]["bound_by"])] += n * recs[which]["bound_ms"]
        return max(share, key=share.get)

    sd512, sd_train_nr = sd_runs["sd_path_512"]["launches"], sd_train["no_remat"]["launches"]
    if sd512["flash_attn_fwd_wgmma"] == 0 or sd_train_nr["flash_attn_bwd_wgmma"] == 0:
        fail("the warpgroup attention kernels took no call on the SD 512 px transfer or the "
             "SD train step")

    def sd_gn_sum(which):
        """Summed over the cluster GroupNorm calls of one SD UNet forward
        (which 0) or its input backward (1), and of one VAE encode + decode,
        at each SD run's shapes."""
        out = {}
        for run, (_, res) in SD_RUNS.items():
            parts = [("unet", unet_by_lat[res // 8])] + ([("vae", vae_by_res[res])]
                                                          if which == 0 else [])
            for model, calls in parts:
                out[f"{run}_{model}"] = {k: sum(
                    n * sd_gn[(run, s, c, g, act)][which][k]
                    for (s, c, g, act, isz), n in calls["group_norm"].items()
                    if gn_route(s, c, g, isz, which == 1) == "cluster")
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        return out

    def stream_sum(calls, backward, key):
        """Summed over the streamed GroupNorm calls of a recorded model."""
        pre = "bwd_" if backward else ""
        return sum(n * sd_stream[k][pre + key] for k, n in calls["group_norm"].items()
                   if gn_route(*k[:3], k[4], backward) == "stream")

    def sd_train_per_step(kernel):
        """Summed over one SD train step's calls of ``kernel`` (no remat;
        batch 32, 128 px): the UNet forward and the VAE encode for the
        forward kernels, the UNet's backward for the backward kernels."""
        backward = kernel.endswith("_bwd")
        calls = train_calls[False]["backward" if backward else "forward"]
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")
        if kernel.startswith("flash_attn"):
            return {k: sum(n * sd_attn[("sd_train_path", s_q, h)][1 + backward][k]
                           for (s_q, s_kv, h, d, _), n in calls["attention"].items()
                           if takes_kernel(s_q, s_kv, d)) for k in keys}
        return {k: sum(n * sd_gn[("sd_train_path", s, c, g, act)][int(backward)][k]
                       for (s, c, g, act, isz), n in calls["group_norm"].items()
                       if gn_route(s, c, g, isz, backward) == "cluster") for k in keys}

    stream_fwd_calls, stream_bwd_calls = vae_by_res[512], unet32_64
    kernels = [
        {
            "name": "flash_attn_fwd", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "phendiff_tpu/ops/flash_attention.py:77",
            "launches": launches["flash_attn_fwd"], "max_abs_err": attn["max_abs_err"],
            **{k: attn_per_forward * attn[k]
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": contract_bound(attn["bound_by"]),
            "launches_by_path": by_path["flash_attn_fwd"],
            "sd_per_unet_forward": sd_attn_per_forward(0),
            "sd_train_per_step": sd_train_per_step("flash_attn_fwd"),
            "design": DESIGN["flash_attn_fwd"],
        },
        {
            # the D = 64 bf16 calls from WGMMA_MIN_S tokens: ms etc. per 512 px
            # SD UNet forward at batch 8 (its calls of this design); launches
            # on the 512 px SD transfer
            "name": "flash_attn_fwd_wgmma", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "phendiff_tpu/ops/flash_attention.py:77",
            "launches": sd512["flash_attn_fwd_wgmma"],
            "max_abs_err": max(r["max_abs_err"] for r in wgmma_calls(0)),
            **sd_attn_per_forward(0, "wgmma")["sd_path_512"], "bound_by": wgmma_bound_by(0),
            "launches_by_path": by_path["flash_attn_fwd_wgmma"],
            "sd_per_unet_forward": sd_attn_per_forward(0, "wgmma"),
            "design": DESIGN["flash_attn_fwd_wgmma"],
        },
        {
            # DiT-XL/2's heads of 72, forward only: ms etc. per DiT-XL/2
            # forward at batch 32, 512 px (its 28 calls at B 32, S 1024,
            # H 16, each as phase 3's check at that shape); launches on
            # phase 30's forward
            "name": "flash_attn_fwd_wgmma_d72", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "phendiff_tpu/ops/flash_attention.py:77",
            "launches": dit["launches"]["wgmma"], "max_abs_err": dit_attn["max_abs_err"],
            **{k: dit["attention_calls"] * dit_attn[k]
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": contract_bound(dit_attn["bound_by"]),
            "launches_by_path": {"dit_forward_b32": dit["launches"]["wgmma"]},
            "design": DESIGN["flash_attn_fwd_wgmma_d72"],
        },
        {
            # DiT's sub-layer boundary, no TPU counterpart: ms etc. per call at
            # (32, 1024, 1152) bf16 with y and x' written (device time in a
            # CUDA graph); launches on phase 30's forward
            "name": "adaln_norm", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/adaln_norm.cu",
            "replaces": "none (the JAX package has no DiT)",
            "launches": dit["boundary"]["launches"],
            **{k: adaln[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                     "pct_of_bound")},
            "bound_by": "bytes",
            "launches_by_path": {"dit_forward_b32": dit["boundary"]["launches"]},
            "design": DESIGN["adaln_norm"],
        },
        {
            # a ResnetBlock's residual with its convs' biases, no TPU counterpart:
            # ms etc. per call at (128, 128, 128, 64) bf16 with one bias (device
            # time in a CUDA graph); launches on phase 3's batch-32 forward
            "name": "residual_bias", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/residual_bias.cu",
            "replaces": "none (ATen's conv bias adds and the residual add)",
            "launches": residual_per_forward["residual_bias"],
            **{k: resnet["ddim"]["one_bias"][k]
               for k in ("ms", "plain_ms", "library_ms", "pct_of_bound")},
            "bound_ms": resnet["ddim"]["bound_ms"], "bound_by": "bytes",
            "two_biases": resnet["ddim"]["two_biases"], "sd_256x16x16x320": resnet["sd"],
            "launches_by_path": {"ddim_forward_b32": residual_per_forward["residual_bias"]},
            "design": DESIGN["residual_bias"],
        },
        {
            "name": "flash_attn_bwd", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "phendiff_tpu/ops/flash_attention.py:155",
            "launches": train["launches"]["flash_attn_bwd"], "max_abs_err": bwd["max_abs_err"],
            **{k: 6 * bwd[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": contract_bound(bwd["bound_by"]),
            "launches_by_path": by_path["flash_attn_bwd"],
            "sd_per_unet_backward": sd_attn_per_forward(1),
            "sd_train_per_step": sd_train_per_step("flash_attn_bwd"),
            "design": DESIGN["flash_attn_bwd"],
        },
        {
            # ms etc. per 512 px SD UNet input backward at batch 8 (its calls of
            # this design); launches on the SD train step (10 steps, 128 px)
            "name": "flash_attn_bwd_wgmma", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "phendiff_tpu/ops/flash_attention.py:155",
            "launches": sd_train_nr["flash_attn_bwd_wgmma"],
            "max_abs_err": max(r["max_abs_err"] for r in wgmma_calls(1)),
            **sd_attn_per_forward(1, "wgmma")["sd_path_512"], "bound_by": wgmma_bound_by(1),
            "design_floor_ms": sum(n * recs[1]["design_floor_ms"]
                                   for (r, _, _), (n, *recs) in sd_attn.items()
                                   if r == "sd_path_512" and recs[1]["design"] == "wgmma"),
            "launches_by_path": by_path["flash_attn_bwd_wgmma"],
            "sd_per_unet_backward": sd_attn_per_forward(1, "wgmma"),
            "design": DESIGN["flash_attn_bwd_wgmma"],
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
            "launches_by_path": by_path["group_norm_silu"], "sd_per_call_group": sd_gn_sum(0),
            "sd_train_per_step": sd_train_per_step("group_norm_silu"),
            "design": DESIGN["group_norm_silu"],
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
            "sd_per_call_group": sd_gn_sum(1),
            "sd_train_per_step": sd_train_per_step("group_norm_silu_bwd"),
            "design": DESIGN["group_norm_silu_bwd"],
        },
        {
            # ms etc. per 512 px VAE encode + decode at batch 8 (its 11 streamed calls)
            "name": "group_norm_silu_stream", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/group_norm_silu.cu",
            "replaces": "phendiff_tpu/ops/gn_kernels.py:129",
            "launches": sd_runs["sd_path_512"]["launches"]["group_norm_silu_stream"],
            "max_abs_err": max(r["max_abs_err"] for r in sd_stream.values()),
            **{k: stream_sum(stream_fwd_calls, False, k)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes",
            "launches_by_path": {**{run: sd_runs[run]["launches"]["group_norm_silu_stream"]
                                    for run in SD_RUNS},
                                 **serving_by_path("group_norm_silu_stream")},
            "design": DESIGN["group_norm_silu_stream"],
        },
        {
            # ms etc. per f32 guided step at latent 64, batch 1 (its streamed calls)
            "name": "group_norm_silu_stream_bwd", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/group_norm_silu.cu",
            "replaces": "phendiff_tpu/ops/gn_kernels.py:98",
            "launches": sd_guided["f32"]["launches"]["group_norm_silu_stream_bwd"],
            "max_abs_err": max(r["bwd_max_abs_err"] for r in sd_stream.values()),
            **{k: stream_sum(stream_bwd_calls, True, k)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes",
            "launches_by_path": {"sd_guided_f32_512px": sd_guided["f32"]["launches"][
                "group_norm_silu_stream_bwd"]},
            "design": DESIGN["group_norm_silu_stream_bwd"],
        },
        {
            "name": "channel_moments", "route": "cuda",
            "source": "phendiff_tpu_torch/csrc/group_norm_silu.cu",
            "replaces": "tools/bench_gn_moments.py:129",
            "launches": moments["launches"], "max_abs_err": moments["max_abs_err"],
            **{k: moments[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                                       "library_device_ms", "bound_by")},
            "launches_by_path": {"moments_tool": moments["launches"]},
        },
    ]
    emit({"kernels": kernels, "seconds_total": time.perf_counter() - t_start})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(sys.argv[2:])
    else:
        main()
