"""The bf16 attention kernels' designs at SD-2.1's self-attention shapes on
the card: each design's forward and backward device time beside SDPA's.

For every (batch, S, heads) of SD-2.1's UNet at 512 px, batch 8; 128 px,
batch 64; and the 128 px fine-tune step, batch 32 (heads of 64; levels of
S = (latent / 2**i)**2 with 5, 10, 20, 20 heads, 5 calls a level and 1 in
the mid block), this times ``flash_attention``'s forward and
``flash_attention_bwd`` once with each design forced (``mma_sync`` and
``wgmma``, passed to the kernels' private launchers; the port's own route
is ``attention_design``), in the order a, b, b, a, each as device
time of 10 calls captured in a CUDA graph; and SDPA's forward (a graph) and
backward (CUDA events around ``torch.autograd.grad``, as ``chip_smoke.py``
times its library calls).  q, k, v are column slices of one fused qkv, as
the UNet hands them over.  Prints one JSON line a shape, then one a run
with the sums over a UNet forward (input backward) for each design, the
route's choice and SDPA, then the ``nvidia-smi`` name and power limit.

    python -m phendiff_tpu_torch.tools.attention_designs

``--dit`` times the forward alone at DiT-XL/2's shape instead (batch 32 at
512 px: 16 heads of 72 over 1024 tokens; q, k, v views of one fused
[B, S, 3, H, 72] qkv): the warpgroup kernel (the one bf16 design at
D = 72) and SDPA's forward (which rounds D = 72 up to its own kernel's
head dim), a, b, b, a, each as device time of 10 calls in a CUDA graph,
with the kernel's worst gap to ``attention_plain`` and each one's share of
the roofline at D = 72.

    python -m phendiff_tpu_torch.tools.attention_designs --dit
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from phendiff_tpu_torch.obs.profiling import events_ms, graph_ms
from phendiff_tpu_torch.ops import _build
from phendiff_tpu_torch.ops import flash_attention as fa

# the bf16 tensor cores' dense peak, FLOP/s (H100 SXM data sheet)
BF16_PEAK = 989e12

HEADS = (5, 10, 20, 20)  # SD-2.1's heads of 64 by level
CALLS = (5, 5, 5, 1)  # self-attention calls by level in one UNet forward
RUNS = {"sd_512px_b8": (8, 64), "sd_128px_b64": (64, 16), "sd_train_128px_b32": (32, 16)}
DESIGNS = ("mma_sync", "wgmma")
ITERS = 10  # calls a CUDA graph


def time_shape(b: int, s: int, h: int) -> dict:
    """ms of each design's forward and backward, and SDPA's."""
    d, dt = 64, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(s + h)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dt)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
    scale = d**-0.5
    rec = {"batch": b, "S": s, "heads": h, "route": fa.attention_design(s, d, dt)}
    times: dict = {}
    for design in DESIGNS + DESIGNS[::-1]:
        o, lse = fa._launch(q, k, v, scale, with_lse=True, design=design)
        times.setdefault(design, {"fwd": [], "bwd": []})
        times[design]["fwd"].append(graph_ms(
            lambda: fa._launch(q, k, v, scale, design=design), ITERS))
        times[design]["bwd"].append(graph_ms(
            lambda: fa._launch_bwd(q, k, v, o, lse, g, scale, design=design), ITERS))
    rec.update({f"{key}_{p}_ms": min(t[p]) for key, t in times.items() for p in ("fwd", "bwd")})
    rec["runs"] = times
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec["sdpa_fwd_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), ITERS)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)
    rec["sdpa_bwd_ms"] = events_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    return rec


def time_dit(b: int = 32, s: int = 1024, h: int = 16, d: int = 72) -> dict:
    """ms of the warpgroup forward at DiT-XL/2's shape, and SDPA's."""
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(s + h)
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(dt)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = d**-0.5
    rec = {"batch": b, "S": s, "heads": h, "D": d, "route": fa.attention_design(s, d, dt)}
    got = fa._launch(q, k, v, scale, design="wgmma").float()
    rec["wgmma_max_abs_gap"] = float((got - fa.attention_plain(q, k, v).float()).abs().max())
    del got
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    calls = {"wgmma": lambda: fa._launch(q, k, v, scale, design="wgmma"),
             "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt)}
    times: dict = {"wgmma": [], "sdpa": []}
    for key in ("wgmma", "sdpa", "sdpa", "wgmma"):
        times[key].append(graph_ms(calls[key], ITERS))
    flops = 4.0 * b * h * s * s * d
    for key, t in times.items():
        rec[f"{key}_fwd_ms"] = min(t)
        rec[f"{key}_roofline_pct"] = 100.0 * flops / BF16_PEAK / (min(t) / 1e3)
    rec["runs"] = times
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dit", action="store_true", help="DiT-XL/2's D = 72 forward alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_designs needs an NVIDIA GPU")
    _build.build(["flash_attn_fwd", "flash_attn_bwd"])
    if args.dit:
        print(json.dumps(time_dit()), flush=True)
    for run, (b, latent) in ({} if args.dit else RUNS).items():
        recs = []
        for level, (h, n) in enumerate(zip(HEADS, CALLS)):
            rec = time_shape(b, (latent >> level) ** 2, h)
            rec.update({"run": run, "calls_per_unet_forward": n})
            print(json.dumps(rec), flush=True)
            recs.append(rec)
        keys = [k[:-7] for k in recs[0] if k.endswith("_fwd_ms")]
        sums = {f"{key}_{p}_ms": sum(r["calls_per_unet_forward"] * r[f"{key}_{p}_ms"]
                                    for r in recs) for key in keys for p in ("fwd", "bwd")}
        for p in ("fwd", "bwd"):
            sums[f"route_{p}_ms"] = sum(r["calls_per_unet_forward"] * r[f"{r['route']}_{p}_ms"]
                                        for r in recs)
        print(json.dumps({"run": run, "per_unet_forward": sums}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
