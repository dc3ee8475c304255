"""Per-channel GroupNorm moments of a level-0 map on the card: the kernel,
its plain version and a library yardstick, each timed by CUDA events.

Counterpart of ``tools/bench_gn_moments.py`` (its ``m_pallas``): f32
sum x and sum x^2 per (sample, channel) of a [32, 8192, 128] bf16 map
(67 MB; the JAX tool's lane-packed level-0 tensor).  Prints one JSON line:
the kernel's ms (``ops.gn_kernels.channel_moments``), the plain version's
ms (``channel_moments_plain``, tiles of S accumulated in f32 as the TPU
kernel does), the yardstick's ms (``x.float().sum(1)`` and
``x.float().square().sum(1)``, never called by the port), the bound
(one read of x at 3.35 TB/s), and the errors against the plain version
and a float64 reference (largest error over largest sum).

    python -m phendiff_tpu_torch.tools.bench_gn_moments [--batch 32 --rows 8192 --channels 128]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from phendiff_tpu_torch.core.device import resolve_device
from phendiff_tpu_torch.ops.gn_kernels import channel_moments, channel_moments_plain

SHAPE = (32, 8192, 128)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(shape=SHAPE, seed: int = 0, iters: int = 20) -> dict:
    dev = resolve_device("cuda")
    b, s, c = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    got = channel_moments(x)
    again = channel_moments(x)
    plain = channel_moments_plain(x)
    ref = (x.double().sum(1), x.double().square().sum(1))
    torch.cuda.synchronize()
    max_abs = max(float((a - p).abs().max()) for a, p in zip(got, plain))
    rel_plain = max(float((a - p).abs().max() / p.abs().max()) for a, p in zip(got, plain))
    rel_f64 = max(float((a.double() - r).abs().max() / r.abs().max()) for a, r in zip(got, ref))
    ms = cuda_ms(lambda: channel_moments(x), iters)
    plain_ms = cuda_ms(lambda: channel_moments_plain(x), iters)
    library_ms = cuda_ms(lambda: (x.float().sum(1), x.float().square().sum(1)), iters)
    n_bytes = b * s * c * x.element_size() + 2 * b * c * 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return {
        "tool": "bench_gn_moments", "shape": list(shape), "dtype": "bfloat16",
        "max_abs_err": max_abs, "max_rel_err_plain": rel_plain, "max_rel_err_f64": rel_f64,
        "deterministic": all(torch.equal(a, b2) for a, b2 in zip(got, again)),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bytes": n_bytes, "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=SHAPE[0])
    ap.add_argument("--rows", type=int, default=SHAPE[1])
    ap.add_argument("--channels", type=int, default=SHAPE[2])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    print(json.dumps(measure((args.batch, args.rows, args.channels), iters=args.iters)))


if __name__ == "__main__":
    main()
