"""Per-channel GroupNorm moments of a level-0 map on the card: the kernel,
its plain version and a library yardstick, each timed by CUDA events, and
the kernel's device time.

Counterpart of ``tools/bench_gn_moments.py`` (its ``m_pallas``): f32
sum x and sum x^2 per (sample, channel) of a [32, 8192, 128] bf16 map
(67 MB; the JAX tool's lane-packed level-0 tensor).  Prints one JSON line:
the kernel's ms (``ops.gn_kernels.channel_moments``, CUDA events around
back-to-back Python calls, host time included) and ``device_ms`` (the
calls captured in one CUDA graph, no host time), the plain version's
ms (``channel_moments_plain``, tiles of S accumulated in f32 as the TPU
kernel does), the library's ms and device ms (``x.sum(1, dtype=f32)`` and
``linalg.vector_norm(x, dim=1, dtype=f32)`` squared: two reductions, each
reading the bf16 map once and accumulating in f32 with no f32 copy of it;
never called by the port) with each reduction's device ms, the device ms
of the older yardstick that materialises f32 copies (``x.float().sum(1)``
and ``x.float().square().sum(1)``), the bound (one read of x at
3.35 TB/s), and the errors against the plain version and a float64
reference (largest error over largest sum).

    python -m phendiff_tpu_torch.tools.bench_gn_moments [--batch 32 --rows 8192 --channels 128]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from phendiff_tpu_torch.core.device import resolve_device
from phendiff_tpu_torch.obs.profiling import events_ms, graph_ms
from phendiff_tpu_torch.ops.gn_kernels import channel_moments, channel_moments_plain

SHAPE = (32, 8192, 128)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


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
    ms = events_ms(lambda: channel_moments(x), iters)
    device_ms = graph_ms(lambda: channel_moments(x), iters)
    plain_ms = events_ms(lambda: channel_moments_plain(x), iters)
    f32 = torch.float32
    lib_sum = lambda: x.sum(1, dtype=f32)  # noqa: E731
    lib_sumsq = lambda: torch.linalg.vector_norm(x, dim=1, dtype=f32).square()  # noqa: E731
    library = lambda: (lib_sum(), lib_sumsq())  # noqa: E731
    library_ms, library_device_ms = events_ms(library, iters), graph_ms(library, iters)
    library_err = max(float((a - p).abs().max() / p.abs().max())
                      for a, p in zip(library(), plain))
    materialising = lambda: (x.float().sum(1), x.float().square().sum(1))  # noqa: E731
    n_bytes = b * s * c * x.element_size() + 2 * b * c * 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return {
        "tool": "bench_gn_moments", "shape": list(shape), "dtype": "bfloat16",
        "max_abs_err": max_abs, "max_rel_err_plain": rel_plain, "max_rel_err_f64": rel_f64,
        "deterministic": all(torch.equal(a, b2) for a, b2 in zip(got, again)),
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_device_ms": library_device_ms,
        "library_sum_device_ms": graph_ms(lib_sum, iters),
        "library_sumsq_device_ms": graph_ms(lib_sumsq, iters),
        "library_max_rel_err_plain": library_err,
        "materialising_device_ms": graph_ms(materialising, iters),
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
