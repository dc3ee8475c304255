"""A traced stretch: ``torch.profiler`` over a few whole batches or steps at
the end of a run, reduced to device seconds by kernel category, launches,
the device's busy time, and idle time by what the host was doing.

The category table is the one of ``phendiff_tpu_torch/obs/forward_profile
.py`` (first match wins), extended with the library's own attention and
GroupNorm kernels, so that a layer's share reads the same work whatever
implements it.  The harness's spans (``record_function``) name what the
host was doing: ``ddib.call``, ``vae.encode``, ``vae.decode``,
``train.step``, and ``stretch`` around the whole of it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

CATEGORIES = (
    ("flash_attn_fwd", ("flash_fwd_mma_kernel", "flash_fwd_wgmma_kernel", "flash_fwd_kernel")),
    ("flash_attn_bwd", ("flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel",
                        "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
                        "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")),
    ("library_attention", ("fmha", "flash", "efficient_attention", "sdpa", "attention")),
    ("group_norm_silu", ("gn_fwd_cluster",)),
    ("group_norm_silu_bwd", ("gn_bwd_cluster",)),
    ("group_norm_silu_stream", ("stream_apply", "stream_stats_combine")),
    ("group_norm_silu_stream_bwd", ("stream_bwd_",)),
    ("channel_moments", ("gn_stats", "moments_combine")),
    ("library_group_norm", ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams",
                            "backwardfusedparams", "computeinternalgradients", "welford")),
    ("conv", ("conv", "xmma", "implicit", "cudnn", "nhwc", "fprop", "dgrad", "wgrad",
              "winograd")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_")),
    ("optimizer", ("multi_tensor_apply", "foreach")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "cat", "copy", "fill",
                     "reduce", "index")),
)

# the categories each layer's device time is summed over
ATTENTION = ("flash_attn_fwd", "flash_attn_bwd", "library_attention")
GROUP_NORM = ("group_norm_silu", "group_norm_silu_bwd", "group_norm_silu_stream",
              "group_norm_silu_stream_bwd", "library_group_norm")
OPTIMIZER = ("optimizer",)

SPANS = ("ddib.call", "vae.encode", "vae.decode", "train.step")


def categorize(name: str) -> str:
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "memory"
    for cat, frags in CATEGORIES:
        if any(f in low for f in frags):
            return cat
    return "other"


@dataclasses.dataclass
class Stretch:
    """What one traced stretch shows; times in seconds."""

    window_s: float  # host span of the stretch
    busy_s: float  # union of the device's operation intervals
    launches: int  # kernels (copies and fills not counted)
    by_category: Dict[str, float]
    idle_by_span: Dict[str, float]
    units: float = 0.0  # denoiser calls or train steps in the stretch

    def seconds(self, categories) -> float:
        return sum(self.by_category.get(c, 0.0) for c in categories)

    @property
    def idle_s(self) -> float:
        return max(self.window_s - self.busy_s, 0.0)


def _ns(evt, what: str) -> int:
    fn = getattr(evt, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(evt, f"{what}_us")() * 1000)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events, spans=SPANS) -> Stretch:
    """A ``Stretch`` from the profiler's raw events: device events by
    category, host spans for the window and the idle attribution."""
    dev, host = [], collections.defaultdict(list)
    for e in events:
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a span's range on the device's timeline is no operation
            if not annotation and e.name() not in spans and e.name() != "stretch":
                dev.append((start, end, e.name()))
        elif e.name() in spans or e.name() == "stretch":
            host[e.name()].append((start, end))
    if not host.get("stretch"):
        raise RuntimeError("the trace holds no 'stretch' span")
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    w0, w1 = host["stretch"][0]
    by_cat: Dict[str, float] = collections.defaultdict(float)
    launches = 0
    for a, b, name in dev:
        cat = categorize(name)
        by_cat[cat] += (b - a) / 1e9
        launches += cat != "memory"
    busy = [(max(a, w0), min(b, w1)) for a, b, _ in dev if b > w0 and a < w1]
    merged = _union(busy)
    idle: Dict[str, float] = collections.defaultdict(float)
    at = w0
    ordered = {n: sorted(v) for n, v in host.items() if n != "stretch"}
    for a, b in merged + [(w1, w1)]:
        if a > at:
            idle[_span_at(ordered, at)] += (a - at) / 1e9
        at = max(at, b)
    return Stretch(window_s=(w1 - w0) / 1e9, busy_s=sum(b - a for a, b in merged) / 1e9,
                   launches=launches, by_category=dict(by_cat), idle_by_span=dict(idle))


def _span_at(spans: Dict[str, List[Tuple[int, int]]], t: int) -> str:
    """The innermost (shortest) span holding host time ``t``, or 'harness'."""
    best, length = "harness", None
    for name, intervals in spans.items():
        for a, b in intervals:
            if a <= t < b and (length is None or b - a < length):
                best, length = name, b - a
    return best


def traced(fn: Callable[[], float]) -> Stretch:
    """Run ``fn`` (which returns the denoiser calls or steps it ran, and
    ends in a device synchronize) under the profiler, inside the
    'stretch' span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("stretch"):
            units = fn()
            torch.cuda.synchronize()
    stretch = reduce_events(prof.profiler.kineto_results.events())
    stretch.units = float(units)
    return stretch


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span the traced stretch attributes idle time to; nothing
    when ``on`` is False (the timed window runs without spans)."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def breakdown(stretch: Stretch) -> dict:
    """The result line's ``breakdown``: the device categories that took most
    time and the idle time by host span, ten of each at most."""
    top = sorted(stretch.by_category.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(stretch.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
