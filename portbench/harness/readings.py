"""The arithmetic the per-layer readers share.  ``r`` is what a runner
hands them from a traced run: the window's seconds and model FLOPs, the
traced stretch (``trace.Stretch``) and the least seconds of the stretch's
attention and GroupNorm calls (``work``).  A reader with nothing to read
returns None, and the metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from portbench.harness import peaks, trace


def mfu(r: dict) -> Optional[float]:
    """Model FLOPs of the window's work / its seconds / the bf16 peak, %."""
    if not r.get("flops") or not r.get("window_s"):
        return None
    return 100.0 * r["flops"] / r["window_s"] / peaks.BF16_FLOPS


def samples_per_s(r: dict) -> Optional[float]:
    """Samples of all the window's steps over all its seconds."""
    if not r.get("samples") or not r.get("window_s"):
        return None
    return r["samples"] / r["window_s"]


def idle_pct(r: dict) -> Optional[float]:
    s = r["stretch"]
    return 100.0 * s.idle_s / s.window_s if s.window_s > 0 else None


def launches_per_unit(r: dict) -> Optional[float]:
    s = r["stretch"]
    return s.launches / s.units if s.units else None


def roofline(r: dict, least_key: str, categories) -> Optional[float]:
    """Least seconds of the layer's calls / the device seconds of its
    kernel categories, %."""
    spent = r["stretch"].seconds(categories)
    least = r.get(least_key, 0.0)
    if spent <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / spent


def attention_roofline(r: dict) -> Optional[float]:
    return roofline(r, "attention_least_s", trace.ATTENTION)


def group_norm_roofline(r: dict) -> Optional[float]:
    return roofline(r, "group_norm_least_s", trace.GROUP_NORM)


def optimizer_ms_per_step(r: dict) -> Optional[float]:
    s = r["stretch"]
    spent = s.seconds(trace.OPTIMIZER)
    return 1e3 * spent / s.units if s.units and spent > 0 else None
