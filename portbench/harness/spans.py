"""Readers of the program's own spans: the port's span recorder
(``phendiff_tpu_torch.obs.profiling.recorder()``) holds the spans of the
traced stretch, since the port records spans while a profiler runs and
keeps them after it stops.  Each reader returns None where the port has
no recorder or the recorder holds no such span, and the metric is left
out of the line.

Host ms are the spans' host time (the profiler slows the host, so they
read high against an untraced run).  Latency is the time from the host
opening a unit span to the device finishing the work queued by its close
(the port's ``Recorder.latency_ms``), in ms: a faster host or a faster
device both shorten it, and less the unit's host ms it is how far the
host ran ahead of the device.
"""

from __future__ import annotations

import statistics
from typing import Optional


def _recorder():
    try:
        from phendiff_tpu_torch.obs import profiling
    except ImportError:
        return None
    get = getattr(profiling, "recorder", None)
    return get() if callable(get) else None


def host_ms_per_unit(names, unit: str) -> Optional[float]:
    """Host ms inside the spans ``names`` over the number of ``unit`` spans."""
    rec = _recorder()
    if rec is None:
        return None
    totals = rec.totals()
    count = totals[unit].count if unit in totals else 0
    if not count or not any(n in totals for n in names):
        return None
    return sum(totals[n].host_ns for n in names if n in totals) / count / 1e6


def median_latency_ms(name: str) -> Optional[float]:
    rec = _recorder()
    read = getattr(rec, "latency_ms", None)
    if read is None:
        return None
    latencies = read(name)
    return statistics.median(latencies) if latencies else None


def denoise_host_ms(r: dict) -> Optional[float]:
    return host_ms_per_unit(("transfer/denoise",), "transfer/denoise")


def step_host_ms(r: dict) -> Optional[float]:
    return host_ms_per_unit(("train/step",), "train/step")


def optimizer_host_ms(r: dict) -> Optional[float]:
    return host_ms_per_unit(("train/optimizer", "train/ema"), "train/step")


def denoise_latency_ms(r: dict) -> Optional[float]:
    return median_latency_ms("transfer/denoise")


def step_latency_ms(r: dict) -> Optional[float]:
    return median_latency_ms("train/step")
