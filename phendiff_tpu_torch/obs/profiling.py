"""Profiling hooks: profiler trace capture, named spans, a timing barrier
and per-step wall-clock statistics.

Counterpart of ``phendiff_tpu/obs/profiling.py``:

    with trace_if("/tmp/traces", step, capture_steps=(10, 12)):
        state, metrics = step_fn(...)

``trace_if`` records ``torch.profiler`` traces (host, and the card's
kernels where CUDA is present) in the Chrome/TensorBoard format;
``annotate`` opens a named span that shows in those traces and, on the
card, as an NVTX range; ``force_sync`` waits for the devices holding
the given tensors.  ``StepTimer``'s ticks are host times of step
dispatch: the training loop synchronises with the card only when it reads
metrics, so a mean over many steps is the step time.  ``events_ms`` and
``graph_ms`` time a function on the card: CUDA events around back-to-back
Python calls (host time included where it exceeds the device's), and
device time alone, the calls captured in one CUDA graph and replayed.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional

import torch


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str], step: int, capture_steps=(10,)):
    """Record a profiler trace of the block into ``trace_dir`` (one
    ``*.pt.trace.json`` per capture) when ``step`` is a capture step."""
    if not trace_dir or step not in capture_steps:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """A named span: a ``record_function`` range in profiler traces and,
    where CUDA is present, an NVTX range."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def force_sync(*tensors) -> None:
    """Execution barrier for timing code: wait until every CUDA device
    holding one of the tensors (nested in lists, tuples and dicts) has
    finished its queued work.  CPU tensors need no barrier."""
    devices = {t.device for t in _tensors(tensors) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card over ``iters`` back-to-back calls,
    by CUDA events."""
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


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn`` with no host time: ``iters`` calls
    captured in one CUDA graph (after 3 warm-up calls on a side stream),
    replayed ``replays`` times between CUDA events."""
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


class StepTimer:
    """Rolling wall-clock stats over the last ``window`` steps."""

    def __init__(self, window: int = 50):
        self._times: deque = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def stats(self, batch_size: int = 1) -> dict:
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        return {
            "perf/step_time_s": mean,
            "perf/steps_per_sec": 1.0 / mean,
            "perf/samples_per_sec": batch_size / mean,
        }
