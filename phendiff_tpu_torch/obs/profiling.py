"""Profiling hooks: spans held in memory on the profiler's clock, profiler
trace capture, a timing barrier, device timers and whole-run step rates.

Counterpart of ``phendiff_tpu/obs/profiling.py``:

    with trace_if("/tmp/traces", step, capture_steps=(10, 12)):
        state, metrics = step_fn(...)

Spans.  ``annotate(name, device=None)`` opens a named span at a layer
boundary of the port (``train/step`` and its phases, each
``transfer/denoise`` call, ``engine/<op>``).  A span is off unless a
``torch.profiler`` is recording or a ``recording()`` block is open, and
off it costs a flag check and the profiler-enabled check.  On, it

* shows in the profiler's trace as a ``record_function`` range (while a
  profiler records), so in the file ``trace_if`` writes;
* leaves a ``Span`` (name, host start and end) in ``recorder()``: a ring
  of the last ``RING`` spans and totals per name (count, host ns).

Host times are epoch nanoseconds (``time.time_ns()``), the clock the
profiler stamps its host events with: a span agrees with its profiler
event to microseconds, so the spans can be laid over a device trace.  A
recorder switched on by a profiler keeps its spans after the profiler
stops, until ``recorder().clear()``.

Latency.  A span given a CUDA ``device`` (a unit of work: a train step, a
denoiser call) records one CUDA event on the current stream as it closes,
while a profiler records and the stream captures no graph.
``Recorder.latency_ms`` resolves the events when read, against one
calibration event recorded on the idle device: the time from the host
opening the span to the device finishing the work queued by its close.
Less the span's host time, that is the host's lead: near 0 the device
waited on the host; large, the host ran ahead and the device set the
pace.

``force_sync`` waits for the devices holding the given tensors.
``events_ms`` and ``graph_ms`` time a function on the card: CUDA events
around back-to-back Python calls (host time included where it exceeds the
device's), and device time alone, the calls captured in one CUDA graph and
replayed.  ``StepTimer`` gives whole-run rates from the train steps'
spans.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

# spans the ring keeps
RING = 1 << 16

_profiler_enabled = torch._C._autograd._profiler_enabled
_explicit = 0  # open recording() blocks
_explicit_lock = threading.Lock()


class Totals(NamedTuple):
    """A span name's totals: closed spans and their host ns."""

    count: int
    host_ns: int


class Span:
    """One span: opened by ``annotate`` while recording, kept by the
    recorder once closed."""

    __slots__ = ("name", "start_ns", "end_ns", "_device", "_event", "_done_ns", "_rf")

    def __init__(self, name: str, device=None):
        self.name = name
        self._device = device if device is not None and torch.device(device).type == "cuda" \
            else None
        self.start_ns = self.end_ns = 0
        self._event = self._done_ns = self._rf = None

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def seconds(self) -> float:
        return self.host_ns / 1e9

    def __enter__(self) -> "Span":
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        # the profiler stamps a range's start as it opens and its end as
        # it closes: the span's times are taken beside those stamps
        profiled = self._rf is not None
        if profiled:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.time_ns()
        if profiled and self._device is not None \
                and not torch.cuda.is_current_stream_capturing():
            self._event = torch.cuda.Event(enable_timing=True)
            self._event.record(torch.cuda.current_stream(self._device))
        _RECORDER.add(self)


class _Off:
    """The span of ``annotate`` while nothing records: no object made."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def annotate(name: str, device=None):
    """A named span (a context manager yielding its ``Span``, or None while
    off).  ``device``: where its work queues; on a CUDA device the span
    records its latency under a profiler."""
    if not (_explicit or _profiler_enabled()):
        return _OFF
    return Span(name, device)


@contextlib.contextmanager
def recording():
    """Spans on for the block, with or without a profiler; yields the
    recorder."""
    global _explicit
    with _explicit_lock:
        _explicit += 1
    try:
        yield _RECORDER
    finally:
        with _explicit_lock:
            _explicit -= 1


class Recorder:
    """The closed spans: a ring of the last ``RING`` and totals per name
    since the last ``clear``."""

    def __init__(self):
        self._ring: collections.deque = collections.deque(maxlen=RING)
        self._totals: Dict[str, List[int]] = {}
        self._last: Dict[str, Span] = {}
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            self._last[span.name] = span
            t = self._totals.get(span.name)
            if t is None:
                t = self._totals[span.name] = [0, 0]
            t[0] += 1
            t[1] += span.host_ns

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._totals.clear()
            self._last.clear()

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """The ring's spans in the order they closed, of ``name`` alone if
        given."""
        with self._lock:
            return [s for s in self._ring if name is None or s.name == name]

    def last(self, name: str) -> Optional[Span]:
        """The newest closed span of ``name``."""
        with self._lock:
            return self._last.get(name)

    def totals(self) -> Dict[str, Totals]:
        with self._lock:
            return {k: Totals(*v) for k, v in self._totals.items()}

    def since(self, before: Dict[str, Totals]) -> Dict[str, Totals]:
        """The totals added since ``before`` (a ``totals()``), of the names
        that closed a span since."""
        out = {}
        for k, t in self.totals().items():
            b = before.get(k, Totals(0, 0))
            if t.count > b.count:
                out[k] = Totals(t.count - b.count, t.host_ns - b.host_ns)
        return out

    def latency_ms(self, name: str) -> List[float]:
        """The latency of each kept span of ``name`` that recorded a CUDA
        event, in ms; resolving them waits for the devices."""
        spans = [s for s in self.spans(name) if s._event is not None or s._done_ns is not None]
        by_device = collections.defaultdict(list)
        for s in spans:
            if s._event is not None:
                by_device[torch.device(s._device)].append(s)
        for device, todo in by_device.items():
            _resolve(device, todo)
        return [(s._done_ns - s.start_ns) / 1e6 for s in spans]


def _resolve(device: torch.device, spans: List[Span]) -> None:
    """When the device finished each span's queued work, on the host clock:
    its event's device time, placed by a calibration event recorded on the
    idle device."""
    torch.cuda.synchronize(device)
    cal = torch.cuda.Event(enable_timing=True)
    t0 = time.time_ns()
    cal.record(torch.cuda.current_stream(device))
    t1 = time.time_ns()
    cal.synchronize()
    at = (t0 + t1) // 2
    for s in spans:
        s._done_ns = at - int(s._event.elapsed_time(cal) * 1e6)
        s._event = None


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The spans recorded so far."""
    return _RECORDER


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str], step: int, capture_steps=(10,)):
    """Record a profiler trace of the block into ``trace_dir`` (one
    ``*.pt.trace.json`` per capture) when ``step`` is a capture step; the
    block's spans are ranges in it."""
    if not trace_dir or step not in capture_steps:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


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
    """Whole-run step rates: the steps since the first tick over the
    seconds since it.  The Trainers tick with each step's ``train/step``
    span (the time it closed); a bare tick reads ``time.perf_counter()``."""

    def __init__(self):
        self._first: Optional[float] = None
        self._last: Optional[float] = None
        self._steps = 0

    def tick(self, span: Optional[Span] = None) -> None:
        now = time.perf_counter() if span is None else span.end_ns / 1e9
        if self._first is None:
            self._first = now
        else:
            self._steps += 1
        self._last = now

    def stats(self, batch_size: int = 1) -> dict:
        if not self._steps:
            return {}
        mean = (self._last - self._first) / self._steps
        return {
            "perf/step_time_s": mean,
            "perf/steps_per_sec": 1.0 / mean,
            "perf/samples_per_sec": batch_size / mean,
        }
