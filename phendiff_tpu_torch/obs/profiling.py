"""Per-step wall-clock statistics for the training loop.

Counterpart of ``StepTimer`` in ``phendiff_tpu/obs/profiling.py``.  The
ticks are host times of step dispatch: the loop synchronises with the card
only when it reads metrics, so a mean over many steps is the step time.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional


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
