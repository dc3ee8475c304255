"""Median latency of the traced train steps, in ms: from the host opening
a ``train/step`` span to the device finishing the work queued by its
close."""
from portbench.harness.spans import step_latency_ms as read  # noqa: F401
