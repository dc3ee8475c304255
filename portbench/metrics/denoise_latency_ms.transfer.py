"""Median latency of the traced batch's denoiser calls, in ms: from the
host opening a ``transfer/denoise`` span to the device finishing the work
queued by its close."""
from portbench.harness.spans import denoise_latency_ms as read  # noqa: F401
