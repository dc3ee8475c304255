"""Host ms a denoiser call in the traced batch: the port's
``transfer/denoise`` spans, their host time over their count."""
from portbench.harness.spans import denoise_host_ms as read  # noqa: F401
