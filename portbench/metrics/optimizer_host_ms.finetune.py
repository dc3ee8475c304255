"""Host ms a train step in the optimizer in the traced steps: the port's
``train/optimizer`` (clip factor, AdamW over chunks) and ``train/ema``
spans, their host time over the ``train/step`` spans' count."""
from portbench.harness.spans import optimizer_host_ms as read  # noqa: F401
