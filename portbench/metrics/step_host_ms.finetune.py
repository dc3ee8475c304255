"""Host ms a train step in the traced steps: the port's ``train/step``
spans, their host time over their count."""
from portbench.harness.spans import step_host_ms as read  # noqa: F401
