"""The device's idle share of the traced stretch: 1 - (union of the device's
operation intervals) / (the stretch's host seconds), in %."""
from portbench.harness.readings import idle_pct as read  # noqa: F401
