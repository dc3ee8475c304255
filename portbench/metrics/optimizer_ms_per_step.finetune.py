"""Device milliseconds per train step in the optimizer's kernels (the
multi-tensor clip, AdamW and EMA passes) in the traced steps."""
from portbench.harness.readings import optimizer_ms_per_step as read  # noqa: F401
