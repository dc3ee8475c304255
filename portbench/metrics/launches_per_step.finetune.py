"""Device kernels launched per train step in the traced steps: the host's
dispatch."""
from portbench.harness.readings import launches_per_unit as read  # noqa: F401
