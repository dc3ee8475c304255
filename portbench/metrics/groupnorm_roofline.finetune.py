"""GroupNorm's share of its roofline in the traced stretch: the least
seconds of the calls (bytes at 3.35 TB/s) over the device seconds of the
GroupNorm kernels (the port's and the library's), in %."""
from portbench.harness.readings import group_norm_roofline as read  # noqa: F401
