"""Self-attention's share of its roofline in the traced stretch: the least
seconds of the configuration's self-attention calls over the device
seconds of the attention kernels (the port's and the library's), in %."""
from portbench.harness.readings import attention_roofline as read  # noqa: F401
