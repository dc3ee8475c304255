"""Device kernels launched in the traced batch per denoiser call (the
batch's VAE encode and decode included): the host's dispatch."""
from portbench.harness.readings import launches_per_unit as read  # noqa: F401
