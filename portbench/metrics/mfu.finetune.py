"""The whole step's share of the H100's bf16 peak (989 TFLOP/s) over the
window: the reference's model FLOPs of the window's work over its seconds."""
from portbench.harness.readings import mfu as read  # noqa: F401
