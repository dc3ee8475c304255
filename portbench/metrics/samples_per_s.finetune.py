"""The fine-tune's samples of all the window's steps over all its seconds.
Host-paced, it spreads too widely between runs for an end-to-end bound."""
from portbench.harness.readings import samples_per_s as read  # noqa: F401
