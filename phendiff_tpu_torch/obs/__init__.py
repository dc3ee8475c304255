"""Observability: trackers, images, logging, the port's spans, profiling
hooks and step timing.  A device-time breakdown of a cell is the
benchmark's (``portbench/run.py --trace 1``)."""

from phendiff_tpu_torch.obs.images import (  # noqa: F401
    image_grid,
    latents_to_grayscale,
    side_by_side,
    to_pil,
)
from phendiff_tpu_torch.obs.logging_utils import setup_logger  # noqa: F401
from phendiff_tpu_torch.obs.profiling import (  # noqa: F401
    StepTimer,
    annotate,
    force_sync,
    recorder,
    recording,
    trace_if,
)
from phendiff_tpu_torch.obs.trackers import (  # noqa: F401
    JSONLTracker,
    NullTracker,
    Tracker,
    WandbTracker,
    make_tracker,
)
