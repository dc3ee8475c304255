"""Logger setup: per-process prefixed logging with a main-process filter.

Counterpart of ``phendiff_tpu/obs/logging_utils.py``, in the same format.
The process index is the ``torch.distributed`` rank when a process group
exists, and 0 otherwise.
"""

from __future__ import annotations

import logging
import sys


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def setup_logger(
    name: str = "phendiff",
    level: int = logging.INFO,
    main_process_only: bool = False,
) -> logging.Logger:
    proc = process_index()
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                f"%(asctime)s [p{proc}] %(levelname)s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
    if main_process_only and proc != 0:
        logger.setLevel(logging.CRITICAL)
    return logger
