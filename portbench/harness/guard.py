"""What a run may not load: the JAX stack and the JAX package the port was
made from.  Names are compared by their top-level part whole, so the port
(``phendiff_tpu_torch``) is not the JAX package (``phendiff_tpu``)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "phendiff_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level part is forbidden."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
