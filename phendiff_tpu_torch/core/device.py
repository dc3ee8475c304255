"""Where the port's entry points run."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The card (``"cuda"``) unless the caller names another device.

    Raises when CUDA is asked for (explicitly or by default) and is absent:
    an entry point never carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def device_of(module: torch.nn.Module) -> Optional[torch.device]:
    """Device of a module's first parameter (None for a module without any)."""
    for p in module.parameters():
        return p.device
    return None
