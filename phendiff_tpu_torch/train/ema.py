"""Exponential moving average of the parameters, with a warmup law.

Counterpart of ``phendiff_tpu/train/ema.py``:

    decay(step) = clamp(1 - (1 + step/inv_gamma)^(-power), min_decay, max_decay)

``ema_update`` updates the EMA tensors in place (the JAX package returns a
new tree; the port keeps one copy on the device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    inv_gamma: float = 1.0
    power: float = 0.75
    max_decay: float = 0.9999
    min_decay: float = 0.0


def ema_decay(config: EMAConfig, step: int) -> float:
    """The decay at ``step``, in float32 as the JAX package computes it."""
    step = torch.tensor(float(step), dtype=torch.float32)
    value = 1.0 - (1.0 + step / config.inv_gamma) ** (-config.power)
    return float(value.clamp(config.min_decay, config.max_decay))


@torch.no_grad()
def ema_update(config: EMAConfig, ema: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], step: int) -> None:
    """One EMA step in place: ema <- decay * ema + (1 - decay) * params."""
    d = ema_decay(config, step)
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, torch._foreach_mul([params[n] for n in names], 1.0 - d))
