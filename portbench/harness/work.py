"""The work a cell does, counted from its configuration on the meta device
(no data, no card): the model FLOPs of a denoiser call, a VAE encode or
decode, or a train step's forward and backward (``FlopCounterMode`` over
the reference models: convolutions, dense layers and both attention
products), and the GroupNorm and self-attention calls by shape
(``reference.models.Recorder``), from which each kernel's least time on
the chip follows.

Least times (``peaks``): attention forward 4 S^2 D FLOPs a head (Q K^T and
P V), reading Q, K, V and writing O once; backward 10 S^2 D a head
(recomputed scores, dV, dP, dS, dQ, dK), reading Q, K, V, O, dO and the row
log-sum-exp and writing dQ, dK, dV; a call's least time is the larger of
FLOPs over the bf16 peak and bytes over the HBM bandwidth.  GroupNorm:
bytes alone, one read of x (and of dy in the backward) and one write of
the result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import peaks
from portbench.reference.models import Recorder


@dataclasses.dataclass
class Calls:
    """GroupNorm calls by (S, C) and self-attention calls by (S, H, D),
    each counted once per sample."""

    group_norm: Dict[Tuple[int, int], int]
    attention: Dict[Tuple[int, int, int], int]


def count(run: Callable[[Recorder], torch.Tensor]) -> Tuple[float, Calls]:
    """FLOPs and calls of ``run(recorder)`` on the meta device (``run``
    builds its modules under ``torch.device('meta')`` itself, and may call
    ``backward`` on what it returns)."""
    rec = Recorder()
    with FlopCounterMode(display=False) as fc:
        run(rec)
    return float(fc.get_total_flops()), Calls(dict(rec.group_norm_calls),
                                              dict(rec.attention_calls))


def attention_least_s(calls: Calls, itemsize: int, backward: bool) -> float:
    """Least seconds of every self-attention call, forward (and backward)."""
    total = 0.0
    for (s, h, d), n in calls.attention.items():
        flops_f = 4.0 * s * s * d * h
        bytes_f = 4.0 * s * h * d * itemsize
        total += n * max(flops_f / peaks.BF16_FLOPS, bytes_f / peaks.HBM_BYTES)
        if backward:
            flops_b = 10.0 * s * s * d * h
            bytes_b = 8.0 * s * h * d * itemsize + 4.0 * s * h
            total += n * max(flops_b / peaks.BF16_FLOPS, bytes_b / peaks.HBM_BYTES)
    return total


def group_norm_least_s(forward: Calls, itemsize: int, backward: Calls = None) -> float:
    """Least seconds of the GroupNorm calls: ``forward``'s read x once and
    write once; ``backward``'s read x and dy and write dx."""
    total = sum(n * 2.0 * s * c * itemsize for (s, c), n in forward.group_norm.items())
    if backward is not None:
        total += sum(n * 3.0 * s * c * itemsize for (s, c), n in backward.group_norm.items())
    return total / peaks.HBM_BYTES
