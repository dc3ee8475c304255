"""Weights drawn on the device from the seed, in one large draw.

Every parameter of the reference's modules (whose names and shapes are the
port's) gets its slice of one standard-normal draw of all the parameters
together, made by a ``torch.Generator`` on the card, then scaled by its
kind: conv and dense kernels by 1/sqrt(fan_in) (LeCun normal, Flax's
default law), biases by 0.02, norm scales 1 + 0.1 N, norm shifts 0.1 N,
embedding rows by 1/sqrt(width).  Scales and shifts away from 1 and 0 keep
a kernel that dropped its affine step from passing unseen.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, int]  # name, shape, kind, fan_in


def specs_of(parts: Dict[str, torch.nn.Module]) -> List[Spec]:
    """Every parameter of the reference's modules (built on the meta
    device), named ``<part>.<parameter>``, with its kind and fan-in."""
    from portbench.reference.models import parameter_kinds

    out = []
    for part, module in parts.items():
        kinds = parameter_kinds(module)
        out += [(f"{part}.{n}", tuple(p.shape), *kinds[n]) for n, p in module.named_parameters()]
    return out


def make_weights(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, fan in specs:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            w.mul_(1.0 / math.sqrt(fan))
        elif kind == "bias":
            w.mul_(0.02)
        elif kind == "scale":
            w.mul_(0.1).add_(1.0)
        elif kind == "shift":
            w.mul_(0.1)
        elif kind == "table":
            w.mul_(1.0 / math.sqrt(fan))
        else:
            raise ValueError(f"unknown parameter kind {kind} of {name}")
        out[name] = w
    return out
