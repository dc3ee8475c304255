"""The control's arithmetic: the reference one precision below bf16.

``Fp8Arith`` rounds every operand of a product (convolution, dense layer,
both attention products) to float8: e4m3 in the forward, as an fp8
inference or training recipe stores activations and weights, each tensor
scaled by its own absolute maximum onto the format's range; the gradient
that flows back through a rounded operand is itself rounded to e5m2.  The
products then run in float32 on the rounded values, so only the rounding
differs from ``Arith``.
"""

from __future__ import annotations

import torch

from portbench.reference.models import Arith

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` scaled by its absolute maximum onto [-top, top], rounded to
    ``dtype`` and scaled back, in x's dtype."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return round_fp8(grad, torch.float8_e5m2, E5M2_MAX)


class Fp8Arith(Arith):
    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(x)
