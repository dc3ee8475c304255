"""Mixed-precision policy: f32 params, bf16 compute.

Counterpart of ``phendiff_tpu/core/precision.py``.  Master params stay in
float32; activations and conv/linear weights run in bfloat16 with float32
accumulation; GroupNorm statistics, affine and SiLU, the softmax, the
sampler state and all scheduler arithmetic stay in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _dtype(name):
    return _DTYPES[name] if isinstance(name, str) else name


def cast_floating(tensors: Mapping[str, torch.Tensor], dtype) -> dict:
    """Cast every floating-point tensor of a state dict to ``dtype``;
    integer and bool tensors pass through."""
    dtype = _dtype(dtype)
    return {
        k: v.to(dtype) if torch.is_floating_point(v) else v
        for k, v in tensors.items()
    }


def cast_matmul_weights(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast the conv and linear weights of ``module`` in place to ``dtype``.

    The inference form of the policy: the weight-heavy layers are stored in
    the compute dtype so no forward re-casts them, while GroupNorm scale and
    bias and the class-embedding table stay float32 (the GroupNorm kernel
    takes f32 scale and bias).
    """
    dtype = _dtype(dtype)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
    return module


@dataclasses.dataclass(frozen=True)
class Policy:
    """param_dtype: storage; compute_dtype: activations/matmuls; output_dtype."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"

    @classmethod
    def from_mixed_precision(cls, mixed_precision: str) -> "Policy":
        """Map the reference's --mixed_precision {no,fp16,bf16} flag (fp16 is
        mapped to bf16, which needs no loss scaling)."""
        if mixed_precision in (None, "no", "fp32", "float32"):
            return cls()
        if mixed_precision in ("bf16", "bfloat16", "fp16", "float16"):
            return cls(compute_dtype="bfloat16", output_dtype="float32")
        raise ValueError(f"unknown mixed_precision: {mixed_precision}")

    @property
    def param_torch(self) -> torch.dtype:
        return _dtype(self.param_dtype)

    @property
    def compute_torch(self) -> torch.dtype:
        return _dtype(self.compute_dtype)

    @property
    def output_torch(self) -> torch.dtype:
        return _dtype(self.output_dtype)

    def cast_to_compute(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        return cast_floating(tensors, self.compute_torch)
