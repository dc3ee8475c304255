"""GroupNorm (+ fused SiLU) over NHWC maps.

Counterpart of ``phendiff_tpu/ops/group_norm.py`` on its unpacked path
(the lane-packed branch is a TPU layout transform and has no counterpart).
An NHWC map is handed to ``fused_group_norm`` as a [B, H*W, C] view: on a
CUDA tensor that is the hand-written kernel, on a CPU tensor the plain
version ``group_norm_plain``.  Statistics, affine and activation are float32;
``out_dtype`` is the storage dtype of the result (default float32).
"""

from __future__ import annotations

from typing import Optional

import torch

from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm, group_norm_plain

__all__ = ["group_norm", "group_norm_plain"]


def group_norm(
    x: torch.Tensor,  # [B, H, W, C]
    *,
    num_groups: int,
    eps: float,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    out = fused_group_norm(
        x.reshape(b, h * w, c), scale, bias,
        num_groups=num_groups, eps=eps, act=act, out_dtype=out_dtype,
    )
    return out.reshape(b, h, w, c)
