"""Multi-head attention dispatch.

Counterpart of ``phendiff_tpu/ops/attention.py``.  Callers hand over
[B, S, H, D] tensors.  Self-attention on a CUDA tensor goes to the fused
kernel (``flash_attention``, bf16 or f32, or it raises); cross-attention
(s_q != s_kv) and every CPU tensor take ``attention_plain``, the semantics
of the JAX package's ``attention_xla`` (f32 softmax, f32 accumulation).
"""

from __future__ import annotations

from typing import Optional

import torch

from phendiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention

__all__ = ["attention_plain", "multi_head_attention"]


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    if q.device.type == "cuda" and q.shape[1] == k.shape[1]:
        return flash_attention(q, k, v, scale=scale)
    return attention_plain(q, k, v, scale=scale)
