"""Multi-head attention dispatch.

Counterpart of ``phendiff_tpu/ops/attention.py``.  Callers hand over
[B, S, H, D] tensors.  Self-attention with D <= 72 on a CUDA tensor goes to
the fused kernel (``flash_attention``, bf16 or f32, or it raises; above
D = 64, DiT-XL/2's heads of 72, forward only).
Cross-attention (s_q != s_kv, the SD UNet's 77-token class sequence) and
self-attention with D > 72 (one head of D = 512 in ``ddpm_unconditional_256``,
at S = 256 and in the mid block) take ``attention_plain``, the counterpart
of the JAX package's ``attention_xla`` (bf16 products, f32 softmax, f32
accumulation), as that package's dispatcher does for them: it sends every
call below S = 1024 and every cross-attention to XLA.  On a CPU tensor
every call takes ``attention_plain``.

``multi_head_attention.xla_route_calls`` counts the calls routed to
``attention_plain`` by shape (cross-attention or D > 72), on any device.
``single_head_attention`` is the SD VAE's mid-block attention, one head of
D = C as f32 products, which the JAX package also computes outside any
kernel; ``single_head_attention.calls`` counts it.
"""

from __future__ import annotations

from typing import Optional

import torch

from phendiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention

__all__ = ["attention_plain", "multi_head_attention", "single_head_attention",
           "takes_kernel"]

# The widest head the attention kernels take (flash_attention raises above).
KERNEL_MAX_HEAD_DIM = 72


def takes_kernel(s_q: int, s_kv: int, head_dim: int) -> bool:
    """Whether a CUDA call of this shape goes to the fused kernel."""
    return s_q == s_kv and head_dim <= KERNEL_MAX_HEAD_DIM


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    if not takes_kernel(q.shape[1], k.shape[1], q.shape[-1]):
        multi_head_attention.xla_route_calls += 1
        return attention_plain(q, k, v, scale=scale)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, scale=scale)
    return attention_plain(q, k, v, scale=scale)


def single_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, S, C] q/k/v -> [B, S, C] float32: softmax(q k^T / sqrt(C)) v with
    both products and the softmax in float32 (the SD VAE's attention)."""
    single_head_attention.calls += 1
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bqc,bkc->bqk", qf, kf) * (q.shape[-1] ** -0.5)
    return torch.einsum("bqk,bkc->bqc", torch.softmax(scores, dim=-1), vf)


multi_head_attention.xla_route_calls = 0
single_head_attention.calls = 0
