"""Fused self-attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``phendiff_tpu/ops/flash_attention.py`` (TPU kernel
``_fwd_kernel``, launched by ``_flash_fwd_3d``).  The CUDA source,
``csrc/flash_attn_fwd.cu``, streams k/v tiles through shared memory with an
online f32 softmax, one thread per q row; its header gives the design and
the bound.  The TPU kernel's [BH, D, S] layout was a lane workaround and is
not carried over: the kernel reads [B, S, H, D] through strides, so the
q/k/v column slices of the fused qkv projection need no copy.

``flash_attention`` launches the kernel for CUDA tensors and uses
``attention_plain`` only for CPU tensors.  ``flash_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from phendiff_tpu_torch.ops import _build

# Head dims the kernel is instantiated for (the main path's 8, the SD
# path's 64); others are zero-padded up.
_KERNEL_DIMS = (8, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, S, H, D] q/k/v -> [B, S, H, D], the semantics of
    ``phendiff_tpu.ops.attention.attention_xla``.

    q is scaled in its own dtype; both products run in float32 on the
    (bf16-valued) inputs, which is a bf16 matmul with f32 accumulation; the
    softmax is float32 and the probabilities are rounded to v's dtype before
    the PV product; the output is in q's dtype.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    qs = q * torch.tensor(scale, dtype=q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _kernel_dim(d: int) -> int:
    for kd in _KERNEL_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f"flash_attention kernel supports head dims up to 64, got {d}")


def _aligned(t: torch.Tensor) -> bool:
    return (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all(s % 8 == 0 for s in t.stride()[:3])
    )


@functools.cache
def _entry():
    fn = _build.load("flash_attn_fwd").phd_flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return fn


def _launch(q, k, v, scale: float) -> torch.Tensor:
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPE_CODES):
        raise TypeError(
            f"flash_attention kernel takes one of bf16/f32, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention kernel is self-attention: q, k, v shapes must match")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel grid limit 65535")
    kd = _kernel_dim(d)
    if kd != d:  # zero head-dim padding adds zero to every score
        q, k, v = (F.pad(t, (0, kd - d)) for t in (q, k, v))
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, s, h, kd), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v, o) for st in t.stride()[:3]]
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPE_CODES[q.dtype],
        b, s, h, kd, *strides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_fwd launch")
    flash_attention.launches += 1
    return o[..., :d] if kd != d else o


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, S, H, D] fused self-attention forward.

    A CUDA tensor goes through the kernel (bf16 or f32, D <= 64) or raises;
    a CPU tensor goes through ``attention_plain``.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, scale)


flash_attention.launches = 0
