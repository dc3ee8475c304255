"""Fused self-attention, forward and backward: hand-written Hopper kernels
and their plain PyTorch versions.

Counterpart of ``phendiff_tpu/ops/flash_attention.py`` (TPU kernels
``_fwd_kernel``, launched by ``_flash_fwd_3d``, and ``_bwd_kernel``,
launched by ``_flash_bwd_3d`` under the custom VJP).  The CUDA sources,
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu`` (with the
shared ``csrc/attn_mma.cuh``), stream tiles through shared memory with f32
softmax arithmetic; their headers give the designs and the bounds.  The
TPU kernels' [BH, D, S] layout was a lane workaround and is not carried
over: the kernels read [B, S, H, D] through strides, so the q/k/v column
slices of the fused qkv projection need no copy.

``flash_attention`` launches the kernels for CUDA tensors and uses
``attention_plain`` (differentiated by autograd) only for CPU tensors.
When a gradient is needed the forward also saves each row's log-sum-exp,
and the backward (``flash_attention_bwd``) recomputes the probabilities
from it.  ``flash_attention.launches`` and ``flash_attention_bwd.launches``
count kernel launches.  Every launch runs with the current device set to
its input's (``_build.on_tensor_device``).

The kernel is chosen by the input dtype, inside the C entries: bf16 runs
the tensor-core kernels (``mma.sync``), f32 the CUDA-core FMA kernels,
because the tensor cores take f32 only as TF32, which would miss the f32
tolerances.  Either way a CUDA tensor launches a kernel or raises.
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


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    scale: Optional[float] = None,
):
    """(dq, dk, dv) of self-attention for [B, S, H, D] inputs and output
    gradient ``g``, step by step as the TPU kernel ``_bwd_kernel`` computes
    them: p from f32 scores of (q * scale in q's dtype) and k; dp = g v^T;
    ds = p * (dp - rowsum(p * dp)), rounded to q's dtype; dq = ds k * scale
    and dk = ds^T (q * scale), dv = p^T g with p rounded to g's dtype, all
    accumulated in f32; outputs in the inputs' dtype.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    dt = q.dtype
    qs = (q * torch.tensor(scale, dtype=dt)).float()
    kf, vf, gf = k.float(), v.float(), g.to(dt).float()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qs, kf), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


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


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


def _check_dtypes(*ts):
    dt = ts[0].dtype
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in ts):
        raise TypeError(
            f"flash_attention kernels take one of bf16/f32, got {[t.dtype for t in ts]}"
        )


@functools.cache
def _entry():
    fn = _build.load("flash_attn_fwd").phd_flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.load("flash_attn_bwd").phd_flash_attn_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return fn


@_build.on_tensor_device
def _launch(q, k, v, scale: float, with_lse: bool = False):
    """Forward kernel on kernel-dim inputs: o, or (o, lse) with ``with_lse``."""
    _check_dtypes(q, k, v)
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention kernel is self-attention: q, k, v shapes must match")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel grid limit 65535")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {_KERNEL_DIMS}, got {d}")
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None, _DTYPE_CODES[q.dtype],
        b, s, h, d, *_strides(q, k, v, o), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_fwd launch")
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


@_build.on_tensor_device
def flash_attention_bwd(q, k, v, o, lse, g, scale: float):
    """(dq, dk, dv) from the backward kernel, for kernel-dim CUDA inputs:
    q, k, v as the forward took them, its output ``o`` and row log-sum-exp
    ``lse`` (``_launch(..., with_lse=True)``), and the output gradient
    ``g``.  Outputs are contiguous, in the inputs' dtype."""
    g = g.to(q.dtype)
    _check_dtypes(q, k, v, o, g)
    b, s, h, d = q.shape
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    o, g = o.contiguous(), g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _bwd_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        _DTYPE_CODES[q.dtype], b, s, h, d, *_strides(q, k, v), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_bwd launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel saving its row log-sum-exp, differentiated by the
    backward kernel (the counterpart of the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _launch(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, S, H, D] fused self-attention, differentiable.

    A CUDA tensor goes through the kernels (bf16 or f32, D <= 64; other
    head dims are zero-padded up to 8 or 64, which adds zero to every
    score) or raises; a CPU tensor goes through ``attention_plain``.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    d = q.shape[-1]
    kd = _kernel_dim(d)
    if kd != d:
        q, k, v = (F.pad(t, (0, kd - d)) for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = _FlashAttention.apply(q, k, v, scale)
    else:
        o = _launch(q, k, v, scale)
    return o[..., :d] if kd != d else o


flash_attention.launches = 0
flash_attention_bwd.launches = 0
