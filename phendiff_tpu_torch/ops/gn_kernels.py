"""Fused GroupNorm + affine + optional SiLU: a hand-written Hopper kernel
and its plain PyTorch version.

Counterpart of ``phendiff_tpu/ops/gn_kernels.py`` (TPU kernel
``_gn_kernel``, launched by ``_pallas_gn``), with the semantics of the JAX
package's XLA GroupNorm path, the TPU default: f32 one-pass moments, the
``max(var, 0)`` clamp, f32 affine and SiLU, output in ``out_dtype``.  The
CUDA source, ``csrc/group_norm_silu.cu``, splits the reduction over many
blocks per sample; its header gives the design and the bound.

``fused_group_norm`` launches the kernel for CUDA tensors (which writes
its output in the input's dtype, as every UNet call asks) and uses
``group_norm_plain`` only for CPU tensors.  ``fused_group_norm.launches``
counts kernel launches (one per call: the stats, combine and apply passes
of one call count once).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from phendiff_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Blocks per sample are chosen so a call has about this many blocks in all
# (a few waves over the H100's 132 SMs).
_TARGET_BLOCKS = 1024
_MAX_CHANNELS = 2048


def group_norm_plain(
    x: torch.Tensor,  # [B, S, C]
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    num_groups: int,
    eps: float,
    act: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """GroupNorm over [B, S, C] with the JAX package's XLA-path semantics."""
    b, s, c = x.shape
    xf = x.float().reshape(b, s, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    meansq = xf.square().mean(dim=(1, 3), keepdim=True)
    var = (meansq - mean.square()).clamp_min(0.0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, s, c)
    if scale is not None:
        xf = xf * scale.float()
    if bias is not None:
        xf = xf + bias.float()
    if act == "silu":
        xf = F.silu(xf)
    elif act is not None:
        raise ValueError(f"unknown activation: {act}")
    return xf.to(out_dtype or torch.float32)


def _num_splits(b: int, s: int, c: int) -> int:
    cvn = c // 8
    rows_per_block_pass = 1 if cvn >= 256 else 256 // cvn
    max_splits = -(-s // rows_per_block_pass)
    return max(1, min(max_splits, -(-_TARGET_BLOCKS // b)))


@functools.cache
def _entry():
    fn = _build.load("group_norm_silu").phd_group_norm_silu
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _launch(x, scale, bias, num_groups, eps, act, out_dtype) -> torch.Tensor:
    b, s, c = x.shape
    if x.dtype not in _DTYPE_CODES or out_dtype != x.dtype:
        raise TypeError(
            f"group_norm kernel maps f32 -> f32 or bf16 -> bf16, got {x.dtype} -> {out_dtype}"
        )
    if scale is None or bias is None:
        raise ValueError("group_norm kernel needs scale and bias")
    if c % 8 or c % num_groups or c > _MAX_CHANNELS:
        raise ValueError(
            f"group_norm kernel needs C % 8 == 0, C % G == 0, C <= {_MAX_CHANNELS}; "
            f"got C={c}, G={num_groups}"
        )
    if act not in (None, "silu"):
        raise ValueError(f"unknown activation: {act}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernel needs a 16-byte aligned input")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    nsplit = _num_splits(b, s, c)
    out = torch.empty((b, s, c), dtype=out_dtype, device=x.device)
    work = torch.empty(2 * b * nsplit * c + 2 * b * num_groups,
                       dtype=torch.float32, device=x.device)
    err = _entry()(
        x.data_ptr(), _DTYPE_CODES[x.dtype], scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), work.data_ptr(),
        b, s, c, num_groups, float(eps), int(act == "silu"), nsplit,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "group_norm_silu launch")
    fused_group_norm.launches += 1
    return out


def fused_group_norm(
    x: torch.Tensor,  # [B, S, C]
    scale: Optional[torch.Tensor],  # [C]
    bias: Optional[torch.Tensor],  # [C]
    *,
    num_groups: int,
    eps: float,
    act: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """GroupNorm (+ affine + SiLU) over [B, S, C].

    A CUDA tensor goes through the kernel (``out_dtype`` equal to x's) or
    raises; a CPU tensor goes through ``group_norm_plain``.
    """
    out_dtype = out_dtype or torch.float32
    kw = dict(num_groups=num_groups, eps=eps, act=act, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm runs on cuda or cpu, not {x.device}")
    return _launch(x, scale, bias, num_groups, eps, act, out_dtype)


fused_group_norm.launches = 0
