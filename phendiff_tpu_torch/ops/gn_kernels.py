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
``group_norm_plain`` only for CPU tensors.  On the card it is a
``torch.autograd.Function`` whose backward recomputes ``group_norm_plain``
under autograd, as the JAX package's ``_fused_gn_bwd`` recomputes its XLA
reference (there is no TPU backward kernel to port).
``fused_group_norm.launches`` counts kernel launches (one per call: the
stats, combine and apply passes of one call count once).

``channel_moments`` is the counterpart of ``m_pallas`` in
``tools/bench_gn_moments.py``: per-channel f32 sum x and sum x^2 of a
[B, S, C] map, through the statistics pass of the same CUDA source.
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


@functools.cache
def _moments_entry():
    fn = _build.load("group_norm_silu").phd_channel_moments
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _check_input(x: torch.Tensor, num_groups: int = 1) -> torch.Tensor:
    """The kernels' constraints on x; returns x contiguous."""
    c = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm kernels take bf16 or f32, got {x.dtype}")
    if c % 8 or c % num_groups or c > _MAX_CHANNELS:
        raise ValueError(
            f"group_norm kernels need C % 8 == 0, C % G == 0, C <= {_MAX_CHANNELS}; "
            f"got C={c}, G={num_groups}"
        )
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernels need a 16-byte aligned input")
    return x


def _launch(x, scale, bias, num_groups, eps, act, out_dtype) -> torch.Tensor:
    b, s, c = x.shape
    if out_dtype != x.dtype:
        raise TypeError(
            f"group_norm kernel maps f32 -> f32 or bf16 -> bf16, got {x.dtype} -> {out_dtype}"
        )
    if scale is None or bias is None:
        raise ValueError("group_norm kernel needs scale and bias")
    if act not in (None, "silu"):
        raise ValueError(f"unknown activation: {act}")
    x = _check_input(x, num_groups)
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


class _FusedGroupNorm(torch.autograd.Function):
    """The kernel forward; the backward recomputes ``group_norm_plain`` (f32,
    the one-pass moments with the ``max(var, 0)`` clamp) under autograd and
    returns dx in x's dtype and f32 dscale, dbias."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act, out_dtype):
        ctx.save_for_backward(x, scale, bias)
        ctx.kw = dict(num_groups=num_groups, eps=eps, act=act)
        return _launch(x, scale, bias, num_groups, eps, act, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs, ss, bs = (t.detach().requires_grad_() for t in (x, scale, bias))
            out = group_norm_plain(xs, ss, bs, out_dtype=torch.float32, **ctx.kw)
            dx, dscale, dbias = torch.autograd.grad(out, (xs, ss, bs), g.float())
        return dx.to(x.dtype), dscale.float(), dbias.float(), None, None, None, None


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
    """GroupNorm (+ affine + SiLU) over [B, S, C], differentiable.

    A CUDA tensor goes through the kernel (``out_dtype`` equal to x's) or
    raises; a CPU tensor goes through ``group_norm_plain``.
    """
    out_dtype = out_dtype or torch.float32
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups=num_groups, eps=eps, act=act,
                                out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, scale, bias)
    ):
        return _FusedGroupNorm.apply(x, scale, bias, num_groups, eps, act, out_dtype)
    return _launch(x, scale, bias, num_groups, eps, act, out_dtype)


def channel_moments_plain(x: torch.Tensor, tile: int = 512):
    """Per-channel f32 (sum x, sum x^2) over the S axis of [B, S, C], as the
    TPU kernel computes them: f32 accumulators carried across S-tiles."""
    b, _, c = x.shape
    s = torch.zeros(b, c, dtype=torch.float32, device=x.device)
    q = torch.zeros_like(s)
    for t in x.split(tile, dim=1):
        tf = t.float()
        s += tf.sum(dim=1)
        q += tf.square().sum(dim=1)
    return s, q


def channel_moments(x: torch.Tensor):
    """Per-channel f32 (sum x, sum x^2), each [B, C], of a [B, S, C] map.

    A CUDA tensor (bf16 or f32, C % 8 == 0) goes through the kernel (the
    GroupNorm statistics pass plus a fixed-order combine, deterministic) or
    raises; a CPU tensor goes through ``channel_moments_plain``.
    """
    if x.device.type == "cpu":
        return channel_moments_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_moments runs on cuda or cpu, not {x.device}")
    b, s, c = x.shape
    x = _check_input(x)
    nsplit = _num_splits(b, s, c)
    work = torch.empty(2 * b * nsplit * c, dtype=torch.float32, device=x.device)
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    err = _moments_entry()(
        x.data_ptr(), _DTYPE_CODES[x.dtype], work.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), b, s, c, nsplit, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "channel_moments launch")
    channel_moments.launches += 1
    return out[0], out[1]


fused_group_norm.launches = 0
channel_moments.launches = 0
