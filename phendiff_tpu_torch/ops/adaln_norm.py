"""A DiT block's sub-layer boundary in one pass: the gated residual, the
LayerNorm and the adaLN modulate, as a hand-written Hopper kernel
(``csrc/adaln_norm.cu``) and as its plain PyTorch composition.

The JAX package has no DiT, so no TPU kernel corresponds.  For x [B, S, C],
an optional branch output y like x, and per-sample rows gate, shift and
scale1p [B, C] (``scale1p`` holds 1 + scale):

    x' = x + gate * y  (x itself without y)
    z  = LayerNorm(x') * scale1p + shift  (no affine, biased variance)

``adaln_norm`` returns (x', z).  The kernel reads x and y once and writes x'
and z (or z alone: without y, or with ``keep_x`` false, where x' comes back
None); the composition (``adaln_norm_plain``) is ``addcmul``, ``layer_norm``,
``addcmul`` in that order, three ops moving 7 activations.  The kernel rounds x' once
as ``addcmul`` does, takes the statistics over the stored x', and rounds z
once (the composition rounds the norm and then the modulate).

``adaln_norm`` launches the kernel for CUDA tensors and uses the
composition only for CPU tensors.  On the card it takes what ``refusal``
finds nothing against: autograd not recording, bf16 or f32 throughout,
C % 8 == 0 and C <= 1280 (DiT-S/B/L/XL's widths), [B, C] rows beside
[B, S, C] maps, x and y contiguous and 16-byte aligned, the rows' channels
contiguous at 16-byte aligned row strides (the unbind views of a [B, 6, C]
modulation qualify, read in place), every tensor on x's card; any other
CUDA call raises, naming what ``refusal`` found.  ``adaln_norm.launches``
counts kernel launches, ``.plain_calls`` the CPU calls that took the
composition, and ``adaln_norm_plain.ops`` the ops the composition
dispatched (each op as it dispatches).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from phendiff_tpu_torch.ops import _build

__all__ = ["adaln_norm", "adaln_norm_plain", "refusal"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# 8-channel vectors a lane holds at most (csrc kMaxVpl): one warp a row
MAX_CHANNELS = 8 * 32 * 5
# Rows a warp takes in turn; a block is 8 warps on consecutive rows of one
# sample.  At (32, 1024, 1152) in bf16, 2 read 80% of the byte bound, 1, 4
# and 8 76%, 79% and 75% (H100 80GB HBM3, 700 W).  Passed to the kernel at
# run time: as a compile-time count the compiler spilled at 64 registers.
ROWS_PER_WARP = 2


def _counted(op):
    """An op of the composition: each call adds one to ``adaln_norm_plain.ops``."""

    @functools.wraps(op)
    def counted(*args, **kwargs):
        adaln_norm_plain.ops += 1
        return op(*args, **kwargs)

    return counted


_addcmul = _counted(torch.addcmul)
_layer_norm = _counted(F.layer_norm)


def adaln_norm_plain(x, gate, y, shift, scale1p, *, eps: float, keep_x: bool = True):
    """(x', z) by the composition: x + gate * y (``addcmul``, with y), LayerNorm
    without affine, then x * scale1p + shift (``addcmul``); x' is None where
    ``keep_x`` is false and y is given."""
    if y is not None:
        x = _addcmul(x, gate[:, None], y)
    z = _addcmul(shift[:, None], _layer_norm(x, x.shape[-1:], eps=eps), scale1p[:, None])
    return (x if keep_x or y is None else None), z


def _aligned_rows(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and t.stride(0) * t.element_size() % 16 == 0)


def refusal(x, gate, y, shift, scale1p) -> Optional[str]:
    """What keeps the kernel from a call, or None where it takes it."""
    rows = (shift, scale1p) if y is None else (gate, shift, scale1p)
    maps = (x,) if y is None else (x, y)
    if torch.is_grad_enabled() and any(t.requires_grad for t in maps + rows):
        return "autograd records"
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in maps + rows):
        return "dtype"
    if (x.dim() != 3 or x.shape[-1] % 8 or x.shape[-1] > MAX_CHANNELS
            or any(t.shape != x.shape for t in maps)
            or any(t.shape != (x.shape[0], x.shape[2]) for t in rows)):
        return "shape"
    if (not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in maps)
            or not all(_aligned_rows(t) for t in rows)):
        return "layout"
    if any(t.device.type != "cuda" or t.device != x.device for t in maps + rows):
        return "device"
    return None


@functools.cache
def _entry():
    fn = _build.load("adaln_norm").phd_adaln_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    return fn


@_build.on_tensor_device
def _launch(x, gate, y, shift, scale1p, eps, keep_x):
    b, s, c = x.shape
    z = torch.empty_like(x)
    x_out = torch.empty_like(x) if y is not None and keep_x else None
    err = _entry()(
        x.data_ptr(), None if y is None else y.data_ptr(),
        None if y is None else gate.data_ptr(), shift.data_ptr(), scale1p.data_ptr(),
        0 if y is None else gate.stride(0), shift.stride(0), scale1p.stride(0),
        None if x_out is None else x_out.data_ptr(), z.data_ptr(), _DTYPE_CODES[x.dtype],
        b, s, c, ROWS_PER_WARP, float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "adaln_norm launch")
    adaln_norm.launches += 1
    return (x if y is None else x_out), z


def adaln_norm(
    x: torch.Tensor,  # [B, S, C]
    gate: Optional[torch.Tensor],  # [B, C], read only with y
    y: Optional[torch.Tensor],  # [B, S, C] or None
    shift: torch.Tensor,  # [B, C]
    scale1p: torch.Tensor,  # [B, C]
    *,
    eps: float,
    keep_x: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(x', z): one kernel launch for CUDA tensors (or it raises), the
    composition for CPU tensors.  Without y, x' is x; with y and ``keep_x``
    false, x' is not written and comes back None."""
    if x.device.type == "cpu":
        adaln_norm.plain_calls += 1
        return adaln_norm_plain(x, gate, y, shift, scale1p, eps=eps, keep_x=keep_x)
    why = refusal(x, gate, y, shift, scale1p)
    if why is not None:
        raise (TypeError if why == "dtype" else ValueError)(
            f"adaln_norm kernel cannot take this call ({why}): it runs with autograd not "
            f"recording, on bf16 or f32 alike, C % 8 == 0 and C <= {MAX_CHANNELS}, aligned "
            f"[B, S, C] maps and [B, C] rows on one CUDA device; x {tuple(x.shape)} {x.dtype}")
    return _launch(x, gate, y, shift, scale1p, eps, keep_x)


adaln_norm.launches = 0
adaln_norm.plain_calls = 0
adaln_norm_plain.ops = 0
