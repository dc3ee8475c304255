"""A ResnetBlock's residual with its convs' biases, ``out = x + h + bias
(+ bias2)`` over NHWC maps, as a hand-written Hopper kernel
(``csrc/residual_bias.cu``) and as its plain PyTorch version.

No TPU kernel corresponds: the JAX package's convs add their own biases.
A ResnetBlock that runs conv2 (h) and its 1x1 shortcut (x) without their
biases hands both biases here, so the residual's one pass adds them, where
ATen would add each in a broadcast pass over its map of its own
(``models/unet2d.py``, ``ResnetBlock``).  The sum is taken in f32 in the
order ((x + h) + bias) + bias2 and rounded once to the maps' dtype, in the
kernel and in the plain version alike, so the two give the same bits.

``residual_bias`` launches the kernel for CUDA tensors and uses the plain
version only for CPU tensors.  On the card it takes what ``refusal`` finds
nothing against: autograd not recording, bf16 or f32 throughout, maps x and
h of one shape [..., C] with C % 8 == 0 and [C] biases, every tensor
contiguous and 16-byte aligned, all on one device; any other CUDA call
raises, naming what ``refusal`` found.  ``refusal`` holds CPU tensors to
the same terms, so a caller that asks it first takes one route on either
device.  ``residual_bias.launches`` counts kernel launches and
``.plain_calls`` the CPU calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from phendiff_tpu_torch.ops import _build
from phendiff_tpu_torch.ops.gn_kernels import _records

__all__ = ["residual_bias", "residual_bias_plain", "refusal"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# 8-channel vectors a call takes at most (csrc: rows * C / 8 <= 2^30)
MAX_VECTORS = 1 << 30


def residual_bias_plain(x, h, bias, bias2=None):
    """((x + h) + bias) + bias2 in f32, rounded once to x's dtype."""
    out = x.float() + h.float() + bias.float()
    if bias2 is not None:
        out = out + bias2.float()
    return out.to(x.dtype)


def refusal(x, h, bias, bias2=None) -> Optional[str]:
    """What keeps a call from the kernel's contract, or None where it takes it."""
    vecs = (bias,) if bias2 is None else (bias, bias2)
    if _records(x, h, *vecs):
        return "autograd records"
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in (h, *vecs)):
        return "dtype"
    c = x.shape[-1] if x.dim() else 0
    if (x.dim() < 2 or h.shape != x.shape or c % 8 or c == 0
            or any(t.shape != (c,) for t in vecs) or x.numel() // 8 > MAX_VECTORS):
        return "shape"
    if x.device.type not in ("cuda", "cpu") or any(t.device != x.device for t in (h, *vecs)):
        return "device"
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (x, h, *vecs)):
        return "layout"
    return None


@functools.cache
def _entry():
    fn = _build.load("residual_bias").phd_residual_bias
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p])
    return fn


@_build.on_tensor_device
def _launch(x, h, bias, bias2):
    c = x.shape[-1]
    out = torch.empty_like(x)
    err = _entry()(
        x.data_ptr(), h.data_ptr(), bias.data_ptr(), None if bias2 is None else bias2.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[x.dtype], x.numel() // c, c,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "residual_bias launch")
    residual_bias.launches += 1
    return out


def residual_bias(
    x: torch.Tensor,  # [..., C]
    h: torch.Tensor,  # like x
    bias: torch.Tensor,  # [C]
    bias2: Optional[torch.Tensor] = None,  # [C]
) -> torch.Tensor:
    """x + h + bias (+ bias2): one kernel launch for CUDA tensors (or it
    raises), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        residual_bias.plain_calls += 1
        return residual_bias_plain(x, h, bias, bias2)
    why = refusal(x, h, bias, bias2)
    if why is not None:
        raise (TypeError if why == "dtype" else ValueError)(
            f"residual_bias kernel cannot take this call ({why}): it runs with autograd not "
            f"recording, on bf16 or f32 alike, C % 8 == 0, contiguous 16-byte aligned maps of "
            f"one shape and [C] biases on one CUDA device; x {tuple(x.shape)} {x.dtype}")
    return _launch(x, h, bias, bias2)


residual_bias.launches = 0
residual_bias.plain_calls = 0
