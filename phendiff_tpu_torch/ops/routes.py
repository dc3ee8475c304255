"""Kernel routing and launch counting of the ``ops`` wrappers.

``plain_kernels`` routes the models' GroupNorm, attention and ResnetBlock
residual through their plain versions; ``record_calls`` runs a callable so
routed (on the meta device: no data, no kernels) and records every call by
shape.  The model-level recorders built on it are in
``tools/kernel_calls.py``.

``launch_counts`` reads every launch counter of the wrappers (the function
attributes ``fused_group_norm.launches``, ``flash_attention.wgmma_launches``,
``single_head_attention.calls``, ...) under one key each, and
``reset_launch_counts`` zeroes them: ``COUNTERS`` is the one place that
names them.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict

from phendiff_tpu_torch.ops import adaln_norm as an
from phendiff_tpu_torch.ops import attention
from phendiff_tpu_torch.ops import flash_attention as fa
from phendiff_tpu_torch.ops import gn_kernels, group_norm
from phendiff_tpu_torch.ops import residual_bias as rb

# key -> (wrapper, counter attribute)
COUNTERS = {
    "flash_attn_fwd": (fa.flash_attention, "launches"),
    "flash_attn_bwd": (fa.flash_attention_bwd, "launches"),
    "group_norm_silu": (gn_kernels.fused_group_norm, "launches"),
    "group_norm_silu_bwd": (gn_kernels.fused_group_norm_bwd, "launches"),
    "flash_attn_fwd_wgmma": (fa.flash_attention, "wgmma_launches"),
    "flash_attn_bwd_wgmma": (fa.flash_attention_bwd, "wgmma_launches"),
    "group_norm_silu_stream": (gn_kernels.fused_group_norm, "stream_launches"),
    "group_norm_silu_stream_bwd": (gn_kernels.fused_group_norm_bwd, "stream_launches"),
    "attention_plain_route": (attention.multi_head_attention, "xla_route_calls"),
    "single_head_attention": (attention.single_head_attention, "calls"),
    "group_norm_silu_addend": (gn_kernels.fused_group_norm, "addend_launches"),
    "group_norm_addend_materialised": (gn_kernels.fused_group_norm, "addend_materialised"),
    "group_norm_bwd_g_copies": (gn_kernels.fused_group_norm_bwd, "g_copies"),
    "channel_moments": (gn_kernels.channel_moments, "launches"),
    "adaln_norm": (an.adaln_norm, "launches"),
    "adaln_norm_plain_calls": (an.adaln_norm, "plain_calls"),
    "adaln_norm_plain_ops": (an.adaln_norm_plain, "ops"),
    "residual_bias": (rb.residual_bias, "launches"),
    "residual_bias_plain_calls": (rb.residual_bias, "plain_calls"),
}


def launch_counts() -> Dict[str, int]:
    """Every counter of ``COUNTERS`` by its key."""
    return {key: getattr(fn, attr) for key, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


@contextlib.contextmanager
def plain_kernels():
    """Route the UNet's GroupNorm, attention and the ResnetBlock's residual
    with its conv biases through their plain versions; restores the kernels
    on exit."""
    saved = group_norm.fused_group_norm, attention.flash_attention, rb.residual_bias
    group_norm.fused_group_norm = lambda x, s, b, **kw: gn_kernels.group_norm_plain(x, s, b, **kw)
    attention.flash_attention = lambda q, k, v, scale=None: attention.attention_plain(
        q, k, v, scale=scale)
    rb.residual_bias = lambda x, h, bias, bias2=None: rb.residual_bias_plain(x, h, bias, bias2)
    try:
        yield
    finally:
        group_norm.fused_group_norm, attention.flash_attention, rb.residual_bias = saved


def record_calls(run: Callable[[], object]) -> dict:
    """Run ``run()`` with GroupNorm and attention routed through their plain
    versions (so on the meta device: no data, no kernels) and record every
    call by shape: ``{"group_norm": {(S, C, G, act, itemsize): calls},
    "group_norm_addend": {(S, C, G, act, itemsize): calls}`` (those of the
    GroupNorm calls that take an addend), ``"attention": {(S_q, S_kv, H, D,
    itemsize): calls}, "single_head_attention": calls}``.
    ``gn_kernels.gn_route`` and ``attention.takes_kernel`` say which kernel
    (or route) each call takes on the card."""
    gn, addend, attn = collections.Counter(), collections.Counter(), collections.Counter()
    single = attention.single_head_attention.calls
    with plain_kernels():
        plain_gn, plain_attn = group_norm.fused_group_norm, attention.attention_plain

        def record_gn(x, scale, bias, **kw):
            key = (x.shape[1], x.shape[2], kw["num_groups"], kw["act"], x.element_size())
            gn[key] += 1
            addend[key] += kw.get("addend") is not None
            return plain_gn(x, scale, bias, **kw)

        def record_attn(q, k, v, scale=None):
            attn[(q.shape[1], k.shape[1], q.shape[2], q.shape[3], q.element_size())] += 1
            return plain_attn(q, k, v, scale=scale)

        group_norm.fused_group_norm = record_gn
        attention.attention_plain = attention.flash_attention = record_attn
        try:
            run()
        finally:
            attention.attention_plain = plain_attn
    return {"group_norm": dict(gn), "group_norm_addend": {k: n for k, n in addend.items() if n},
            "attention": dict(attn),
            "single_head_attention": attention.single_head_attention.calls - single}
