"""Conditional UNet2D denoiser in PyTorch.

Counterpart of ``phendiff_tpu/models/unet2d.py`` on its unpacked path: a
DDPM-style UNet whose class conditioning is added to the timestep
embedding, taking either integer ``class_labels`` (embedded internally) or
a precomputed ``class_emb`` (the CFG unconditional pass feeds zeros).

* The public layout is the JAX package's: ``sample`` is NHWC in [-1, 1].
  Activations stay NHWC-contiguous tensors throughout, so every
  convolution runs on a ``torch.channels_last`` view, a GroupNorm input is
  already a [B, H*W, C] view, and the attention reshape copies nothing.
* Submodules are named after the Flax scopes (``down_{i}_res_{j}``,
  ``mid_attn``, ``up_{i}_upsample``, ...), so ``models/convert.py`` maps a
  Flax checkpoint by renaming and transposing only.
* ``dtype`` is the compute dtype: the input is cast to it, conv and linear
  weights are used in it, GroupNorm statistics are float32, and the output
  is cast back to the input's dtype.
* ``remat=True`` recomputes each resnet and attention block in the
  backward (``checkpointed``), as the JAX model's ``nn.remat`` does; the
  parameter names do not change.
* Under tensor parallelism (``parallel/tp.py::shard_module``) a block
  marked with a ``tp`` shard runs on this rank's channels or heads, with
  the shards ``functional_call`` hands in; an unmarked block runs whole.
* Where no autograd records and no shard is marked, a ResnetBlock's conv
  biases ride in the next hand-written kernel that reads each conv's output
  (``ResnetBlock``): the same sums, rounded at other places.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.embeddings import (
    Dense,
    GaussianFourierProjection,
    TimestepEmbedMLP,
    sinusoidal_timestep_embedding,
)
from phendiff_tpu_torch.ops import residual_bias as RB
from phendiff_tpu_torch.ops.attention import multi_head_attention
from phendiff_tpu_torch.ops.gn_kernels import _records
from phendiff_tpu_torch.ops.group_norm import group_norm
from phendiff_tpu_torch.parallel import tp as TP


def _num_groups(channels: int, preferred: int) -> int:
    """Largest divisor of ``channels`` that is <= preferred."""
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


class Conv(nn.Conv2d):
    """``nn.Conv2d`` over NHWC tensors, in the input's dtype.

    The NHWC tensor is handed to cuDNN as a channels_last NCHW view and the
    result comes back the same way, so no layout copy is made.  ``bias=False``
    leaves the bias out, for a ``ResnetBlock`` that adds it in the next
    kernel that reads the output."""

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        y = F.conv2d(
            x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
            self.bias.to(x.dtype) if bias else None, self.stride, self.padding,
        )
        return y.permute(0, 2, 3, 1)


def checkpointed(module: nn.Module, *args):
    """``module(*args)``, its activations recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``).

    The block's parameters go in as explicit inputs and are rebound for the
    recompute, so a model called through ``functional_call`` recomputes
    with the tensors it was called with, not with the module's own (by then
    restored, and for a model built on the meta device, empty) ones.  The
    reentrant form would run the forward under ``no_grad``, where the
    attention kernel saves no log-sum-exp for its backward."""
    names, tensors = zip(*module.named_parameters())
    n = len(args)

    def run(*inputs):
        return functional_call(module, dict(zip(names, inputs[n:])), inputs[:n])

    # the blocks draw no random numbers: no RNG state to restore
    return checkpoint(run, *args, *tensors, use_reentrant=False, preserve_rng_state=False)


def run_block(model: nn.Module, name: str, *args) -> torch.Tensor:
    """``model``'s resnet or attention block ``name`` on ``args``,
    recomputed in the backward when ``model.remat`` is set."""
    module = getattr(model, name)
    if model.remat and torch.is_grad_enabled():
        return checkpointed(module, *args)
    return module(*args)


def _norm_params(channels: int):
    return nn.Parameter(torch.ones(channels)), nn.Parameter(torch.zeros(channels))


@torch.no_grad()
def init_flax_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisers, drawn from ``generator`` module by module:
    truncated lecun-normal conv and dense kernels, zero biases, unit norm
    scales, N(0, 1/dim) embedding tables, N(0, 16^2) Fourier weights.  Draws
    on the generator's device, then copies to each parameter's device."""
    dev = generator.device

    def trunc_normal(t: torch.Tensor, std: float):
        # variance_scaling(1, fan_in, truncated_normal): std / .8796 over +-2 std
        w = torch.empty(t.shape, dtype=torch.float32, device=dev)
        s = std / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, s, -2 * s, 2 * s, generator=generator)
        t.copy_(w)

    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            trunc_normal(m.weight, 1.0 / math.sqrt(fan_in))
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            trunc_normal(m.weight, 1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            w = torch.randn(m.weight.shape, generator=generator, device=dev)
            m.weight.copy_(w / math.sqrt(m.embedding_dim))
        elif isinstance(m, GaussianFourierProjection):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator, device=dev) * m.scale)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("scale"):  # GroupNorm *_scale, LayerNorm scale
            p.fill_(1.0)
        elif leaf.endswith("bias"):
            p.zero_()
    return module


class ResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> conv3x3 -> (+temb) -> GroupNorm -> SiLU -> conv3x3 + skip.

    Where no autograd records through the call and no tensor parallelism
    shards it, each conv's bias rides in the next hand-written kernel that
    reads the conv's output, so no broadcast pass adds it: conv1's joins the
    time embedding in the second GroupNorm's addend (``"default"`` time
    embedding only), and conv2's and the shortcut's go to the residual
    (``ops/residual_bias.py``), where its ``refusal`` is empty.  Elsewhere
    (training, an input gradient, shards) the convs add their own biases, as
    before.
    """

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, *,
                 norm_num_groups: int = 32, norm_eps: float = 1e-5,
                 time_scale_shift: str = "default"):
        super().__init__()
        if time_scale_shift not in ("default", "scale_shift"):
            raise ValueError(f"unknown resnet_time_scale_shift: {time_scale_shift}")
        self.groups1 = _num_groups(in_channels, norm_num_groups)
        self.groups2 = _num_groups(out_channels, norm_num_groups)
        self.eps = norm_eps
        self.time_scale_shift = time_scale_shift
        self.norm1_scale, self.norm1_bias = _norm_params(in_channels)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        tdim = 2 * out_channels if time_scale_shift == "scale_shift" else out_channels
        self.time_emb_proj = Dense(temb_dim, tdim)
        self.norm2_scale, self.norm2_bias = _norm_params(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            Conv(in_channels, out_channels, 1) if in_channels != out_channels else None
        )
        self.tp: Optional[TP.Shard] = None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        dt, tp = x.dtype, self.tp
        defer = tp is None and not _records(x, temb, *self.parameters())
        fold1 = defer and self.time_scale_shift == "default"
        h = group_norm(x, num_groups=self.groups1, eps=self.eps, scale=self.norm1_scale,
                       bias=self.norm1_bias, act="silu", out_dtype=dt)
        t = self.time_emb_proj(F.silu(temb))
        if tp is None:
            h = self.conv1(h, bias=not fold1)
            norm2 = dict(num_groups=self.groups2, eps=self.eps, scale=self.norm2_scale,
                         bias=self.norm2_bias, out_dtype=dt)
        else:  # conv1 column-parallel: this rank's channels, their groups
            h = TP.column_conv(tp, h, self.conv1)
            t = tp.slice(t, parts=2 if self.time_scale_shift == "scale_shift" else 1)
            norm2 = dict(num_groups=self.groups2 // tp.size, eps=self.eps,
                         scale=tp.slice(self.norm2_scale), bias=tp.slice(self.norm2_bias),
                         out_dtype=dt)
        if self.time_scale_shift == "scale_shift":
            scale, shift = t[:, None, None, :].chunk(2, dim=-1)
            h = group_norm(h, **norm2)
            h = F.silu(h * (1 + scale) + shift)
        else:  # group_norm(h + t): the kernel adds t as it loads h where it can
            if fold1:
                t = t + self.conv1.bias.to(dt)
            h = group_norm(h, addend=t, act="silu", **norm2)
        sc = self.conv_shortcut
        if defer:
            biases = (self.conv2.bias.to(dt),) + (() if sc is None else (sc.bias.to(dt),))
            # conv2's output, and the shortcut's, have h's shape, dtype, device and layout
            if RB.refusal(x if sc is None else h, h, *biases) is None:
                skip = x if sc is None else sc(x, bias=False)
                return RB.residual_bias(skip, self.conv2(h, bias=False), *biases)
        h = self.conv2(h) if tp is None else TP.row_conv(h, self.conv2)
        if sc is not None:
            x = sc(x)
        return x + h


class SelfAttention2D(nn.Module):
    """Spatial self-attention over the H*W token axis of an NHWC map."""

    def __init__(self, channels: int, attention_head_dim: Optional[int], *,
                 norm_num_groups: int = 32, norm_eps: float = 1e-5):
        super().__init__()
        # attention_head_dim is the per-head width; None -> one head over all
        head_dim = attention_head_dim or channels
        self.num_heads = max(channels // head_dim, 1)
        self.head_dim = channels // self.num_heads
        self.groups = _num_groups(channels, norm_num_groups)
        self.eps = norm_eps
        self.norm_scale, self.norm_bias = _norm_params(channels)
        self.qkv = Dense(channels, 3 * channels)
        self.proj_out = Dense(channels, channels)
        self.tp: Optional[TP.Shard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hgt, wid, c = x.shape
        tp = self.tp
        h = group_norm(x, num_groups=self.groups, eps=self.eps, scale=self.norm_scale,
                       bias=self.norm_bias, out_dtype=x.dtype).reshape(b, hgt * wid, c)
        # this rank's heads of q, k and v (parallel/tp.py: per-head slices)
        heads, cl = (self.num_heads, c) if tp is None else (self.num_heads // tp.size, c // tp.size)
        qkv = self.qkv(h) if tp is None else TP.column_linear(tp, h, self.qkv, parts=3)
        # column slices of the fused projection, viewed as [B, S, H, D]
        q, k, v = (t.unflatten(-1, (heads, self.head_dim)) for t in qkv.split(cl, dim=-1))
        attn = multi_head_attention(q, k, v).reshape(b, hgt * wid, cl)
        out = self.proj_out(attn) if tp is None else TP.row_linear(attn, self.proj_out)
        return x + out.reshape(b, hgt, wid, c)


def conv_maybe_sharded(tp: Optional[TP.Shard], x: torch.Tensor, conv: Conv) -> torch.Tensor:
    """``conv(x)``; under tensor parallelism this rank's output channels,
    gathered to the full width the next layer reads."""
    return conv(x) if tp is None else TP.gather_channels(TP.column_conv(tp, x, conv))


class Downsample2D(nn.Module):
    """Stride-2 conv downsample; ``padding=0`` pads (0, 1) x (0, 1) first,
    as the reference stack does for ``downsample_padding=0``."""

    def __init__(self, channels: int, padding: int = 1):
        super().__init__()
        self.pad_asymmetric = padding == 0
        self.conv = Conv(channels, channels, 3, stride=2, padding=padding)
        self.tp: Optional[TP.Shard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_asymmetric:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return conv_maybe_sharded(self.tp, x, self.conv)


class Upsample2D(nn.Module):
    """2x nearest upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)
        self.tp: Optional[TP.Shard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
        return conv_maybe_sharded(self.tp, x, self.conv)


class CondUNet2D(nn.Module):
    """Class-conditional pixel-space UNet (the DDIM model family's denoiser)."""

    def __init__(self, config: UNet2DConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = remat
        c0, ted = cfg.block_out_channels[0], cfg.time_embed_dim
        if cfg.time_embedding_type == "fourier":
            self.time_proj = GaussianFourierProjection(embedding_size=c0)
            temb_in = 2 * c0
        else:
            self.time_proj = None
            temb_in = c0
        self.time_embedding = TimestepEmbedMLP(temb_in, ted)
        self.class_embedding = (
            nn.Embedding(cfg.num_class_embeds, ted)
            if cfg.num_class_embeds is not None else None
        )

        def res(cin, cout):
            return ResnetBlock(cin, cout, ted, norm_num_groups=cfg.norm_num_groups,
                               norm_eps=cfg.norm_eps,
                               time_scale_shift=cfg.resnet_time_scale_shift)

        def attn(c):
            return SelfAttention2D(c, cfg.attention_head_dim,
                                   norm_num_groups=cfg.norm_num_groups,
                                   norm_eps=cfg.norm_eps)

        n_levels = len(cfg.block_out_channels)
        self.conv_in = Conv(cfg.in_channels, c0, 3, padding=1)
        ch = c0
        skip_channels = [ch]
        for i, (btype, c_out) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", res(ch, c_out))
                ch = c_out
                if btype == "AttnDownBlock2D":
                    self.add_module(f"down_{i}_attn_{j}", attn(ch))
                skip_channels.append(ch)
            if i < n_levels - 1:
                self.add_module(f"down_{i}_downsample",
                                Downsample2D(ch, padding=cfg.downsample_padding))
                skip_channels.append(ch)

        self.mid_res_0 = res(ch, cfg.block_out_channels[-1])
        ch = cfg.block_out_channels[-1]
        self.mid_attn = attn(ch)
        self.mid_res_1 = res(ch, ch)

        rev_channels = tuple(reversed(cfg.block_out_channels))
        for i, (btype, c_out) in enumerate(zip(cfg.up_block_types, rev_channels)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", res(ch + skip_channels.pop(), c_out))
                ch = c_out
                if btype == "AttnUpBlock2D":
                    self.add_module(f"up_{i}_attn_{j}", attn(ch))
            if i < n_levels - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(ch))
        assert not skip_channels

        self.norm_out_groups = _num_groups(ch, cfg.norm_num_groups)
        self.norm_out_scale, self.norm_out_bias = _norm_params(ch)
        self.conv_out = Conv(ch, cfg.out_channels, 3, padding=1)
        self.tp_conv_in: Optional[TP.Shard] = None
        self.to(memory_format=torch.channels_last)

    def init_weights(self, generator: torch.Generator) -> "CondUNet2D":
        """Flax's default initialisers, drawn from ``generator``
        (``init_flax_weights``)."""
        return init_flax_weights(self, generator)

    def forward(
        self,
        sample: torch.Tensor,  # [B, H, W, C] in [-1, 1]
        timesteps,  # int, 0-d or [B] integer tensor
        class_labels: Optional[torch.Tensor] = None,  # [B] int
        class_emb: Optional[torch.Tensor] = None,  # [B, time_embed_dim]
    ) -> torch.Tensor:
        cfg = self.config
        dt = self.dtype
        x = sample.to(dt)
        if cfg.center_input_sample:
            x = 2.0 * x - 1.0

        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])

        # --- time embedding -------------------------------------------------
        if self.time_proj is not None:
            temb = self.time_proj(timesteps)
        else:
            temb = sinusoidal_timestep_embedding(
                timesteps, cfg.block_out_channels[0],
                flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
            )
        temb = self.time_embedding(temb.to(dt))

        # --- class conditioning: summed with the time embedding -------------
        if class_emb is not None:
            temb = temb + class_emb.to(dt)
        elif class_labels is not None:
            if self.class_embedding is None:
                raise ValueError("model is unconditional: no num_class_embeds")
            temb = temb + self.class_embedding(class_labels).to(dt)
        elif cfg.num_class_embeds is not None:
            raise ValueError("conditional model requires class_labels or class_emb")

        # --- down path ------------------------------------------------------
        n_levels = len(cfg.block_out_channels)
        x = conv_maybe_sharded(self.tp_conv_in, x, self.conv_in)
        skips = [x]
        for i, btype in enumerate(cfg.down_block_types):
            for j in range(cfg.layers_per_block):
                x = run_block(self, f"down_{i}_res_{j}", x, temb)
                if btype == "AttnDownBlock2D":
                    x = run_block(self, f"down_{i}_attn_{j}", x)
                skips.append(x)
            if i < n_levels - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)

        # --- mid ------------------------------------------------------------
        x = run_block(self, "mid_res_0", x, temb)
        x = run_block(self, "mid_attn", x)
        x = run_block(self, "mid_res_1", x, temb)
        if cfg.mid_block_scale_factor != 1.0:
            x = x * cfg.mid_block_scale_factor

        # --- up path --------------------------------------------------------
        for i, btype in enumerate(cfg.up_block_types):
            for j in range(cfg.layers_per_block + 1):
                x = torch.cat([x, skips.pop().to(dt)], dim=-1)
                x = run_block(self, f"up_{i}_res_{j}", x, temb)
                if btype == "AttnUpBlock2D":
                    x = run_block(self, f"up_{i}_attn_{j}", x)
            if i < n_levels - 1:
                x = getattr(self, f"up_{i}_upsample")(x)

        # --- out ------------------------------------------------------------
        x = group_norm(x, num_groups=self.norm_out_groups, eps=cfg.norm_eps,
                       scale=self.norm_out_scale, bias=self.norm_out_bias,
                       act="silu", out_dtype=dt)
        x = self.conv_out(x)
        return x.to(sample.dtype)
