"""Plain float32 reference of the benchmark's models.

A frozen copy of the port's ``CondUNet2D`` (PhenDiff's pixel DDIM
denoiser), ``SDUNet`` (SD-2.1's UNet2DConditionModel) and ``AutoencoderKL``
(SD's VAE), written in plain PyTorch: NHWC tensors, convolutions and
products through ``torch.nn.functional``, GroupNorm by its definition,
attention as softmax(q k^T / sqrt(D)) v in full.  Parameter names and
shapes are the port's, so one state dict loads into either side.

Every product goes through an ``Arith``: the plain one computes in the
tensors' own dtype (float32 with TF32 off, which the caller sets);
``lowp.Fp8Arith`` rounds the operands to fp8 first (the control), and
``Recorder`` lists the GroupNorm and attention calls by shape (run on the
meta device for the work counts).

This module imports nothing of the package under test.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Arith:
    """The arithmetic of the reference's products and normalisations."""

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def conv(self, x, w, b, stride: int = 1, padding: int = 0):
        """NHWC ``x``, [out, in, kh, kw] ``w``."""
        y = F.conv2d(self.operand(x.permute(0, 3, 1, 2)), self.operand(w), b, stride, padding)
        return y.permute(0, 2, 3, 1)

    def linear(self, x, w, b=None):
        return F.linear(self.operand(x), self.operand(w), b)

    def attention(self, q, k, v):
        """[B, S, H, D] q, [B, S_kv, H, D] k and v -> [B, S, H, D]."""
        scores = torch.einsum("bqhd,bkhd->bhqk", self.operand(q), self.operand(k))
        probs = torch.softmax(scores * q.shape[-1] ** -0.5, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", self.operand(probs), self.operand(v))

    def group_norm(self, x, groups: int, eps: float, scale, bias, silu: bool):
        """NHWC ``x``: per-(sample, group) mean and variance over H, W and the
        group's channels."""
        b, h, w, c = x.shape
        g = x.reshape(b, h * w, groups, c // groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((g - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c) * scale + bias
        return F.silu(y) if silu else y


class Recorder(Arith):
    """``Arith`` that counts GroupNorm calls by (S, C) and self-attention
    calls by (S, H, D); cross-attention (S_kv != S) by (S, S_kv, H, D)."""

    def __init__(self):
        self.group_norm_calls = collections.Counter()
        self.attention_calls = collections.Counter()
        self.cross_attention_calls = collections.Counter()

    def attention(self, q, k, v):
        if q.shape[1] == k.shape[1]:
            self.attention_calls[(q.shape[1], q.shape[2], q.shape[3])] += q.shape[0]
        else:
            self.cross_attention_calls[(q.shape[1], k.shape[1], q.shape[2], q.shape[3])] += \
                q.shape[0]
        return super().attention(q, k, v)

    def group_norm(self, x, groups, eps, scale, bias, silu):
        b, h, w, c = x.shape
        self.group_norm_calls[(h * w, c)] += b
        return super().group_norm(x, groups, eps, scale, bias, silu)


def num_groups(channels: int, preferred: int) -> int:
    """Largest divisor of ``channels`` that is <= ``preferred``."""
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, freq_shift: float):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)] if flip_sin_to_cos
                    else [torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.weight, self.bias = _param(cout, cin, k, k), _param(cout)
        self.stride, self.padding = stride, padding

    def forward(self, ar: Arith, x):
        return ar.conv(x, self.weight, self.bias, self.stride, self.padding)


class Dense(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = _param(cout, cin)
        self.bias = _param(cout) if bias else None

    def forward(self, ar: Arith, x):
        return ar.linear(x, self.weight, self.bias)


class TimeMLP(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1, self.linear_2 = Dense(cin, dim), Dense(dim, dim)

    def forward(self, ar, emb):
        return self.linear_2(ar, F.silu(self.linear_1(ar, emb)))


def _norm(module: nn.Module, prefix: str, channels: int):
    """A GroupNorm's affine parameters, named as the port names them."""
    setattr(module, f"{prefix}_scale", _param(channels))
    setattr(module, f"{prefix}_bias", _param(channels))


def _gn(ar, module, prefix, x, groups, eps, silu):
    return ar.group_norm(x, groups, eps, getattr(module, f"{prefix}_scale"),
                         getattr(module, f"{prefix}_bias"), silu)


class ResnetBlock(nn.Module):
    """GroupNorm-SiLU-conv, + time embedding, GroupNorm-SiLU-conv, + skip."""

    def __init__(self, cin, cout, temb_dim, groups, eps):
        super().__init__()
        self.g1, self.g2, self.eps = num_groups(cin, groups), num_groups(cout, groups), eps
        _norm(self, "norm1", cin)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = Dense(temb_dim, cout)
        _norm(self, "norm2", cout)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, ar, x, temb):
        h = self.conv1(ar, _gn(ar, self, "norm1", x, self.g1, self.eps, True))
        h = h + self.time_emb_proj(ar, F.silu(temb))[:, None, None, :]
        h = self.conv2(ar, _gn(ar, self, "norm2", h, self.g2, self.eps, True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(ar, x)
        return x + h


def _heads(x, heads):
    return x.unflatten(-1, (heads, x.shape[-1] // heads))


class SelfAttention2D(nn.Module):
    """The pixel UNet's attention block: one fused qkv projection."""

    def __init__(self, c, head_dim, groups, eps):
        super().__init__()
        self.heads = max(c // (head_dim or c), 1)
        self.groups, self.eps = num_groups(c, groups), eps
        _norm(self, "norm", c)
        self.qkv, self.proj_out = Dense(c, 3 * c), Dense(c, c)

    def forward(self, ar, x):
        b, hh, ww, c = x.shape
        h = _gn(ar, self, "norm", x, self.groups, self.eps, False).reshape(b, hh * ww, c)
        q, k, v = (_heads(t, self.heads) for t in self.qkv(ar, h).split(c, dim=-1))
        out = ar.attention(q, k, v).reshape(b, hh * ww, c)
        return x + self.proj_out(ar, out).reshape(b, hh, ww, c)


class Downsample(nn.Module):
    def __init__(self, c, padding=1):
        super().__init__()
        self.asymmetric = padding == 0
        self.conv = Conv(c, c, 3, stride=2, padding=padding)

    def forward(self, ar, x):
        if self.asymmetric:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(ar, x)


def upsample_nearest(x):
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


class Upsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3, padding=1)

    def forward(self, ar, x):
        return self.conv(ar, upsample_nearest(x))


class _UNetBase(nn.Module):
    """The down / mid / up skeleton both UNets share; ``attn(level, c)``
    builds a level's attention block (None where the block type has none)."""

    def _build(self, cfg: dict, in_ch: int, temb_dim: int, attn_down, attn_up, mid_attn):
        chans, layers = cfg["block_out_channels"], cfg["layers_per_block"]
        groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        self.conv_in = Conv(in_ch, chans[0], 3, padding=1)
        ch, skips = chans[0], [chans[0]]
        for i, c_out in enumerate(chans):
            for j in range(layers):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(ch, c_out, temb_dim, groups, eps))
                ch = c_out
                block = attn_down(i, ch)
                if block is not None:
                    self.add_module(f"down_{i}_attn_{j}", block)
                skips.append(ch)
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample",
                                Downsample(ch, cfg.get("downsample_padding", 1)))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock(ch, chans[-1], temb_dim, groups, eps)
        ch = chans[-1]
        self.mid_attn = mid_attn(ch)
        self.mid_res_1 = ResnetBlock(ch, ch, temb_dim, groups, eps)
        for i, c_out in enumerate(reversed(chans)):
            for j in range(layers + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock(ch + skips.pop(), c_out, temb_dim, groups, eps))
                ch = c_out
                block = attn_up(i, ch)
                if block is not None:
                    self.add_module(f"up_{i}_attn_{j}", block)
            if i < len(chans) - 1:
                self.add_module(f"up_{i}_upsample", Upsample(ch))
        _norm(self, "norm_out", ch)
        self.out_ch = ch

    def _run(self, ar, x, temb, cfg, attn_args):
        n = len(cfg["block_out_channels"])
        layers = cfg["layers_per_block"]
        x = self.conv_in(ar, x)
        skips = [x]
        for i in range(n):
            for j in range(layers):
                x = getattr(self, f"down_{i}_res_{j}")(ar, x, temb)
                if hasattr(self, f"down_{i}_attn_{j}"):
                    x = getattr(self, f"down_{i}_attn_{j}")(ar, x, *attn_args)
                skips.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(ar, x)
                skips.append(x)
        x = self.mid_res_0(ar, x, temb)
        x = self.mid_attn(ar, x, *attn_args)
        x = self.mid_res_1(ar, x, temb)
        for i in range(n):
            for j in range(layers + 1):
                x = getattr(self, f"up_{i}_res_{j}")(ar, torch.cat([x, skips.pop()], dim=-1), temb)
                if hasattr(self, f"up_{i}_attn_{j}"):
                    x = getattr(self, f"up_{i}_attn_{j}")(ar, x, *attn_args)
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(ar, x)
        return x


class CondUNet2D(_UNetBase):
    """PhenDiff's class-conditional pixel UNet (positional time embedding,
    the class row added to it)."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg.get("time_embedding_type", "positional") != "positional":
            raise ValueError("the reference has the positional time embedding only")
        if cfg.get("resnet_time_scale_shift", "default") != "default":
            raise ValueError("the reference has the default resnet time shift only")
        self.cfg = cfg
        c0 = cfg["block_out_channels"][0]
        ted = 4 * c0
        self.time_embedding = TimeMLP(c0, ted)
        self.class_embedding = nn.Module()
        self.class_embedding.weight = _param(cfg["num_class_embeds"], ted)
        groups, eps, hd = cfg["norm_num_groups"], cfg["norm_eps"], cfg["attention_head_dim"]

        def attn(types):
            return lambda i, c: (SelfAttention2D(c, hd, groups, eps)
                                 if types[i].startswith("Attn") else None)

        self._build(cfg, cfg["in_channels"], ted, attn(cfg["down_block_types"]),
                    attn(cfg["up_block_types"]), lambda c: SelfAttention2D(c, hd, groups, eps))
        self.norm_groups = num_groups(self.out_ch, groups)
        self.conv_out = Conv(self.out_ch, cfg["out_channels"], 3, padding=1)

    def embed(self, labels: torch.Tensor) -> torch.Tensor:
        return self.class_embedding.weight[labels]

    def forward(self, ar: Arith, x, t, class_emb):
        cfg = self.cfg
        temb = timestep_embedding(t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"],
                                  cfg["freq_shift"])
        temb = self.time_embedding(ar, temb) + class_emb
        x = self._run(ar, x, temb, cfg, ())
        x = _gn(ar, self, "norm_out", x, self.norm_groups, cfg["norm_eps"], True)
        return self.conv_out(ar, x)


class LayerNorm(nn.Module):
    def __init__(self, c, eps=1e-6):
        super().__init__()
        self.scale, self.bias, self.eps = _param(c), _param(c), eps

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class CrossAttention(nn.Module):
    def __init__(self, c, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q, self.to_k, self.to_v = (Dense(c, c, False), Dense(ctx_dim, c, False),
                                           Dense(ctx_dim, c, False))
        self.to_out = Dense(c, c)

    def forward(self, ar, x, ctx=None):
        ctx = x if ctx is None else ctx
        q, k, v = (_heads(lin(ar, a), self.heads) for lin, a in
                   ((self.to_q, x), (self.to_k, ctx), (self.to_v, ctx)))
        return self.to_out(ar, ar.attention(q, k, v).flatten(-2))


class GEGLU(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.proj_in, self.proj_out = Dense(c, 8 * c), Dense(4 * c, c)

    def forward(self, ar, x):
        h, gate = self.proj_in(ar, x).chunk(2, dim=-1)
        return self.proj_out(ar, h * F.gelu(gate, approximate="tanh"))


class TransformerBlock(nn.Module):
    def __init__(self, c, ctx_dim, heads):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = LayerNorm(c), LayerNorm(c), LayerNorm(c)
        self.attn1 = CrossAttention(c, c, heads)
        self.attn2 = CrossAttention(c, ctx_dim, heads)
        self.ff = GEGLU(c)

    def forward(self, ar, x, ctx):
        x = x + self.attn1(ar, self.norm1(x))
        x = x + self.attn2(ar, self.norm2(x), ctx)
        return x + self.ff(ar, self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm (eps 1e-6) -> linear proj_in -> transformer block ->
    proj_out, + the input."""

    def __init__(self, c, ctx_dim, heads, groups):
        super().__init__()
        self.groups = groups
        _norm(self, "norm", c)
        self.proj_in = Dense(c, c)
        self.block_0 = TransformerBlock(c, ctx_dim, heads)
        self.proj_out = Dense(c, c)

    def forward(self, ar, x, ctx):
        b, hh, ww, c = x.shape
        h = _gn(ar, self, "norm", x, self.groups, 1e-6, False).reshape(b, hh * ww, c)
        h = self.proj_out(ar, self.block_0(ar, self.proj_in(ar, h), ctx))
        return x + h.reshape(b, hh, ww, c)


class SDUNet(_UNetBase):
    """SD-2.1's UNet2DConditionModel with linear projections, heads per
    level, GEGLU and a (B, 77, cross_attention_dim) context."""

    def __init__(self, cfg: dict):
        super().__init__()
        if not cfg.get("use_linear_projection", True):
            raise ValueError("the reference has SD-2.1's linear projections only")
        self.cfg = cfg
        c0 = cfg["block_out_channels"][0]
        heads = cfg["attention_head_dim"]
        heads = [heads] * len(cfg["block_out_channels"]) if isinstance(heads, int) else heads
        ctx, groups, n = cfg["cross_attention_dim"], cfg["norm_num_groups"], \
            len(cfg["block_out_channels"])
        self.time_embedding = TimeMLP(c0, 4 * c0)

        def xfmr(types, level_of):
            return lambda i, c: (Transformer2D(c, ctx, heads[level_of(i)], groups)
                                 if types[i].startswith("CrossAttn") else None)

        self._build(cfg, cfg["in_channels"], 4 * c0,
                    xfmr(cfg["down_block_types"], lambda i: i),
                    xfmr(cfg["up_block_types"], lambda i: n - 1 - i),
                    lambda c: Transformer2D(c, ctx, heads[n - 1], groups))
        self.conv_out = Conv(self.out_ch, cfg["out_channels"], 3, padding=1)

    def forward(self, ar: Arith, x, t, ctx):
        cfg = self.cfg
        temb = self.time_embedding(ar, timestep_embedding(
            t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], cfg["freq_shift"]))
        x = self._run(ar, x, temb, cfg, (ctx,))
        x = _gn(ar, self, "norm_out", x, cfg["norm_num_groups"], cfg["norm_eps"], True)
        return self.conv_out(ar, x)


class ClassEmbedding(nn.Module):
    """The SD fine-tune's class table, held as ``embedding.weight``."""

    def __init__(self, num_classes: int, dim: int):
        super().__init__()
        self.embedding = nn.Module()
        self.embedding.weight = _param(num_classes, dim)

    def sequence(self, labels: torch.Tensor, seq_len: int = 77) -> torch.Tensor:
        """(B,) labels -> (B, seq_len, D): the row in slot 0, zeros elsewhere."""
        row = self.embedding.weight[labels]
        return torch.cat([row[:, None], row.new_zeros(row.shape[0], seq_len - 1,
                                                      row.shape[1])], dim=1)


VAE_EPS = 1e-6


class VAEResnet(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.groups = groups
        _norm(self, "norm1", cin)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        _norm(self, "norm2", cout)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, ar, x):
        h = self.conv1(ar, _gn(ar, self, "norm1", x, self.groups, VAE_EPS, True))
        h = self.conv2(ar, _gn(ar, self, "norm2", h, self.groups, VAE_EPS, True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(ar, x)
        return x + h


class VAEAttention(nn.Module):
    """One head of D = C over the H*W tokens."""

    def __init__(self, c, groups):
        super().__init__()
        self.groups = groups
        _norm(self, "norm", c)
        self.to_q, self.to_k, self.to_v, self.to_out = (Dense(c, c) for _ in range(4))

    def forward(self, ar, x):
        b, hh, ww, c = x.shape
        h = _gn(ar, self, "norm", x, self.groups, VAE_EPS, False).reshape(b, hh * ww, c)
        q, k, v = (lin(ar, h)[:, :, None, :] for lin in (self.to_q, self.to_k, self.to_v))
        out = ar.attention(q, k, v)[:, :, 0, :]
        return x + self.to_out(ar, out).reshape(b, hh, ww, c)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        chans, g = cfg["block_out_channels"], cfg["norm_num_groups"]
        self.conv_in = Conv(cfg["in_channels"], chans[0], 3, padding=1)
        ch = chans[0]
        for i, c_out in enumerate(chans):
            for j in range(cfg["layers_per_block"]):
                self.add_module(f"down_{i}_res_{j}", VAEResnet(ch, c_out, g))
                ch = c_out
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, 3, stride=2))
        self.mid_res_0, self.mid_attn, self.mid_res_1 = (VAEResnet(ch, ch, g),
                                                         VAEAttention(ch, g), VAEResnet(ch, ch, g))
        _norm(self, "norm_out", ch)
        self.conv_out = Conv(ch, 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, ar, x):
        cfg, n = self.cfg, len(self.cfg["block_out_channels"])
        x = self.conv_in(ar, x)
        for i in range(n):
            for j in range(cfg["layers_per_block"]):
                x = getattr(self, f"down_{i}_res_{j}")(ar, x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(ar, F.pad(x, (0, 0, 0, 1, 0, 1)))
        x = self.mid_res_1(ar, self.mid_attn(ar, self.mid_res_0(ar, x)))
        x = _gn(ar, self, "norm_out", x, cfg["norm_num_groups"], VAE_EPS, True)
        return self.conv_out(ar, x)


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        rev, g = list(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"]
        self.conv_in = Conv(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_res_0, self.mid_attn, self.mid_res_1 = (VAEResnet(rev[0], rev[0], g),
                                                         VAEAttention(rev[0], g),
                                                         VAEResnet(rev[0], rev[0], g))
        ch = rev[0]
        for i, c_out in enumerate(rev):
            for j in range(cfg["layers_per_block"] + 1):
                self.add_module(f"up_{i}_res_{j}", VAEResnet(ch, c_out, g))
                ch = c_out
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, padding=1))
        _norm(self, "norm_out", ch)
        self.conv_out = Conv(ch, cfg["out_channels"], 3, padding=1)

    def forward(self, ar, z):
        cfg, n = self.cfg, len(self.cfg["block_out_channels"])
        x = self.mid_res_1(ar, self.mid_attn(ar, self.mid_res_0(ar, self.conv_in(ar, z))))
        for i in range(n):
            for j in range(cfg["layers_per_block"] + 1):
                x = getattr(self, f"up_{i}_res_{j}")(ar, x)
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(ar, upsample_nearest(x))
        x = _gn(ar, self, "norm_out", x, cfg["norm_num_groups"], VAE_EPS, True)
        return self.conv_out(ar, x)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        lat = cfg["latent_channels"]
        self.encoder, self.decoder = Encoder(cfg), Decoder(cfg)
        self.quant_conv, self.post_quant_conv = Conv(2 * lat, 2 * lat, 1), Conv(lat, lat, 1)

    def encode_to_latents(self, ar: Arith, images, noise: Optional[torch.Tensor] = None):
        """[-1, 1] NHWC images -> scaled latents: the posterior's mean, or
        its sample with the standard-normal ``noise``."""
        mean, logvar = self.quant_conv(ar, self.encoder(ar, images)).chunk(2, dim=-1)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        return mean * self.cfg["scaling_factor"]

    def decode_from_latents(self, ar: Arith, latents):
        z = latents / self.cfg["scaling_factor"]
        return self.decoder(ar, self.post_quant_conv(ar, z))


def parameter_kinds(module: nn.Module) -> dict:
    """name -> (kind, fan_in) for every parameter: ``kernel`` (conv and
    dense weights), ``bias``, ``scale`` (norm scales), ``shift`` (norm
    biases), ``table`` (embedding rows)."""
    kinds = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(m, (Conv, Dense)):
                fan_in = p[0].numel() if pname == "weight" else 0
                kinds[name] = ("kernel", fan_in) if pname == "weight" else ("bias", 0)
            elif pname.endswith("scale"):
                kinds[name] = ("scale", 0)
            elif pname.endswith("bias"):
                kinds[name] = ("shift", 0)
            elif pname == "weight":
                kinds[name] = ("table", p.shape[-1])
            else:
                raise ValueError(f"no initialiser for {name}")
    return kinds


def names_shapes(module: nn.Module) -> Sequence:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]
