"""UNet2DCondition (the SD-2.1 layout) in PyTorch.

Counterpart of ``phendiff_tpu/models/sd_unet.py``: CrossAttn down/up blocks
whose Transformer2D inner blocks attend to a (B, 77, cross_attention_dim)
conditioning sequence (the class embedding padded to the CLIP text
encoder's output shape, ``embeddings.pad_to_clip_sequence``), GEGLU
feed-forward, linear projections and per-level head counts.

* The public layout is NHWC, as in ``unet2d.py``; the ResnetBlock,
  Downsample2D, Upsample2D and time-embedding MLP are that module's.
* Submodules carry the Flax scope names (``down_{i}_attn_{j}.block_0.attn1
  .to_q``, ``mid_attn.norm_scale``, ...), so ``models/convert.py`` maps a
  Flax checkpoint by renaming and transposing only.
* Self-attention (S_q = S_kv, heads of 64 in SD-2.1) goes to the fused
  attention kernel through ``ops.attention.multi_head_attention``;
  cross-attention (S_kv = 77) takes its ``attention_plain`` route, as the
  JAX package sends it to XLA.
* ``remat=True`` recomputes each resnet and Transformer2D block in the
  backward (``unet2d.run_block``), as the JAX model's ``nn.remat`` does.
* Hazards of the reference kept: the GEGLU gate is Flax's ``nn.gelu``, the
  tanh approximation; the transformer block's LayerNorms are Flax's, eps
  1e-6, computed in float32; Transformer2D's GroupNorm has eps 1e-6 and no
  activation.  ``upcast_attention`` is carried through the config only: the
  reference reads it nowhere, its softmax is always float32.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from phendiff_tpu_torch.models.embeddings import Dense, TimestepEmbedMLP, sinusoidal_timestep_embedding
from phendiff_tpu_torch.models.unet2d import (
    Conv,
    Downsample2D,
    ResnetBlock,
    Upsample2D,
    _norm_params,
    init_flax_weights,
    run_block,
)
from phendiff_tpu_torch.ops.attention import multi_head_attention
from phendiff_tpu_torch.ops.group_norm import group_norm

SD_DOWN_BLOCK_TYPES = ("DownBlock2D", "CrossAttnDownBlock2D")
SD_UP_BLOCK_TYPES = ("UpBlock2D", "CrossAttnUpBlock2D")


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    sample_size: int = 96
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # heads per level (SD-2.1: [5, 10, 20, 20] -> head width 64 everywhere)
    attention_head_dim: Union[int, Tuple[int, ...]] = (5, 10, 20, 20)
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    use_linear_projection: bool = True
    upcast_attention: bool = True
    downsample_padding: int = 1

    def __post_init__(self):
        n = len(self.block_out_channels)
        if len(self.down_block_types) != n or len(self.up_block_types) != n:
            raise ValueError("block types and block_out_channels length mismatch")
        for t in self.down_block_types:
            if t not in SD_DOWN_BLOCK_TYPES:
                raise ValueError(f"unknown down block type: {t}")
        for t in self.up_block_types:
            if t not in SD_UP_BLOCK_TYPES:
                raise ValueError(f"unknown up block type: {t}")

    def heads_at(self, level: int) -> int:
        a = self.attention_head_dim
        return a if isinstance(a, int) else a[level]

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    _JSON_IGNORED = (
        "_class_name", "_diffusers_version", "_name_or_path", "act_fn",
        "center_input_sample", "mid_block_scale_factor", "dual_cross_attention",
        "mid_block_type", "only_cross_attention", "num_class_embeds",
        "class_embed_type", "addition_embed_type", "resnet_time_scale_shift",
        "projection_class_embeddings_input_dim", "conv_in_kernel",
        "conv_out_kernel", "time_embedding_type", "timestep_post_act",
        "time_cond_proj_dim", "attention_type", "addition_time_embed_dim",
        "addition_embed_type_num_heads", "cross_attention_norm",
        "encoder_hid_dim", "encoder_hid_dim_type", "class_embeddings_concat",
        "mid_block_only_cross_attention", "num_attention_heads",
        "reverse_transformer_layers_per_block", "transformer_layers_per_block",
        "dropout", "time_embedding_dim", "time_embedding_act_fn",
    )

    @classmethod
    def from_json(cls, path_or_dict) -> "SDUNetConfig":
        """A config from a diffusers-format JSON file or dict; keys of
        diffusers' UNet2DConditionModel this architecture does not read are
        ignored, any other unknown key raises."""
        raw = path_or_dict
        if not isinstance(raw, dict):
            with open(raw) as f:
                raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in raw.items():
            if k in cls._JSON_IGNORED:
                continue
            if k not in known:
                raise ValueError(f"unsupported SD UNet config key: {k}")
            kwargs[k] = tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in list(d.items()):
            if isinstance(v, tuple):
                d[k] = list(v)
        d["_class_name"] = "UNet2DConditionModel"
        return d

    def replace(self, **kw) -> "SDUNetConfig":
        return dataclasses.replace(self, **kw)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, float32 in and out,
    params ``scale`` and ``bias``."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.scale.float(), self.bias.float(),
                            self.eps)


class CrossAttention(nn.Module):
    """Multi-head attention; self- or cross- depending on ``context``."""

    def __init__(self, query_dim: int, context_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = Dense(inner, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        heads = (self.num_heads, self.head_dim)
        q = self.to_q(x).unflatten(-1, heads)
        k = self.to_k(ctx).unflatten(-1, heads)
        v = self.to_v(ctx).unflatten(-1, heads)
        return self.to_out(multi_head_attention(q, k, v).flatten(-2))


class GEGLUFeedForward(nn.Module):
    """x -> proj_out(h * gelu_tanh(gate)), [h, gate] = proj_in(x)."""

    def __init__(self, channels: int):
        super().__init__()
        self.proj_in = Dense(channels, 8 * channels)
        self.proj_out = Dense(4 * channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention to the context, GEGLU feed-forward,
    each after a float32 LayerNorm and added to the residual."""

    def __init__(self, channels: int, context_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (LayerNorm(channels) for _ in range(3))
        self.attn1 = CrossAttention(channels, channels, num_heads, head_dim)
        self.attn2 = CrossAttention(channels, context_dim, num_heads, head_dim)
        self.ff = GEGLUFeedForward(channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x + self.attn1(self.norm1(x).to(dt))
        x = x + self.attn2(self.norm2(x).to(dt), context)
        return x + self.ff(self.norm3(x).to(dt))


class Transformer2D(nn.Module):
    """GroupNorm -> (linear | 1x1 conv) proj_in -> transformer block ->
    proj_out, added to the input."""

    def __init__(self, channels: int, context_dim: int, num_heads: int, head_dim: int, *,
                 norm_num_groups: int = 32, use_linear_projection: bool = True):
        super().__init__()
        self.groups = norm_num_groups
        self.use_linear = use_linear_projection
        self.norm_scale, self.norm_bias = _norm_params(channels)
        proj = (lambda: Dense(channels, channels)) if use_linear_projection else (
            lambda: Conv(channels, channels, 1))
        self.proj_in = proj()
        self.block_0 = BasicTransformerBlock(channels, context_dim, num_heads, head_dim)
        self.proj_out = proj()

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = group_norm(x, num_groups=self.groups, eps=1e-6, scale=self.norm_scale,
                       bias=self.norm_bias, out_dtype=x.dtype)
        if self.use_linear:
            h = self.proj_in(h.reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h).reshape(b, hh * ww, c)
        h = self.block_0(h, context)
        if self.use_linear:
            h = self.proj_out(h).reshape(b, hh, ww, c)
        else:
            h = self.proj_out(h.reshape(b, hh, ww, c))
        return x + h


class SDUNet(nn.Module):
    """forward(sample [B, h, w, 4], timesteps, encoder_hidden_states
    [B, 77, cross_attention_dim]) -> the model output, in ``sample``'s dtype.
    ``dtype`` is the compute dtype, as in ``CondUNet2D``."""

    def __init__(self, config: SDUNetConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = remat
        c0, ted = cfg.block_out_channels[0], cfg.time_embed_dim
        self.time_embedding = TimestepEmbedMLP(c0, ted)

        def res(cin, cout):
            return ResnetBlock(cin, cout, ted, norm_num_groups=cfg.norm_num_groups,
                               norm_eps=cfg.norm_eps)

        def xfmr(c, level):
            heads = cfg.heads_at(level)
            return Transformer2D(c, cfg.cross_attention_dim, heads, c // heads,
                                 norm_num_groups=cfg.norm_num_groups,
                                 use_linear_projection=cfg.use_linear_projection)

        n_levels = len(cfg.block_out_channels)
        self.conv_in = Conv(cfg.in_channels, c0, 3, padding=1)
        ch = c0
        skip_channels = [ch]
        for i, (btype, c_out) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", res(ch, c_out))
                ch = c_out
                if btype == "CrossAttnDownBlock2D":
                    self.add_module(f"down_{i}_attn_{j}", xfmr(ch, i))
                skip_channels.append(ch)
            if i < n_levels - 1:
                self.add_module(f"down_{i}_downsample",
                                Downsample2D(ch, padding=cfg.downsample_padding))
                skip_channels.append(ch)

        c_mid = cfg.block_out_channels[-1]
        self.mid_res_0 = res(ch, c_mid)
        self.mid_attn = xfmr(c_mid, n_levels - 1)
        self.mid_res_1 = res(c_mid, c_mid)
        ch = c_mid

        for i, (btype, c_out) in enumerate(
                zip(cfg.up_block_types, reversed(cfg.block_out_channels))):
            level = n_levels - 1 - i
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", res(ch + skip_channels.pop(), c_out))
                ch = c_out
                if btype == "CrossAttnUpBlock2D":
                    self.add_module(f"up_{i}_attn_{j}", xfmr(ch, level))
            if i < n_levels - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(ch))
        assert not skip_channels

        self.norm_out_scale, self.norm_out_bias = _norm_params(ch)
        self.conv_out = Conv(ch, cfg.out_channels, 3, padding=1)
        self.to(memory_format=torch.channels_last)

    def init_weights(self, generator: torch.Generator) -> "SDUNet":
        """Flax's default initialisers, drawn from ``generator``."""
        return init_flax_weights(self, generator)

    def forward(
        self,
        sample: torch.Tensor,  # [B, h, w, C] latents
        timesteps,  # int, 0-d or [B] integer tensor
        encoder_hidden_states: torch.Tensor,  # [B, 77, cross_attention_dim]
    ) -> torch.Tensor:
        cfg = self.config
        dt = self.dtype
        x = sample.to(dt)
        ctx = encoder_hidden_states.to(dt)
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        temb = sinusoidal_timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
        )
        temb = self.time_embedding(temb.to(dt))

        n_levels = len(cfg.block_out_channels)
        x = self.conv_in(x)
        skips = [x]
        for i, btype in enumerate(cfg.down_block_types):
            for j in range(cfg.layers_per_block):
                x = run_block(self, f"down_{i}_res_{j}", x, temb)
                if btype == "CrossAttnDownBlock2D":
                    x = run_block(self, f"down_{i}_attn_{j}", x, ctx)
                skips.append(x)
            if i < n_levels - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)

        x = run_block(self, "mid_res_0", x, temb)
        x = run_block(self, "mid_attn", x, ctx)
        x = run_block(self, "mid_res_1", x, temb)

        for i, btype in enumerate(cfg.up_block_types):
            for j in range(cfg.layers_per_block + 1):
                x = torch.cat([x, skips.pop().to(dt)], dim=-1)
                x = run_block(self, f"up_{i}_res_{j}", x, temb)
                if btype == "CrossAttnUpBlock2D":
                    x = run_block(self, f"up_{i}_attn_{j}", x, ctx)
            if i < n_levels - 1:
                x = getattr(self, f"up_{i}_upsample")(x)

        x = group_norm(x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                       scale=self.norm_out_scale, bias=self.norm_out_bias, act="silu",
                       out_dtype=dt)
        return self.conv_out(x).to(sample.dtype)
