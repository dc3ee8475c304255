"""DiT (Peebles & Xie, "Scalable Diffusion Models with Transformers", ICCV
2023): a class-conditional latent transformer with adaLN-Zero blocks.

Written from ``models.py`` of github.com/facebookresearch/DiT, equation for
equation; the JAX package has no counterpart.  Submodules carry DiT's own
names (``x_embedder.proj``, ``t_embedder.mlp.{0,2}``,
``y_embedder.embedding_table``, ``blocks.{i}.{attn.qkv, attn.proj,
mlp.fc1, mlp.fc2, adaLN_modulation.1}``, ``final_layer.{adaLN_modulation.1,
linear}``, the fixed ``pos_embed``), so the public checkpoint's state dict
loads by name.

* The public layout is NHWC, as in the port's UNets: latents [B, H, W, C]
  in, [B, H, W, out_channels] out (with ``learn_sigma`` the first
  ``in_channels`` are eps, the rest the variance interpolation, which DDIM
  with eta 0 does not read: ``eps_of``).
* Patches: the 2x2 stride-2 conv of ``PatchEmbed`` as one product over the
  row-major tokens; ``pos_embed`` is DiT's fixed 2-D sin-cos table (each
  1-D half ``[sin, cos]``, the meshgrid ordered w first), a persistent
  buffer, not trained.
* Conditioning: the 256-frequency timestep embedding ``[cos, sin]`` through
  Linear-SiLU-Linear, plus the label's row of a table of ``num_classes + 1``
  (the last row is the null class of classifier-free guidance); ``c`` is
  their sum.  Each block's ``adaLN_modulation`` (SiLU, Linear(C, 6C)) gives
  a per-sample shift, scale and gate for each of its two sub-layers:
  ``x + gate * f(LN(x) * (1 + scale) + shift)``, LayerNorm without affine,
  eps 1e-6.  The 28 projections depend on ``c`` alone, so they run before
  the blocks.
* Attention: the fused qkv output viewed as [B, S, 3, H, D], its q, k, v
  [B, S, H, D] views (no copy) through ``ops.attention.
  multi_head_attention``; the MLP is fc1, tanh-GELU, fc2.

* Sub-layer boundaries: the blocks carry (x, z) from one to the next, z
  the modulated norm the next sub-layer reads.  Each boundary (a gated
  residual, then the next norm and modulate) is one call of
  ``ops.adaln_norm.adaln_norm`` (``_adaln``): on the card one fused kernel
  launch (or it raises), on the CPU the composition of the three ops.  The
  leading call norms the embedded tokens for block 0's attention; the one
  after a block's MLP modulates with the next block's attention shift and
  scale, and after the last block with the final layer's, whose linear
  reads that z alone (x' is then not written).

A forward is three spans (``obs/profiling.py``): ``dit/condition`` (the
embeddings, ``c`` and every adaLN projection), ``dit/blocks`` (the
boundaries included) and ``dit/final``.  ``glue_launches`` counts the
elementwise and LayerNorm ops the blocks and the final layer dispatch, as
they dispatch: a fused boundary one, the composition one an op (norm,
modulate, gate-and-residual: ``adaln_norm_plain.ops``), and GELU one
(``_glue_op``).  That is 1 + 3 a block on the kernel route and 2 + 7 a
block on the composition; ``forward_calls`` counts the forwards.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from phendiff_tpu_torch.models.embeddings import Dense, sinusoidal_timestep_embedding
from phendiff_tpu_torch.models.unet2d import init_flax_weights
from phendiff_tpu_torch.obs.profiling import annotate
from phendiff_tpu_torch.ops.adaln_norm import adaln_norm, adaln_norm_plain
from phendiff_tpu_torch.ops.attention import multi_head_attention

FREQUENCY_EMBEDDING_SIZE = 256
LN_EPS = 1e-6

# launches of the blocks' and the final layer's elementwise and LayerNorm
# ops, and the forwards that issued them
glue_launches = 0
forward_calls = 0


def _glue_op(fn):
    """``fn`` dispatches one elementwise or LayerNorm op: each call adds one
    to ``glue_launches``."""

    @functools.wraps(fn)
    def counted(*args, **kwargs):
        global glue_launches
        glue_launches += 1
        return fn(*args, **kwargs)

    return counted


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """DiT's constructor surface less its training-only label dropout; the
    defaults are ``DiT_XL_2`` at 512 px (64 x 64 latents of the SD VAE)."""

    input_size: int = 64
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        if self.input_size % self.patch_size:
            raise ValueError("input_size must be a multiple of patch_size")

    @property
    def out_channels(self) -> int:
        return 2 * self.in_channels if self.learn_sigma else self.in_channels

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid_size(self) -> int:
        return self.input_size // self.patch_size

    @classmethod
    def from_json(cls, path_or_dict) -> "DiTConfig":
        raw = path_or_dict
        if not isinstance(raw, dict):
            with open(raw) as f:
                raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(k for k in raw if k not in known and k != "_class_name")
        if unknown:
            raise ValueError(f"unsupported DiT config keys: {unknown}")
        return cls(**{k: v for k, v in raw.items() if k in known})

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["_class_name"] = "DiT"
        return d


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim]: ``[sin, cos]`` of pos / 10000^(2i/D)."""
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size^2, embed_dim] float32, tokens row-major: the first half
    embeds ``meshgrid(w, h)[0]`` (the column), the second the row."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


class PatchEmbed(nn.Module):
    """Conv(in, hidden, kernel p, stride p) over NHWC latents, then the
    row-major tokens [B, (H/p)(W/p), hidden]."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        p = self.patch_size
        # each patch's (kh, kw, c) values against the kernel read in that order
        patches = x.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return F.linear(patches.reshape(b, -1, p * p * c), w.to(x.dtype),
                        self.proj.bias.to(x.dtype))


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.mlp = nn.Sequential(Dense(FREQUENCY_EMBEDDING_SIZE, hidden_size), nn.SiLU(),
                                 Dense(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        freq = sinusoidal_timestep_embedding(t, FREQUENCY_EMBEDDING_SIZE, flip_sin_to_cos=True)
        return self.mlp(freq.to(dtype))


class LabelEmbedder(nn.Module):
    """``num_classes`` rows and the null row (index ``num_classes``); no
    label dropout here (it belongs to training)."""

    def __init__(self, num_classes: int, hidden_size: int):
        super().__init__()
        self.embedding_table = nn.Embedding(num_classes + 1, hidden_size)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.embedding_table(labels)


class Attention(nn.Module):
    """timm's ``Attention(dim, num_heads, qkv_bias=True)``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.num_heads, c // self.num_heads)
        out = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, s, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_gelu(self.fc1(x)))


@_glue_op
def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _adaln(x, gate, y, shift, scale1p, keep_x=True):
    """(x + gate * y, LN(x + gate * y) * scale1p + shift) per sample (without
    y: x and its modulated norm; x' None where ``keep_x`` is false), by
    ``adaln_norm``; counted in ``glue_launches`` as it dispatched: its kernel
    launches and the composition's ops, each counted where it runs."""
    global glue_launches
    before = adaln_norm.launches + adaln_norm_plain.ops
    out = adaln_norm(x, gate, y, shift, scale1p, eps=LN_EPS, keep_x=keep_x)
    glue_launches += adaln_norm.launches + adaln_norm_plain.ops - before
    return out


class DiTBlock(nn.Module):
    """adaLN-Zero block over the residual stream x and z, its norm
    modulated by this block's attention shift and scale."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Dense(hidden_size, 6 * hidden_size))

    def forward(self, x: torch.Tensor, z: torch.Tensor, mod: torch.Tensor,
                next_shift: torch.Tensor, next_scale1p: torch.Tensor, keep_x: bool = True):
        """``mod``: this block's [B, 6, C] projection of ``c`` with 1 added to
        both scales (its attention shift and scale already went into z).
        Returns the block's output and its norm modulated by ``next_shift``
        and ``next_scale1p`` (the next block's attention ones, or the final
        layer's), the output None where ``keep_x`` is false."""
        _, _, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.unbind(1)
        x, z = _adaln(x, gate_msa, self.attn(z), shift_mlp, scale_mlp)
        return _adaln(x, gate_mlp, self.mlp(z), next_shift, next_scale1p, keep_x=keep_x)


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.linear = Dense(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Dense(hidden_size, 2 * hidden_size))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """The linear of z, the last block's output normed and modulated by
        this layer's [B, 2, C] projection (``DiT.condition``)."""
        return self.linear(z)


class DiT(nn.Module):
    """forward(x [B, H, W, C] latents, t [B] timesteps, y) -> [B, H, W,
    out_channels] in ``x``'s dtype, ``y`` [B] int labels or their [B,
    hidden] rows of the label table (``y_embedder``); ``dtype`` is the
    compute dtype (LayerNorm and softmax statistics in float32 inside
    their ops)."""

    def __init__(self, config: DiTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        c = cfg.hidden_size
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, c)
        self.t_embedder = TimestepEmbedder(c)
        self.y_embedder = LabelEmbedder(cfg.num_classes, c)
        self.register_buffer("pos_embed", self.fixed_pos_embed())
        self.blocks = nn.ModuleList(DiTBlock(c, cfg.num_heads, cfg.mlp_ratio)
                                    for _ in range(cfg.depth))
        self.final_layer = FinalLayer(c, cfg.patch_size, cfg.out_channels)

    def fixed_pos_embed(self) -> torch.Tensor:
        """DiT's [1, T, hidden] sin-cos table, on the CPU (a module built on
        the meta device loads it with its weights)."""
        cfg = self.config
        return torch.from_numpy(get_2d_sincos_pos_embed(cfg.hidden_size, cfg.grid_size))[None]

    def init_weights(self, generator: torch.Generator) -> "DiT":
        """Flax's default initialisers (as the port's other models), drawn
        from ``generator``, and the fixed ``pos_embed``.  DiT's own zero init
        of the adaLN and final layers would make a fresh model's output 0."""
        init_flax_weights(self, generator)
        with torch.no_grad():
            self.pos_embed.copy_(self.fixed_pos_embed())
        return self

    def condition(self, t: torch.Tensor, y: torch.Tensor, dtype: torch.dtype):
        """Every block's [B, 6, C] modulation and the final layer's
        [B, 2, C], the scales as 1 + scale."""
        y_emb = y if y.is_floating_point() else self.y_embedder(y)
        c = self.t_embedder(t, dtype) + y_emb.to(dtype)
        silu = F.silu(c)
        mods = []
        for block in self.blocks:
            m = block.adaLN_modulation[1](silu).unflatten(1, (6, -1))
            m[:, 1::3] += 1
            mods.append(m)
        fin = self.final_layer.adaLN_modulation[1](silu).unflatten(1, (2, -1))
        fin[:, 1] += 1
        return mods, fin

    def forward(self, x: torch.Tensor, timesteps: Union[int, torch.Tensor],
                y: torch.Tensor) -> torch.Tensor:
        global forward_calls
        cfg, dt = self.config, self.dtype
        b, hh, ww, _ = x.shape
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(b)
        with annotate("dit/condition"):
            mods, fin = self.condition(timesteps, torch.as_tensor(y, device=x.device), dt)
        with annotate("dit/blocks"):
            h = self.x_embedder(x.to(dt)) + self.pos_embed.to(dt)
            h, z = _adaln(h, None, None, mods[0][:, 0], mods[0][:, 1])
            # each block's output normed and modulated by the next one's
            # attention shift and scale, the last block's by the final layer's
            nexts = [m[:, :2] for m in mods[1:]] + [fin]
            for i, (block, mod, nxt) in enumerate(zip(self.blocks, mods, nexts)):
                h, z = block(h, z, mod, nxt[:, 0], nxt[:, 1], keep_x=i + 1 < len(mods))
        with annotate("dit/final"):
            out = self.final_layer(z)
            p, oc = cfg.patch_size, cfg.out_channels
            out = out.reshape(b, hh // p, ww // p, p, p, oc).permute(0, 1, 3, 2, 4, 5)
            out = out.reshape(b, hh, ww, oc).to(x.dtype)
        forward_calls += 1
        return out

    def eps_of(self, out: torch.Tensor) -> torch.Tensor:
        """The eps half of an output (all of it without ``learn_sigma``)."""
        return out[..., :self.config.in_channels]
