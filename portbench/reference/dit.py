"""Plain float32 reference of DiT (Peebles & Xie, ICCV 2023;
github.com/facebookresearch/DiT ``models.py``), for the ``dit`` family.

Written from DiT's equations in plain PyTorch over ``models.Arith``:
NHWC latents in and out, the patch conv and every dense layer through the
``Arith``, LayerNorm by its definition, attention as
softmax(q k^T / sqrt(D)) v in full (so ``Recorder`` lists the (S, H, D)
of each call).  Parameter names and shapes are DiT's (and the port's):
``x_embedder.proj``, ``t_embedder.mlp.{0,2}``,
``y_embedder.embedding_table``, ``blocks.{i}.{attn.qkv, attn.proj,
mlp.fc1, mlp.fc2, adaLN_modulation.1}``, ``final_layer.{adaLN_modulation.1,
linear}``; the fixed sin-cos position table is computed here, not loaded.

This module imports nothing of the package under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.models import Arith, Conv, Dense, timestep_embedding


def sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    """[M, dim]: sin then cos of pos * 10000^(-2i / dim)."""
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = pos.reshape(-1)[:, None] * omega[None, :]
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """[grid^2, dim]: token i * grid + j (row i, column j) is the column's
    1-D table, then the row's (DiT's meshgrid puts w first)."""
    rows, cols = np.meshgrid(np.arange(grid, dtype=np.float64),
                             np.arange(grid, dtype=np.float64), indexing="ij")
    table = np.concatenate([sincos_1d(dim // 2, cols), sincos_1d(dim // 2, rows)], axis=1)
    return torch.from_numpy(table.astype(np.float32))


def layer_norm(x):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _seq(**layers) -> nn.Module:
    """A module whose children are named as DiT's ``nn.Sequential``s index
    them (``mlp.0``, ``adaLN_modulation.1``)."""
    m = nn.Module()
    for name, layer in layers.items():
        m.add_module(name.lstrip("_"), layer)
    return m


class Block(nn.Module):
    def __init__(self, c: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.heads = heads
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = Dense(c, 3 * c), Dense(c, c)
        self.mlp = nn.Module()
        hidden = int(c * mlp_ratio)
        self.mlp.fc1, self.mlp.fc2 = Dense(c, hidden), Dense(hidden, c)
        self.adaLN_modulation = _seq(_1=Dense(c, 6 * c))

    def forward(self, ar: Arith, x, c):
        mods = self.adaLN_modulation._modules["1"](ar, F.silu(c)).chunk(6, dim=1)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
        b, s, width = x.shape
        h = modulate(layer_norm(x), shift_msa, scale_msa)
        q, k, v = self.attn.qkv(ar, h).reshape(b, s, 3, self.heads, width // self.heads).unbind(2)
        x = x + gate_msa[:, None] * self.attn.proj(ar, ar.attention(q, k, v).reshape(b, s, width))
        h = modulate(layer_norm(x), shift_mlp, scale_mlp)
        h = self.mlp.fc2(ar, F.gelu(self.mlp.fc1(ar, h), approximate="tanh"))
        return x + gate_mlp[:, None] * h


class DiT(nn.Module):
    """forward(ar, x [B, H, W, C], t [B], y_emb [B, hidden]) -> [B, H, W,
    out]; ``embed`` gives labels' rows of the label table."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        c, p = cfg["hidden_size"], cfg["patch_size"]
        self.out_channels = cfg["in_channels"] * (2 if cfg["learn_sigma"] else 1)
        self.x_embedder = nn.Module()
        self.x_embedder.proj = Conv(cfg["in_channels"], c, p, stride=p)
        self.t_embedder = nn.Module()
        self.t_embedder.mlp = _seq(_0=Dense(256, c), _2=Dense(c, c))
        self.y_embedder = nn.Module()
        self.y_embedder.embedding_table = nn.Module()
        self.y_embedder.embedding_table.weight = nn.Parameter(
            torch.empty(cfg["num_classes"] + 1, c))
        self.blocks = nn.ModuleList(Block(c, cfg["num_heads"], cfg["mlp_ratio"])
                                    for _ in range(cfg["depth"]))
        self.final_layer = nn.Module()
        self.final_layer.adaLN_modulation = _seq(_1=Dense(c, 2 * c))
        self.final_layer.linear = Dense(c, p * p * self.out_channels)

    def embed(self, labels):
        return self.y_embedder.embedding_table.weight[labels]

    def forward(self, ar: Arith, x, t, y_emb):
        cfg = self.cfg
        b, hh, ww, _ = x.shape
        p, c = cfg["patch_size"], cfg["hidden_size"]
        h = self.x_embedder.proj(ar, x).reshape(b, -1, c)
        h = h + sincos_2d(c, hh // p).to(x.device)
        temb = timestep_embedding(t, 256, True, 0.0)
        mlp = self.t_embedder.mlp._modules
        cond = mlp["2"](ar, F.silu(mlp["0"](ar, temb)))
        cond = cond + y_emb
        for block in self.blocks:
            h = block(ar, h, cond)
        shift, scale = self.final_layer.adaLN_modulation._modules["1"](ar, F.silu(cond)).chunk(
            2, dim=1)
        h = self.final_layer.linear(ar, modulate(layer_norm(h), shift, scale))
        h = h.reshape(b, hh // p, ww // p, p, p, self.out_channels).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(b, hh, ww, self.out_channels)


def flops_per_forward(cfg: dict) -> float:
    """The forward's multiply-adds, twice, from DiT's widths: the patch
    conv, each block's qkv, attention (QK^T and PV), proj, fc1, fc2 and
    adaLN products, the final layer, the timestep MLP."""
    c, p, s = cfg["hidden_size"], cfg["patch_size"], (cfg["input_size"] // cfg["patch_size"]) ** 2
    out = cfg["in_channels"] * (2 if cfg["learn_sigma"] else 1)
    hidden = int(c * cfg["mlp_ratio"])
    block = s * (3 * c * c + c * c + 2 * c * hidden) + 2 * s * s * c + 6 * c * c
    total = cfg["depth"] * block + s * cfg["in_channels"] * p * p * c
    total += s * c * p * p * out + 2 * c * c + 256 * c + c * c
    return 2.0 * total

