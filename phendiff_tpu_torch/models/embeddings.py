"""Time and class embeddings for the diffusion UNets.

Counterpart of ``phendiff_tpu/models/embeddings.py``: the positional
(sinusoidal) or Gaussian-Fourier timestep embedding, lifted to
``time_embed_dim`` by a two-layer SiLU MLP; the SD family's learnable class
table (``ClassEmbedding``) and its CLIP-shaped sequence
(``pad_to_clip_sequence``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype, as Flax's
    ``Dense(dtype=...)`` does over float32 params (a no-op cast once the
    weights are stored in that dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Transformer-style sinusoidal embedding of integer timesteps -> [B, dim]
    float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - freq_shift)
    freqs = torch.exp(exponent)
    args = scale * timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GaussianFourierProjection(nn.Module):
    """Random-Fourier time embedding (the 'fourier' option); the weight is
    frozen, as in the reference stack."""

    def __init__(self, embedding_size: int = 256, scale: float = 16.0):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.empty(embedding_size), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = x.float()[:, None] * self.weight.float()[None, :] * 2 * math.pi
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class TimestepEmbedMLP(nn.Module):
    """Two-layer SiLU MLP lifting the sinusoid to ``time_embed_dim``."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Dense(in_dim, time_embed_dim)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class ClassEmbedding(nn.Module):
    """Learnable per-class embedding table (the SD fine-tune's custom
    embedding: ``embedding_dim`` = the UNet's cross-attention width).  The
    table is the submodule ``embedding``, as the Flax scope names it."""

    def __init__(self, num_classes: int, embedding_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num_classes, embedding_dim)

    def forward(self, class_labels: torch.Tensor) -> torch.Tensor:
        return self.embedding(class_labels)


def pad_to_clip_sequence(class_emb: torch.Tensor, seq_len: int = 77) -> torch.Tensor:
    """(B, D) -> (B, seq_len, D): the class vector in slot 0, zeros elsewhere
    (the reference feeds one class embedding through SD's cross-attention in
    the CLIP text encoder's output shape)."""
    b, d = class_emb.shape
    return torch.cat([class_emb[:, None], class_emb.new_zeros((b, seq_len - 1, d))], dim=1)
