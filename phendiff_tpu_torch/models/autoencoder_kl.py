"""AutoencoderKL (the SD VAE) in PyTorch.

Counterpart of ``phendiff_tpu/models/autoencoder_kl.py``, the frozen VAE of
the SD family (the SD-2.1 checkpoint's architecture).  ``encode`` returns
the mean and the clipped log-variance of a diagonal Gaussian over
``latent_channels``; ``decode`` maps latents back to images;
``encode_to_latents`` / ``decode_from_latents`` apply ``scaling_factor``.

* NHWC throughout, submodules named after the Flax scopes (``encoder.
  down_0_res_0.norm1_scale``, ``decoder.up_1_upsample``, ``quant_conv``,
  ...), so ``models/convert.py`` maps a Flax checkpoint by renaming and
  transposing only.
* Hazards of the reference kept: every GroupNorm has eps 1e-6; down-
  sampling pads (0, 1) on H and W and runs a stride-2 valid conv;
  up-sampling is a 2x nearest broadcast; the log-variance is clipped to
  [-30, 20].
* The mid-block attention is one head of D = C written as float32 products
  in the reference; here ``ops.attention.single_head_attention``, off the
  fused kernel, as the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from phendiff_tpu_torch.models.embeddings import Dense
from phendiff_tpu_torch.models.unet2d import Conv, _norm_params, init_flax_weights
from phendiff_tpu_torch.ops.attention import single_head_attention
from phendiff_tpu_torch.ops.group_norm import group_norm

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215

    _JSON_IGNORED = (
        "_class_name", "_diffusers_version", "_name_or_path", "act_fn",
        "down_block_types", "up_block_types", "force_upcast",
        "use_quant_conv", "use_post_quant_conv", "shift_factor",
        "latents_mean", "latents_std", "mid_block_add_attention",
    )

    @classmethod
    def from_json(cls, path_or_dict) -> "AutoencoderKLConfig":
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
                raise ValueError(f"unsupported VAE config key: {k}")
            kwargs[k] = tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["block_out_channels"] = list(self.block_out_channels)
        d["_class_name"] = "AutoencoderKL"
        return d


def _gn(x, groups, scale, bias, act=None):
    return group_norm(x, num_groups=groups, eps=EPS, scale=scale, bias=bias, act=act,
                      out_dtype=x.dtype)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.groups = norm_num_groups
        self.norm1_scale, self.norm1_bias = _norm_params(in_channels)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.norm2_scale, self.norm2_bias = _norm_params(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_gn(x, self.groups, self.norm1_scale, self.norm1_bias, "silu"))
        h = self.conv2(_gn(h, self.groups, self.norm2_scale, self.norm2_bias, "silu"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention (the VAE mid-block attention)."""

    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.groups = norm_num_groups
        self.norm_scale, self.norm_bias = _norm_params(channels)
        self.to_q, self.to_k, self.to_v, self.to_out = (
            Dense(channels, channels) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = _gn(x, self.groups, self.norm_scale, self.norm_bias).reshape(b, hh * ww, c)
        out = single_head_attention(self.to_q(h), self.to_k(h), self.to_v(h))
        return x + self.to_out(out.to(x.dtype)).reshape(b, hh, ww, c)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        self.config = cfg
        g = cfg.norm_num_groups
        chans = cfg.block_out_channels
        self.conv_in = Conv(cfg.in_channels, chans[0], 3, padding=1)
        ch = chans[0]
        for i, c_out in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", VAEResnet(ch, c_out, g))
                ch = c_out
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, 3, stride=2))
        self.mid_res_0 = VAEResnet(ch, ch, g)
        self.mid_attn = VAEAttention(ch, g)
        self.mid_res_1 = VAEResnet(ch, ch, g)
        self.norm_out_scale, self.norm_out_bias = _norm_params(ch)
        self.conv_out = Conv(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x)
            if i < len(cfg.block_out_channels) - 1:
                # asymmetric pad + stride-2 valid conv (SD VAE downsampling)
                x = getattr(self, f"down_{i}_downsample")(F.pad(x, (0, 0, 0, 1, 0, 1)))
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        x = _gn(x, cfg.norm_num_groups, self.norm_out_scale, self.norm_out_bias, "silu")
        return self.conv_out(x)


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        self.config = cfg
        g = cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = Conv(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_res_0 = VAEResnet(rev[0], rev[0], g)
        self.mid_attn = VAEAttention(rev[0], g)
        self.mid_res_1 = VAEResnet(rev[0], rev[0], g)
        ch = rev[0]
        for i, c_out in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", VAEResnet(ch, c_out, g))
                ch = c_out
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, padding=1))
        self.norm_out_scale, self.norm_out_bias = _norm_params(ch)
        self.conv_out = Conv(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        n = len(cfg.block_out_channels)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(self.conv_in(z))))
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(x)
            if i < n - 1:
                b, hh, ww, c = x.shape  # 2x nearest upsample
                x = x[:, :, None, :, None, :].expand(b, hh, 2, ww, 2, c).reshape(
                    b, 2 * hh, 2 * ww, c)
                x = getattr(self, f"up_{i}_upsample")(x)
        x = _gn(x, cfg.norm_num_groups, self.norm_out_scale, self.norm_out_bias, "silu")
        return self.conv_out(x)


class AutoencoderKL(nn.Module):
    """encode(x) -> (mean, logvar); decode(z) -> image; NHWC, computed in
    ``dtype`` (the input is cast to it), results in ``dtype``."""

    def __init__(self, config: AutoencoderKLConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = Conv(config.latent_channels, config.latent_channels, 1)
        self.to(memory_format=torch.channels_last)

    def init_weights(self, generator: torch.Generator) -> "AutoencoderKL":
        """Flax's default initialisers, drawn from ``generator``."""
        return init_flax_weights(self, generator)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        mean, logvar = self.encode(x)
        z = sample_gaussian(mean, logvar, generator) if generator is not None else mean
        return self.decode(z), mean, logvar


def sample_gaussian(mean: torch.Tensor, logvar: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + exp(logvar / 2) * N(0, 1): the standard-normal ``noise`` given,
    or drawn in f32 from ``generator`` (on its device), then cast to the
    mean's device and dtype."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=generator.device,
                            dtype=torch.float32)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.device, mean.dtype)


def encode_to_latents(vae: AutoencoderKL, images: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[-1, 1] images -> scaled latents: the posterior's mean (or a sample of
    it, given a generator or the noise) times ``scaling_factor``."""
    mean, logvar = vae.encode(images)
    if generator is not None or noise is not None:
        mean = sample_gaussian(mean, logvar, generator, noise)
    return mean * vae.config.scaling_factor


def decode_from_latents(vae: AutoencoderKL, latents: torch.Tensor) -> torch.Tensor:
    return vae.decode(latents / vae.config.scaling_factor)
