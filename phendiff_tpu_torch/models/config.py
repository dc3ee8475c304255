"""Model configuration dataclasses, interoperable with the reference's
diffusers-format JSON files (``models_configs/denoiser/*.json``).

A plain copy of ``phendiff_tpu/models/config.py``: the port keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

DOWN_BLOCK_TYPES = ("DownBlock2D", "AttnDownBlock2D")
UP_BLOCK_TYPES = ("UpBlock2D", "AttnUpBlock2D")


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    """Config for the pixel-space conditional UNet (reference:
    ``src/cond_unet_2d/cond_unet_2d.py:74-107`` constructor surface)."""

    sample_size: int = 128
    in_channels: int = 3
    out_channels: int = 3
    center_input_sample: bool = False
    time_embedding_type: str = "positional"  # or "fourier"
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D",
        "DownBlock2D",
        "AttnDownBlock2D",
    )
    up_block_types: Tuple[str, ...] = ("AttnUpBlock2D", "UpBlock2D", "UpBlock2D")
    block_out_channels: Tuple[int, ...] = (64, 128, 256)
    layers_per_block: int = 2
    mid_block_scale_factor: float = 1.0
    downsample_padding: int = 1
    act_fn: str = "silu"
    attention_head_dim: Optional[int] = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    resnet_time_scale_shift: str = "default"  # or "scale_shift"
    num_class_embeds: Optional[int] = 2
    class_embed_type: Optional[str] = None
    upcast_attention: bool = False

    def __post_init__(self):
        if len(self.down_block_types) != len(self.block_out_channels):
            raise ValueError("down_block_types and block_out_channels length mismatch")
        if len(self.up_block_types) != len(self.block_out_channels):
            raise ValueError("up_block_types and block_out_channels length mismatch")
        for t in self.down_block_types:
            if t not in DOWN_BLOCK_TYPES:
                raise ValueError(f"unknown down block type: {t}")
        for t in self.up_block_types:
            if t not in UP_BLOCK_TYPES:
                raise ValueError(f"unknown up block type: {t}")

    @property
    def time_embed_dim(self) -> int:
        # Matches the reference invariant time_embed_dim = C0 * 4
        # (cond_unet_2d.py:111-113).
        return self.block_out_channels[0] * 4

    _JSON_IGNORED = (
        "_class_name",
        "_diffusers_version",
        "conv_in_kernel",
        "conv_out_kernel",
        "resnet_out_scale_factor",
        "resnet_skip_time_act",
        "use_linear_projection",
        "time_embedding_dim",
        "add_attention",
        "attn_norm_num_groups",
        "dropout",
        "num_train_timesteps",
    )

    @classmethod
    def from_json(cls, path_or_dict) -> "UNet2DConfig":
        if isinstance(path_or_dict, dict):
            raw = dict(path_or_dict)
        else:
            with open(path_or_dict) as f:
                raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in raw.items():
            if k in cls._JSON_IGNORED:
                continue
            if k not in known:
                raise ValueError(f"unsupported UNet config key: {k}")
            if isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, tuple):
                d[k] = list(v)
        d["_class_name"] = "CondUNet2DModel"
        return d

    def replace(self, **kw) -> "UNet2DConfig":
        return dataclasses.replace(self, **kw)


# Named presets mirroring the reference's models_configs/denoiser/*.json
# capacity ladder (super_small / small / SD-2.1-size / orig-google-ddpm).
def super_small() -> UNet2DConfig:
    return UNet2DConfig()


def small() -> UNet2DConfig:
    return UNet2DConfig(block_out_channels=(128, 256, 512))


def sd21_size() -> UNet2DConfig:
    return UNet2DConfig(
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=(
            "AttnDownBlock2D",
            "AttnDownBlock2D",
            "AttnDownBlock2D",
            "DownBlock2D",
        ),
        up_block_types=(
            "UpBlock2D",
            "AttnUpBlock2D",
            "AttnUpBlock2D",
            "AttnUpBlock2D",
        ),
        upcast_attention=True,
    )


def ddpm_unconditional_256() -> UNet2DConfig:
    return UNet2DConfig(
        sample_size=256,
        block_out_channels=(128, 128, 256, 256, 512, 512),
        down_block_types=(
            "DownBlock2D",
            "DownBlock2D",
            "DownBlock2D",
            "DownBlock2D",
            "AttnDownBlock2D",
            "DownBlock2D",
        ),
        up_block_types=(
            "UpBlock2D",
            "AttnUpBlock2D",
            "UpBlock2D",
            "UpBlock2D",
            "UpBlock2D",
            "UpBlock2D",
        ),
        downsample_padding=0,
        flip_sin_to_cos=False,
        freq_shift=1.0,
        norm_eps=1e-6,
        attention_head_dim=None,
        num_class_embeds=None,
    )


PRESETS = {
    "super_small": super_small,
    "small": small,
    "sd21_size": sd21_size,
    "ddpm_unconditional_256": ddpm_unconditional_256,
}
