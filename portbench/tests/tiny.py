"""Tiny configurations and cells for the harness's CPU tests: the same
families, runners and files as the benchmark's, at widths a test holds."""

from __future__ import annotations

import copy

from portbench.harness import spec

DDIM = {
    "name": "ddim_tiny", "family": "ddim", "resolution": 16, "reduced": [],
    "unet": {"sample_size": 16, "in_channels": 3, "out_channels": 3,
             "block_out_channels": [16, 32], "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
             "up_block_types": ["AttnUpBlock2D", "UpBlock2D"], "layers_per_block": 1,
             "attention_head_dim": 8, "norm_num_groups": 8, "norm_eps": 1e-05,
             "num_class_embeds": 2, "time_embedding_type": "positional",
             "flip_sin_to_cos": True, "freq_shift": 0.0, "downsample_padding": 1,
             "resnet_time_scale_shift": "default"},
}

SD = {
    "name": "sd_tiny", "family": "sd", "resolution": 16, "reduced": [],
    "unet": {"sample_size": 8, "in_channels": 4, "out_channels": 4,
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"],
             "block_out_channels": [32, 64], "layers_per_block": 1, "cross_attention_dim": 32,
             "attention_head_dim": [2, 4], "norm_num_groups": 8, "norm_eps": 1e-05,
             "flip_sin_to_cos": True, "freq_shift": 0, "use_linear_projection": True,
             "upcast_attention": True, "downsample_padding": 1},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [16, 32], "layers_per_block": 1, "norm_num_groups": 8,
            "sample_size": 16, "scaling_factor": 0.18215},
    "class_embedding": {"num_classes": 2, "embedding_dim": 32},
}


def config(family: str) -> dict:
    """A tiny configuration of ``family`` with the benchmark configuration's
    scheduler."""
    base = copy.deepcopy(DDIM if family == "ddim" else SD)
    name = "ddim_super_small_128" if family == "ddim" else "sd21_128"
    base["scheduler"] = spec.load_json(spec.PACKAGE / "configs" / f"{name}.json")["scheduler"]
    return base


def cell(family: str, runner: str, limits: dict, **traffic) -> spec.Cell:
    """A cell over a tiny configuration, its traffic the benchmark's mix of
    ``runner`` with ``traffic``'s keys replaced."""
    mix = {("ddim", "ddib"): "ddib_b128", ("sd", "ddib"): "ddib_b256",
           ("ddim", "train"): "train_b112", ("sd", "train"): "finetune_b64"}[(family, runner)]
    mix = dict(spec.load_json(spec.PACKAGE / "traffic" / f"{mix}.json"), **traffic)
    return spec.Cell(f"tiny.{family}.{runner}", 1, config(family), mix, limits, [], [])
