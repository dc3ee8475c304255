"""Diffusers checkpoints in and out, for the three model families.

Counterpart of ``phendiff_tpu/models/hf_import.py`` (its key plans are the
specification, copied here): a state dict in diffusers' naming
(``down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_k.weight``,
``encoder.mid_block.attentions.0.to_q.bias``, ...) maps to and from the
state dict of the port's module, whose submodules carry the Flax scope
names:

* ``CondUNet2D`` <-> ``UNet2DModel`` (``unet2d_plan``): the pixel UNet's
  fused ``qkv`` linear is diffusers' ``to_q`` / ``to_k`` / ``to_v`` stacked
  along the output rows;
* ``SDUNet`` <-> ``UNet2DConditionModel`` (``sd_unet_plan``);
* ``AutoencoderKL`` <-> ``AutoencoderKL`` (``vae_plan``).

Diffusers' conv weights are OIHW and its linear weights [out, in], which
are the layouts of the port's ``nn.Conv2d`` and ``nn.Linear``, so both
directions are renames: no transposes (the NHWC activations are
channels_last views of the same weights).

The imports (``import_unet2d``, ``import_sd_unet``, ``import_vae``) raise on
a missing checkpoint key, an unmapped one, or a shape that does not match
the architecture, and give float32; the exports (``export_unet2d``,
``export_sd_unet``, ``export_vae``) raise on a parameter the plan does not
cover or misses, and keep each tensor's dtype and device.
``load_state_dict`` reads a ``.safetensors`` file (the port's own codec) or
a torch ``.bin`` / ``.pt`` file.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.sd_unet import SDUNetConfig

# (the port's key, diffusers' key); a tuple of diffusers' keys is one port
# tensor stacked from theirs along dim 0 (the pixel UNet's fused qkv)
Plan = List[Tuple[str, Union[str, Tuple[str, ...]]]]
_QKV = ("to_q", "to_k", "to_v")


def _conv(ours: str, theirs: str) -> Plan:
    return [(f"{ours}.weight", f"{theirs}.weight"), (f"{ours}.bias", f"{theirs}.bias")]


def _dense(ours: str, theirs: str, bias: bool = True) -> Plan:
    return _conv(ours, theirs) if bias else [(f"{ours}.weight", f"{theirs}.weight")]


def _norm(ours_prefix: str, theirs: str) -> Plan:
    return [(f"{ours_prefix}_scale", f"{theirs}.weight"),
            (f"{ours_prefix}_bias", f"{theirs}.bias")]


def _resnet(ours: str, theirs: str, has_shortcut: bool) -> Plan:
    plan = _norm(f"{ours}.norm1", f"{theirs}.norm1") + _conv(f"{ours}.conv1", f"{theirs}.conv1")
    plan += _dense(f"{ours}.time_emb_proj", f"{theirs}.time_emb_proj")
    plan += _norm(f"{ours}.norm2", f"{theirs}.norm2") + _conv(f"{ours}.conv2", f"{theirs}.conv2")
    if has_shortcut:
        plan += _conv(f"{ours}.conv_shortcut", f"{theirs}.conv_shortcut")
    return plan


def _vae_resnet(ours: str, theirs: str, has_shortcut: bool) -> Plan:
    plan = _norm(f"{ours}.norm1", f"{theirs}.norm1") + _conv(f"{ours}.conv1", f"{theirs}.conv1")
    plan += _norm(f"{ours}.norm2", f"{theirs}.norm2") + _conv(f"{ours}.conv2", f"{theirs}.conv2")
    if has_shortcut:
        plan += _conv(f"{ours}.conv_shortcut", f"{theirs}.conv_shortcut")
    return plan


def _attn2d(ours: str, theirs: str) -> Plan:
    """The pixel UNet's SelfAttention2D as a diffusers Attention."""
    plan = _norm(f"{ours}.norm", f"{theirs}.group_norm")
    plan += [(f"{ours}.qkv.{leaf}", tuple(f"{theirs}.{p}.{leaf}" for p in _QKV))
             for leaf in ("weight", "bias")]
    return plan + _dense(f"{ours}.proj_out", f"{theirs}.to_out.0")


def unet2d_plan(cfg: UNet2DConfig) -> Plan:
    plan = _conv("conv_in", "conv_in")
    plan += _dense("time_embedding.linear_1", "time_embedding.linear_1")
    plan += _dense("time_embedding.linear_2", "time_embedding.linear_2")
    if cfg.num_class_embeds is not None:
        plan.append(("class_embedding.weight", "class_embedding.weight"))
    chans = cfg.block_out_channels
    prev = chans[0]
    for i, (btype, c_out) in enumerate(zip(cfg.down_block_types, chans)):
        for j in range(cfg.layers_per_block):
            c_in = prev if j == 0 else c_out
            plan += _resnet(f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}", c_in != c_out)
            if btype == "AttnDownBlock2D":
                plan += _attn2d(f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}")
        if i < len(chans) - 1:
            plan += _conv(f"down_{i}_downsample.conv", f"down_blocks.{i}.downsamplers.0.conv")
        prev = c_out
    plan += _resnet("mid_res_0", "mid_block.resnets.0", False)
    plan += _attn2d("mid_attn", "mid_block.attentions.0")
    plan += _resnet("mid_res_1", "mid_block.resnets.1", False)
    rev = tuple(reversed(chans))
    for i, (btype, c_out) in enumerate(zip(cfg.up_block_types, rev)):
        for j in range(cfg.layers_per_block + 1):
            # the concatenated input never has c_out channels: a shortcut
            plan += _resnet(f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}", True)
            if btype == "AttnUpBlock2D":
                plan += _attn2d(f"up_{i}_attn_{j}", f"up_blocks.{i}.attentions.{j}")
        if i < len(rev) - 1:
            plan += _conv(f"up_{i}_upsample.conv", f"up_blocks.{i}.upsamplers.0.conv")
    plan += _norm("norm_out", "conv_norm_out")
    return plan + _conv("conv_out", "conv_out")


def _transformer(ours: str, theirs: str) -> Plan:
    """A Transformer2D; its projections are linear or 1x1 convs, both a
    weight and a bias under the same names."""
    tb_o, tb_t = f"{ours}.block_0", f"{theirs}.transformer_blocks.0"
    plan = _norm(f"{ours}.norm", f"{theirs}.norm") + _conv(f"{ours}.proj_in", f"{theirs}.proj_in")
    for n in ("norm1", "norm2", "norm3"):
        plan += [(f"{tb_o}.{n}.scale", f"{tb_t}.{n}.weight"),
                 (f"{tb_o}.{n}.bias", f"{tb_t}.{n}.bias")]
    for attn in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v"):
            plan += _dense(f"{tb_o}.{attn}.{proj}", f"{tb_t}.{attn}.{proj}", bias=False)
        plan += _dense(f"{tb_o}.{attn}.to_out", f"{tb_t}.{attn}.to_out.0")
    plan += _dense(f"{tb_o}.ff.proj_in", f"{tb_t}.ff.net.0.proj")
    plan += _dense(f"{tb_o}.ff.proj_out", f"{tb_t}.ff.net.2")
    return plan + _conv(f"{ours}.proj_out", f"{theirs}.proj_out")


def sd_unet_plan(cfg: SDUNetConfig) -> Plan:
    plan = _conv("conv_in", "conv_in")
    plan += _dense("time_embedding.linear_1", "time_embedding.linear_1")
    plan += _dense("time_embedding.linear_2", "time_embedding.linear_2")
    chans = cfg.block_out_channels
    prev = chans[0]
    for i, (btype, c_out) in enumerate(zip(cfg.down_block_types, chans)):
        for j in range(cfg.layers_per_block):
            c_in = prev if j == 0 else c_out
            plan += _resnet(f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}", c_in != c_out)
            if btype == "CrossAttnDownBlock2D":
                plan += _transformer(f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}")
        if i < len(chans) - 1:
            plan += _conv(f"down_{i}_downsample.conv", f"down_blocks.{i}.downsamplers.0.conv")
        prev = c_out
    plan += _resnet("mid_res_0", "mid_block.resnets.0", False)
    plan += _transformer("mid_attn", "mid_block.attentions.0")
    plan += _resnet("mid_res_1", "mid_block.resnets.1", False)
    rev = tuple(reversed(chans))
    for i, (btype, c_out) in enumerate(zip(cfg.up_block_types, rev)):
        for j in range(cfg.layers_per_block + 1):
            plan += _resnet(f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}", True)
            if btype == "CrossAttnUpBlock2D":
                plan += _transformer(f"up_{i}_attn_{j}", f"up_blocks.{i}.attentions.{j}")
        if i < len(rev) - 1:
            plan += _conv(f"up_{i}_upsample.conv", f"up_blocks.{i}.upsamplers.0.conv")
    plan += _norm("norm_out", "conv_norm_out")
    return plan + _conv("conv_out", "conv_out")


def _vae_attn(ours: str, theirs: str) -> Plan:
    plan = _norm(f"{ours}.norm", f"{theirs}.group_norm")
    for proj in ("to_q", "to_k", "to_v"):
        plan += _dense(f"{ours}.{proj}", f"{theirs}.{proj}")
    return plan + _dense(f"{ours}.to_out", f"{theirs}.to_out.0")


def vae_plan(cfg: AutoencoderKLConfig) -> Plan:
    chans = cfg.block_out_channels
    plan = _conv("encoder.conv_in", "encoder.conv_in")
    prev = chans[0]
    for i, c_out in enumerate(chans):
        for j in range(cfg.layers_per_block):
            c_in = prev if j == 0 else c_out
            plan += _vae_resnet(f"encoder.down_{i}_res_{j}",
                                f"encoder.down_blocks.{i}.resnets.{j}", c_in != c_out)
        if i < len(chans) - 1:
            plan += _conv(f"encoder.down_{i}_downsample",
                          f"encoder.down_blocks.{i}.downsamplers.0.conv")
        prev = c_out
    plan += _vae_resnet("encoder.mid_res_0", "encoder.mid_block.resnets.0", False)
    plan += _vae_attn("encoder.mid_attn", "encoder.mid_block.attentions.0")
    plan += _vae_resnet("encoder.mid_res_1", "encoder.mid_block.resnets.1", False)
    plan += _norm("encoder.norm_out", "encoder.conv_norm_out")
    plan += _conv("encoder.conv_out", "encoder.conv_out")
    plan += _conv("quant_conv", "quant_conv")
    plan += _conv("post_quant_conv", "post_quant_conv")
    plan += _conv("decoder.conv_in", "decoder.conv_in")
    rev = tuple(reversed(chans))
    plan += _vae_resnet("decoder.mid_res_0", "decoder.mid_block.resnets.0", False)
    plan += _vae_attn("decoder.mid_attn", "decoder.mid_block.attentions.0")
    plan += _vae_resnet("decoder.mid_res_1", "decoder.mid_block.resnets.1", False)
    prev = rev[0]
    for i, c_out in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            c_in = prev if j == 0 else c_out
            plan += _vae_resnet(f"decoder.up_{i}_res_{j}",
                                f"decoder.up_blocks.{i}.resnets.{j}", c_in != c_out)
        if i < len(rev) - 1:
            plan += _conv(f"decoder.up_{i}_upsample",
                          f"decoder.up_blocks.{i}.upsamplers.0.conv")
        prev = c_out
    plan += _norm("decoder.norm_out", "decoder.conv_norm_out")
    return plan + _conv("decoder.conv_out", "decoder.conv_out")


def _keys(theirs: Union[str, Tuple[str, ...]]) -> Tuple[str, ...]:
    return theirs if isinstance(theirs, tuple) else (theirs,)


def _check_keys(have, want, what: str) -> None:
    missing, unmapped = sorted(set(want) - set(have)), sorted(set(have) - set(want))
    if missing or unmapped:
        raise ValueError(f"{what} does not match the config: missing {missing[:8]} "
                         f"({len(missing)}), unmapped {unmapped[:8]} ({len(unmapped)})")


def _import(sd: Mapping[str, torch.Tensor], plan: Plan, cfg, what: str) -> Dict[str, torch.Tensor]:
    from phendiff_tpu_torch.models.convert import _expected

    _check_keys(sd, [k for _, t in plan for k in _keys(t)], f"{what} checkpoint")
    expected = _expected(cfg)
    out = {}
    for ours, t in plan:
        parts = [v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                 for v in (sd[k] for k in _keys(t))]
        v = parts[0] if len(parts) == 1 else torch.cat(parts)
        if v.shape != expected[ours]:
            raise ValueError(f"{t}: checkpoint shape {tuple(v.shape)} != "
                             f"{tuple(expected[ours])} of {ours}")
        out[ours] = v.float() if v.device.type == "meta" else v.float().contiguous()
    if set(out) != set(expected):
        raise ValueError(f"{what}: the plan misses module keys "
                         f"{sorted(set(expected) - set(out))[:8]}")
    return out


def _export(params: Mapping[str, torch.Tensor], plan: Plan, what: str) -> Dict[str, torch.Tensor]:
    _check_keys(params, [ours for ours, _ in plan], f"{what} parameters")
    out = {}
    for ours, t in plan:
        v = params[ours].detach()
        for k, part in zip(_keys(t), v.chunk(len(_keys(t)))):
            out[k] = part.contiguous()
    return out


def export_unet2d(params: Mapping[str, torch.Tensor], cfg: UNet2DConfig) -> Dict[str, torch.Tensor]:
    """A ``CondUNet2D(cfg)`` state dict -> a diffusers UNet2DModel state dict."""
    return _export(params, unet2d_plan(cfg), "pixel UNet")


def import_unet2d(sd: Mapping[str, torch.Tensor], cfg: UNet2DConfig) -> Dict[str, torch.Tensor]:
    """A diffusers UNet2DModel state dict -> a ``CondUNet2D(cfg)`` state dict
    (float32)."""
    return _import(sd, unet2d_plan(cfg), cfg, "pixel UNet")


def export_sd_unet(params: Mapping[str, torch.Tensor], cfg: SDUNetConfig) -> Dict[str, torch.Tensor]:
    """An ``SDUNet(cfg)`` state dict -> a diffusers UNet2DConditionModel
    state dict."""
    return _export(params, sd_unet_plan(cfg), "SD UNet")


def export_vae(params: Mapping[str, torch.Tensor],
               cfg: AutoencoderKLConfig) -> Dict[str, torch.Tensor]:
    """An ``AutoencoderKL(cfg)`` state dict -> a diffusers AutoencoderKL
    state dict."""
    return _export(params, vae_plan(cfg), "VAE")


def import_sd_unet(sd: Mapping[str, torch.Tensor], cfg: SDUNetConfig) -> Dict[str, torch.Tensor]:
    """A diffusers UNet2DConditionModel state dict -> an ``SDUNet(cfg)``
    state dict (float32)."""
    return _import(sd, sd_unet_plan(cfg), cfg, "SD UNet")


def import_vae(sd: Mapping[str, torch.Tensor], cfg: AutoencoderKLConfig) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict -> an ``AutoencoderKL(cfg)``
    state dict (float32)."""
    return _import(sd, vae_plan(cfg), cfg, "VAE")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file's tensors as float32 torch tensors on the CPU."""
    if path.endswith(".safetensors"):
        from phendiff_tpu_torch.pipelines.io import load_safetensors

        return {k: torch.from_numpy(np.asarray(v, dtype=np.float32))
                for k, v in load_safetensors(path).items()}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items()}
