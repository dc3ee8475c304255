"""Weight carry-over between the JAX package's Flax checkpoints and the port.

The input is the flattened Flax tree with '/'-joined keys, exactly what
``phendiff_tpu/pipelines/io.py::flatten_params`` writes to
``params.safetensors`` (``params/down_1_attn_0/qkv/kernel``,
``params/down_0_res_0/norm1_scale``, ...).  The torch submodules carry the
Flax scope names, so the mapping is a rename plus transposes:

* ``params/`` is dropped and ``/`` becomes ``.``;
* a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW);
* a Dense ``kernel`` ([in, out]) becomes ``weight`` ([out, in]);
* an ``embedding`` table becomes the ``weight`` of its ``nn.Embedding``
  (``class_embedding.weight`` in the pixel UNet, ``embedding.weight`` in
  the SD family's ``ClassEmbedding``);
* everything else (biases, GroupNorm and LayerNorm scales and biases, the
  Fourier weight) keeps its name and layout.

The same rules carry every tree the port reads: ``CondUNet2D`` (a
``UNet2DConfig``), ``SDUNet`` (an ``SDUNetConfig``), ``AutoencoderKL`` (an
``AutoencoderKLConfig``), and any module handed over as it is (the SD
family's ``ClassEmbedding``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.unet2d import CondUNet2D

_PREFIX = "params/"
# Modules whose ``weight`` is an embedding table (Flax leaf ``embedding``).
_EMBEDDING_SCOPES = ("class_embedding", "embedding")


def build_module(cfg) -> nn.Module:
    """The float32 module a config describes (on the current default device)."""
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
    from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig

    if isinstance(cfg, UNet2DConfig):
        return CondUNet2D(cfg)
    if isinstance(cfg, SDUNetConfig):
        return SDUNet(cfg)
    if isinstance(cfg, AutoencoderKLConfig):
        return AutoencoderKL(cfg)
    raise TypeError(f"no port module for a {type(cfg).__name__}")


def _expected(cfg) -> Dict[str, torch.Size]:
    """Key -> shape of the module ``cfg`` describes (or of ``cfg`` itself,
    a module)."""
    if isinstance(cfg, nn.Module):
        return {k: v.shape for k, v in cfg.state_dict().items()}
    with torch.device("meta"):
        model = build_module(cfg)
    return {k: v.shape for k, v in model.state_dict().items()}


def from_flax_params(flat: Mapping[str, np.ndarray], cfg) -> Dict[str, torch.Tensor]:
    """Flattened Flax params -> the state dict of ``build_module(cfg)``, or
    of ``cfg`` itself where it is a module (float32, CPU).

    Raises if the key set or a shape does not match the architecture.
    """
    out = {}
    for key, value in flat.items():
        if not key.startswith(_PREFIX):
            raise ValueError(f"not a Flax params key: {key}")
        *scope, leaf = key[len(_PREFIX):].split("/")
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if leaf == "kernel":
            leaf = "weight"
            if t.ndim == 4:  # HWIO -> OIHW
                t = t.permute(3, 2, 0, 1)
            elif t.ndim == 2:  # [in, out] -> [out, in]
                t = t.t()
            else:
                raise ValueError(f"unexpected kernel rank {t.ndim}: {key}")
        elif leaf == "embedding":
            leaf = "weight"
        out[".".join([*scope, leaf])] = t.contiguous()
    expected = _expected(cfg)
    if set(out) != set(expected):
        missing = sorted(set(expected) - set(out))
        extra = sorted(set(out) - set(expected))
        raise ValueError(f"checkpoint does not match config: missing {missing}, extra {extra}")
    for k, shape in expected.items():
        if out[k].shape != shape:
            raise ValueError(f"{k}: checkpoint shape {tuple(out[k].shape)} != {tuple(shape)}")
    return out


def to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``from_flax_params``: a state dict -> flattened Flax
    params (float32 numpy, '/'-joined keys under ``params/``)."""
    flat = {}
    for key, t in state_dict.items():
        *scope, leaf = key.split(".")
        a = t.detach().to("cpu", torch.float32)
        if leaf == "weight" and scope[-1:] and scope[-1] in _EMBEDDING_SCOPES:
            leaf = "embedding"
        elif leaf == "weight" and a.ndim in (2, 4):
            leaf = "kernel"
            a = a.permute(2, 3, 1, 0) if a.ndim == 4 else a.t()
        flat[_PREFIX + "/".join([*scope, leaf])] = np.ascontiguousarray(a.numpy())
    return flat
