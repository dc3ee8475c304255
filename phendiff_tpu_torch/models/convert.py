"""Weight carry-over between the JAX package's Flax checkpoints and the port.

The input is the flattened Flax tree with '/'-joined keys, exactly what
``phendiff_tpu/pipelines/io.py::flatten_params`` writes to
``params.safetensors`` (``params/down_1_attn_0/qkv/kernel``,
``params/down_0_res_0/norm1_scale``, ...).  The torch submodules carry the
Flax scope names, so the mapping is a rename plus transposes:

* ``params/`` is dropped and ``/`` becomes ``.``;
* a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW);
* a Dense ``kernel`` ([in, out]) becomes ``weight`` ([out, in]);
* the class ``embedding`` table becomes ``class_embedding.weight``;
* everything else (biases, norm scales and biases, the Fourier weight)
  keeps its name and layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.unet2d import CondUNet2D

_PREFIX = "params/"


def _expected(cfg: UNet2DConfig) -> Dict[str, torch.Size]:
    with torch.device("meta"):
        model = CondUNet2D(cfg)
    return {k: v.shape for k, v in model.state_dict().items()}


def from_flax_params(
    flat: Mapping[str, np.ndarray], cfg: UNet2DConfig
) -> Dict[str, torch.Tensor]:
    """Flattened Flax params -> a ``CondUNet2D(cfg)`` state dict (float32, CPU).

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
        if leaf == "weight" and scope == ["class_embedding"]:
            leaf = "embedding"
        elif leaf == "weight" and a.ndim in (2, 4):
            leaf = "kernel"
            a = a.permute(2, 3, 1, 0) if a.ndim == 4 else a.t()
        flat[_PREFIX + "/".join([*scope, leaf])] = np.ascontiguousarray(a.numpy())
    return flat
